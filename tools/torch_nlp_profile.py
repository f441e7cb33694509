#!/usr/bin/env python3
"""Where a BERT-base training step of the NLP path spends its time, on one
card.

    python3 tools/torch_nlp_profile.py [--steps N] [--seed S] [--out FILE]

For the dense BERT-base QA model and the same model under the NLP CLI's
plan (TT@2x linears, SVD@4.5x word embedding), at sequence 128 and batch
32 in float32 with TF32 off (as `nlp/squad.py` trains it: BertAdam,
dropout from a generator on the card; ids made on the card from --seed,
13 real tokens a row as on synthetic SST-2), it times --steps steps after
3 warm-up steps, split into forward, backward and optimizer by host clock
around synchronised regions, then traces 3 steps with `torch.profiler`:
the device's busy ms a step (the sum of its ops' self time), its ops a
step and the longest ops. Prints one JSON line per model, with the card's
name and power limit, and writes them to --out (default
build/nlp_profile.jsonl).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dnn_compression_tensor_admm_tpu_torch.nlp import bert  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.nlp.squad import span_loss  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.nlp.task_distill import (  # noqa: E402
    make_bert_adam)
from dnn_compression_tensor_admm_tpu_torch.ops.precision import full_f32  # noqa: E402

PLANS = {"dense": None,
         "tt2_svd4.5": bert.BertCompressionPlan("tt", 2.0, 2, "svd", 4.5)}


def profile_model(name, plan, steps, seed, dev):
    cfg = bert.BertConfig(vocab_size=215)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(0, 215, (32, 128), device=dev, generator=gen)
    mask = torch.ones_like(ids)
    mask[:, 13:] = 0
    types = torch.zeros_like(ids)
    pos = torch.randint(0, 13, (32,), device=dev, generator=gen)
    model = bert.BertForQuestionAnswering(
        cfg, plan, generator=torch.Generator().manual_seed(seed)).to(dev)
    model.train()
    opt = make_bert_adam(model, 5e-4, 100, 0.1)

    def step(split=None):
        t0 = time.perf_counter()
        out = model(ids, mask, types, generator=gen)
        loss = span_loss(out["start_logits"], out["end_logits"], pos, pos)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        if split is not None:
            split.append((t1 - t0, t2 - t1, time.perf_counter() - t2))

    for _ in range(3):
        step()
    split = []
    for _ in range(steps):
        step(split)
    ms = np.asarray(split) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
    # the card's own events (kernels, copies, sets); an aten op's device
    # time is its kernels' again, and an annotation's (the optimizer's
    # span) the sum of what it covers
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0
               and not e.key.startswith("Optimizer.")]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return {"model": name, "parameters": len(list(model.parameters())),
            "steps": steps,
            "forward_ms": float(ms[:, 0].mean()),
            "backward_ms": float(ms[:, 1].mean()),
            "optimizer_ms": float(ms[:, 2].mean()),
            "step_ms": float(ms.sum(1).mean()),
            "device_busy_ms_per_step": sum(
                e.self_device_time_total for e in kernels) / 3e3,
            "device_ops_per_step": sum(e.count for e in kernels) / 3,
            "top_ops_ms_per_step": [[e.key[:80], e.self_device_time_total / 3e3]
                                    for e in top]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build" / "nlp_profile.jsonl"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_nlp_profile: this measures the card; CUDA is absent",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f, full_f32():
        for name, plan in PLANS.items():
            row = {**profile_model(name, plan, args.steps, args.seed, dev),
                   "card": smi, "torch": torch.__version__}
            line = json.dumps(row)
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
