#!/usr/bin/env python3
"""Where a BERT-base training step of the NLP path spends its time, on one
card, eager and replayed from a CUDA graph.

    python3 tools/torch_nlp_profile.py [--steps N] [--seed S] [--out FILE]

For the dense BERT-base QA model and the same model under the NLP CLI's
plan (TT@2x linears, SVD@4.5x word embedding), at sequence 128 and batch
32 in float32 with TF32 off (as `nlp/squad.py` trains it: BertAdam,
dropout from a generator on the card; ids made on the card from --seed,
13 real tokens a row as on synthetic SST-2), it times, before any trace:

* the eager step split into forward, backward and optimizer by host
  clock around synchronised regions (--steps steps after 3 warm-up steps);
* the step as `nlp/steps.py::TrainLoop` runs it, eagerly and captured
  (the card replays one CUDA graph a step): ms a step over --steps steps
  after a first pass that primes and captures it, and the capture's
  seconds;

then traces one more pass of --steps steps of each route with
`torch.profiler`: the device's
busy ms a step (the union of its ops' intervals, `utils/profiling.py`),
its ops a step and the longest ops. Prints one JSON line per model, with
the card's name and power limit, and writes them to --out (default
build/nlp_profile.jsonl).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from dnn_compression_tensor_admm_tpu_torch.nlp import bert  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.nlp.squad import span_loss  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.nlp.steps import (  # noqa: E402
    DeviceBatches, StepClock, TrainLoop)
from dnn_compression_tensor_admm_tpu_torch.nlp.task_distill import (  # noqa: E402
    make_bert_adam)
from dnn_compression_tensor_admm_tpu_torch.ops.precision import full_f32  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.utils import profiling  # noqa: E402

PLANS = {"dense": None,
         "tt2_svd4.5": bert.BertCompressionPlan("tt", 2.0, 2, "svd", 4.5)}
BATCH, SEQ, VOCAB = 32, 128, 215


def setup(plan, steps, seed, dev):
    """(model, BertAdam, dropout generator, the set on the card: `steps`
    batches of synthetic ids)."""
    cfg = bert.BertConfig(vocab_size=VOCAB)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = BATCH * steps
    ids = torch.randint(0, VOCAB, (n, SEQ), device=dev, generator=gen)
    mask = torch.ones_like(ids)
    mask[:, 13:] = 0
    pos = torch.randint(0, 13, (n,), device=dev, generator=gen)
    data = {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": torch.zeros_like(ids),
            "start_positions": pos, "end_positions": pos}
    model = bert.BertForQuestionAnswering(
        cfg, plan, generator=torch.Generator().manual_seed(seed)).to(dev)
    model.train()
    return model, make_bert_adam(model, 5e-4, 1000, 0.1), gen, data


def loss_of(model, gen):
    def loss_fn(b):
        out = model(b["input_ids"], b["attention_mask"], b["token_type_ids"],
                    generator=gen)
        return span_loss(out["start_logits"], out["end_logits"],
                         b["start_positions"], b["end_positions"])
    return loss_fn


def eager_split(plan, steps, seed, dev):
    """Forward, backward and optimizer ms of the eager step, each region
    synchronised."""
    model, opt, gen, data = setup(plan, 1, seed, dev)
    loss_fn = loss_of(model, gen)

    def step(split=None):
        t0 = time.perf_counter()
        loss = loss_fn(data)
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
    return {"parameters": len(list(model.parameters())),
            "forward_ms": float(ms[:, 0].mean()),
            "backward_ms": float(ms[:, 1].mean()),
            "optimizer_ms": float(ms[:, 2].mean()),
            "step_ms": float(ms.sum(1).mean())}


def route_loop(plan, steps, seed, dev, captured: bool):
    """`TrainLoop` over `steps` batches, eager or captured, after a first
    pass (which primes and captures the captured one)."""
    model, opt, gen, data = setup(plan, steps, seed, dev)
    loop = TrainLoop(loss_of(model, gen), opt,
                     DeviceBatches(data, BATCH), (gen,),
                     None if captured else "eager")
    rng = np.random.RandomState(seed)
    t0 = time.perf_counter()
    loop.epoch(rng, StepClock(dev))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    clock = StepClock(dev)
    loss = loop.epoch(rng, clock)
    return loop, rng, {"ms_per_step": clock.ms_per_step(),
                       "first_pass_s": first_s,
                       "capture_s": sum(s.capture_s
                                        for s in loop.steps.values()),
                       "loss": loss}


def traced(loop, rng, dev):
    """Device busy ms a step, ops a step and the longest ops over one
    pass of `loop` under `torch.profiler`."""
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            loop.epoch(rng, StepClock(dev))
        s = profiling.trace_summary(os.path.join(d, "trace.json"), top=8)
    n = loop.batches.steps
    return {"device_busy_ms_per_step": s["device_busy_ms"] / n,
            "device_ops_per_step": s["device_events"] / n,
            "idle_share_of_traced_span": s["idle_share"],
            "top_ops_ms_per_step": [[o["name"][:80], o["ms"] / n]
                                    for o in s["top_ops"]]}


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
    rows, loops = {}, {}
    with full_f32():
        # every untraced time first: a trace slows its process's later steps
        for name, plan in PLANS.items():
            row = {"model": name, "steps": args.steps,
                   "eager_split": eager_split(plan, args.steps, args.seed,
                                              dev)}
            for route in ("eager", "captured"):
                loop, rng, got = route_loop(plan, args.steps, args.seed, dev,
                                            route == "captured")
                row[route] = got
                loops[name, route] = (loop, rng)
            rows[name] = row
        for (name, route), (loop, rng) in loops.items():
            rows[name][route].update(traced(loop, rng, dev))
    with open(args.out, "w") as f:
        for row in rows.values():
            line = json.dumps({**row, "card": smi, "torch": torch.__version__})
            print(line, flush=True)
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
