#!/usr/bin/env python3
"""What a `torch.profiler` session leaves behind in its process, on one card.

    python3 tools/torch_profiler_residue.py [--steps N] [--rounds R]
        [--traced-steps T] [--variants NAME ...] [--seed S] [--out FILE]

For each variant, in a process of its own, it times three workloads
untraced --rounds times, traces --traced-steps training steps (20, as
`--profile-dir` traces the recipe's first epoch), and times the three
--rounds times again, counting the live Python objects before and after:

* the dense DeiT-tiny X-step at batch 128 (bf16 autocast, AdamW, random
  images and labels made on the card from --seed), ms a step;
* 4,000 launches of an in-place add on 1,024 floats, host us a launch;
* a bf16 [4096, 4096] matmul, device ms (CUDA events).

Variants: `none` (no profiler: the drift of an untraced process),
`trace` (the port's `utils/profiling.trace`, as `--profile-dir` runs
it), `cpu_only` (`torch.profiler` with CPU activity alone), and `trace`
with the environment variable TEARDOWN_CUPTI set to 0 or 1 before the
process starts. Prints one JSON line per variant, with
the card's name and power limit, and writes them to --out (default
build/profiler_residue.jsonl).
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

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = {"none": {}, "trace": {}, "cpu_only": {},
            "trace_teardown0": {"TEARDOWN_CUPTI": "0"},
            "trace_teardown1": {"TEARDOWN_CUPTI": "1"}}


def measure(step, launches, matmul, steps: int) -> dict:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = 1000 * (time.perf_counter() - t0) / steps
    t0 = time.perf_counter()
    launches()
    launch_us = 1e6 * (time.perf_counter() - t0) / 4000
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(20):
        matmul()
    end.record()
    end.synchronize()
    return {"step_ms": step_ms, "launch_us": launch_us,
            "matmul_ms": start.elapsed_time(end) / 20}


def child(variant: str, steps: int, rounds: int, traced: int,
          seed: int) -> dict:
    import gc
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F
    from dnn_compression_tensor_admm_tpu_torch.models import create_model
    from dnn_compression_tensor_admm_tpu_torch.train.optim import (
        make_train_optimizer)
    from dnn_compression_tensor_admm_tpu_torch.utils.profiling import (
        trace, trace_summary)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = create_model("deit_tiny_patch16_224", num_classes=1000,
                         generator=torch.Generator().manual_seed(seed))
    model.to(dev).train()
    opt, _ = make_train_optimizer(model.named_parameters(), 5e-4, opt="adamw")
    x = torch.randn(128, 3, 224, 224, device=dev, generator=gen)
    y = torch.randint(0, 1000, (128,), device=dev, generator=gen)

    def step():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            logits = model(x, generator=gen)
        loss = F.cross_entropy(logits.float(), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    small = torch.zeros(1024, device=dev)

    def launches():
        for _ in range(4000):
            small.add_(1.0)

    a = torch.randn(4096, 4096, device=dev, generator=gen,
                    dtype=torch.bfloat16)

    def matmul():
        a @ a

    for _ in range(5):
        step()
    for _ in range(5):
        matmul()
    before = [measure(step, launches, matmul, steps) for _ in range(rounds)]
    objects_before = len(gc.get_objects())
    device_events = None
    with tempfile.TemporaryDirectory() as logdir:
        if variant == "none":
            pass
        elif variant == "cpu_only":
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                for _ in range(traced):
                    step()
        else:
            with trace(logdir):
                for _ in range(traced):
                    step()
            device_events = trace_summary(
                os.path.join(logdir, "trace.json"))["device_events"]
    objects_after = len(gc.get_objects())
    after = [measure(step, launches, matmul, steps) for _ in range(rounds)]

    def mean(rows, key):
        return sum(r[key] for r in rows) / len(rows)
    return {"variant": variant, "env": VARIANTS[variant],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "traced_steps": traced, "traced_device_events": device_events,
            "python_objects": [objects_before, objects_after],
            "step_ms_before": [r["step_ms"] for r in before],
            "step_ms_after": [r["step_ms"] for r in after],
            "launch_us_before": [r["launch_us"] for r in before],
            "launch_us_after": [r["launch_us"] for r in after],
            "matmul_ms_before": [r["matmul_ms"] for r in before],
            "matmul_ms_after": [r["matmul_ms"] for r in after],
            "step_ms_added": mean(after, "step_ms") - mean(before, "step_ms"),
            "launch_us_added": (mean(after, "launch_us")
                                - mean(before, "launch_us"))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--traced-steps", type=int, default=20)
    ap.add_argument("--variants", nargs="+", choices=sorted(VARIANTS),
                    default=list(VARIANTS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "build"
                                         / "profiler_residue.jsonl"))
    ap.add_argument("--child", choices=sorted(VARIANTS),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.steps, args.rounds,
                               args.traced_steps, args.seed)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        stdin=subprocess.DEVNULL).stdout.strip()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    failed = 0
    with open(args.out, "w") as f:
        for variant in args.variants:
            proc = subprocess.run(
                [sys.executable, __file__, "--child", variant, "--steps",
                 str(args.steps), "--rounds", str(args.rounds),
                 "--traced-steps", str(args.traced_steps), "--seed",
                 str(args.seed)],
                env={**os.environ, **VARIANTS[variant]}, capture_output=True,
                text=True, stdin=subprocess.DEVNULL, timeout=600)
            if proc.returncode != 0:
                failed += 1
                print(f"{variant} failed ({proc.returncode}):\n"
                      f"{proc.stderr[-3000:]}", file=sys.stderr)
                continue
            row = {**json.loads(proc.stdout.strip().splitlines()[-1]),
                   "card": card}
            print(json.dumps(row), flush=True)
            f.write(json.dumps(row) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
