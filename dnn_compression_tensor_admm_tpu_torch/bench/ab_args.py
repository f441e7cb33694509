"""Interleaved A/B of the dataset's sampling modes on the headline config
(the JAX package's `bench/ab_args.py`).

Variants of the same ResNet32 TK@3x program (`train_model` on the
device-resident set):
    args     a slice of a shuffled copy of the set a step
             (`sampling="shuffle"`: the copy drawn each epoch)
    perm     a slice of the epoch's permutation a step, then a gather
             (`sampling="perm"`: no shuffled copy)
    closure  no counterpart: the JAX round-2 design inlined the set into
             the program as a constant; the port never does, and a CUDA
             graph reads the set's tensor by address either way. Asking
             for it raises.

Rounds interleave the variants in a rotating order, so a slow drift of
the machine hits every variant alike; per-round paired deltas cancel
it; `--slope` also runs each at half the steps, and the two-point fit
splits the per-step cost from the per-epoch overhead (the shuffled copy
is made once an epoch). Each run's epochs go through the per-epoch route
(`epochs_per_dispatch=1`), the X-step replayed from its CUDA graph on
the card.

Run: python -m dnn_compression_tensor_admm_tpu_torch.bench.ab_args \\
        --rounds 8 --epochs 12 --warmup 2 --slope [--device cuda] \\
        [--out build/ab_args.jsonl]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Optional

from ..train import TrainConfig, train_model
from ..utils.card import card_info
from ..utils.device import resolve_device

VARIANTS = {
    "args": dict(sampling="shuffle"),
    "perm": dict(sampling="perm"),
}
CLOSURE = ("the 'closure' variant has no counterpart in the port: it never "
           "inlines the set into a program, and a CUDA graph reads the set's "
           "device tensor by address either way")


def variant_config(variant: str) -> dict:
    """The `TrainConfig` fields of `variant`; raises for 'closure' and for
    a name that is no variant."""
    if variant == "closure":
        raise ValueError(CLOSURE)
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from "
                         f"{sorted(VARIANTS)}")
    return VARIANTS[variant]


def run_once(variant: str, epochs: int, steps: int, *,
             batch_size: int = 256, synthetic_size: Optional[int] = None,
             device: str = "cuda") -> list:
    """One `train_model` run of the headline config; returns per-epoch
    wall times (epoch 1 includes the capture and is reported for
    completeness)."""
    cfg = TrainConfig(
        model="resnet32", dataset="synthetic-cifar10", batch_size=batch_size,
        steps_per_epoch=steps, epochs=epochs, lr=0.1, smoothing=0.1,
        admm=True, fmt="tk", ratio="3", admm_method="kernel",
        admm_hooi_iters=6, compute_dtype="bfloat16", eval_every=10 ** 9,
        # epoch fusion off: the harness isolates the per-epoch cost of
        # delivering the set, which a fused chunk would hide
        epochs_per_dispatch=1, synthetic_size=synthetic_size, device=device,
        print_fn=lambda *a: None, **variant_config(variant))
    _, hist = train_model(cfg)
    return [h["epoch_time_s"] for h in hist]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=2,
                    help="steady-state epochs exclude the first N")
    ap.add_argument("--steps", type=int, default=196)
    ap.add_argument("--slope", action="store_true",
                    help="also run at steps/2 for a two-point slope fit")
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--out", default="build/ab_args.jsonl")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for v in args.variants:
        variant_config(v)
    card = card_info(resolve_device(args.device))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    step_grid = [args.steps] + ([args.steps // 2] if args.slope else [])
    rows = []
    for rnd in range(args.rounds):
        order = args.variants[rnd % len(args.variants):] + \
            args.variants[:rnd % len(args.variants)]
        for variant in order:
            for steps in step_grid:
                t0 = time.time()
                times = run_once(variant, args.epochs, steps,
                                 device=args.device)
                row = {"round": rnd, "variant": variant, "steps": steps,
                       "epoch_times": [round(t, 4) for t in times],
                       "wall_s": round(time.time() - t0, 1),
                       "device": args.device, "card": card}
                rows.append(row)
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
                steady = times[args.warmup:]
                print(f"[{rnd}] {variant:8s} steps={steps:3d} "
                      f"median {statistics.median(steady):.4f}s "
                      f"({steps/statistics.median(steady):.1f} it/s)",
                      flush=True)

    summarize(rows, args)
    return rows


def summarize(rows, args):
    by = {}
    for r in rows:
        by.setdefault((r["variant"], r["steps"]), []).extend(
            r["epoch_times"][args.warmup:])
    print("\n== steady-state epoch time (s) ==")
    stats = {}
    for (v, s), ts in sorted(by.items()):
        med = statistics.median(ts)
        stats[(v, s)] = med
        print(f"{v:8s} steps={s:3d} n={len(ts):3d} median={med:.4f} "
              f"mean={statistics.mean(ts):.4f} "
              f"sd={statistics.stdev(ts):.4f} it/s={s/med:.1f}")
    # paired per-round deltas at full scan length vs 'args'
    print("\n== per-round paired deltas vs args (full steps, median ms) ==")
    per_round = {}
    for r in rows:
        if r["steps"] != args.steps:
            continue
        per_round.setdefault(r["round"], {})[r["variant"]] = \
            statistics.median(r["epoch_times"][args.warmup:])
    for v in args.variants:
        if v == "args":
            continue
        ds = [1000 * (per_round[k][v] - per_round[k]["args"])
              for k in per_round if v in per_round[k] and "args" in per_round[k]]
        if ds:
            m = statistics.mean(ds)
            sd = statistics.stdev(ds) if len(ds) > 1 else 0.0
            print(f"{v:8s} - args: {m:+.1f} ms/epoch (sd {sd:.1f}, n={len(ds)})")
    if args.slope:
        print("\n== two-point decomposition: per-step cost / per-epoch overhead ==")
        for v in args.variants:
            full, half = stats.get((v, args.steps)), stats.get((v, args.steps // 2))
            if full and half:
                slope = (full - half) / (args.steps - args.steps // 2)
                intercept = full - slope * args.steps
                print(f"{v:8s} per-step {1000*slope:.3f} ms "
                      f"per-epoch-overhead {1000*intercept:.1f} ms "
                      f"(asymptotic {1/slope:.1f} it/s)")


if __name__ == "__main__":
    main()
