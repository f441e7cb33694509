#!/usr/bin/env python3
"""`chip_smoke.py`'s captured-step and fused-epochs phase alone, on one
card.

    python3 tools/torch_fused_check.py [--seed S] [--paths tk deit]
        [--extra stiefel augment]
        [--phases fused fused_methods guard multi_rank nlp nlp_captured
                  bench]

Builds the four kernel libraries (four nvcc processes at once), then runs
`chip_smoke.phase_fused` on the chosen main paths (default both: ResNet32
TK@3x and DeiT-tiny TT@2x with Mixup/CutMix) and the recipe's streamed
step: the captured per-epoch route and the fused chunk against the eager
loop in float32, the planted faults, the sync debug mode at every replay,
the launches a Z-step, and every route timed in bf16. `--extra` first
holds runs that no path of the phase reaches to the eager loop the same
way, 2 epochs x 3 steps in float32 from the same weights and seed, on the
captured per-epoch route and fused: `stiefel`, a fine-tune of
`stftkc_resnet32` (Riemannian SGD and its QR retraction), and `augment`,
DeiT-tiny TT@2x ADMM with the recipe fine-tune's RandAugment, erasing, 3
repeated views and the shuffled sampling. Prints the card's `nvidia-smi`
name and power limit, then a JSON line a check; exits non-zero where one
fails. `--phases` (default `fused`) also runs, in that order,
`chip_smoke.phase_guard` (the Z/U step's finite guard on every route),
`phase_multi_rank` (2 ranks on the card) and `phase_fused_methods`
(fused chunks by the `subspace` and `ns` methods), `phase_nlp` (the NLP
commands at BERT-base width, every step captured) and
`phase_nlp_captured` (each NLP command captured against its eager
reference loop, with its planted faults) and `phase_bench` (the ported
`bench/` harnesses at cut counts, 2 ranks on the card, after the
synthetic sets the earlier phases of `chip_smoke.py` make); the kernel
libraries are built only for the phases that launch them. Without CUDA
it exits 1.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.data import datasets  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import build  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.train import (  # noqa: E402
    TrainConfig, train_model)


def extra_config(name: str, seed: int, per_dispatch: int) -> TrainConfig:
    if name == "stiefel":
        return TrainConfig(model="stftkc_resnet32",
                           dataset="synthetic-cifar10", batch_size=256,
                           epochs=2, steps_per_epoch=3, opt="momentum",
                           lr=0.01, smoothing=0.1, eval_every=3,
                           epochs_per_dispatch=per_dispatch,
                           compute_dtype=None, seed=seed, device="cuda",
                           print_fn=cs.log)
    return dataclasses.replace(
        cs.fused_config("deit", seed, 2, 3, per_dispatch, None),
        randaug_magnitude=9, randaug_std=0.5, erase_prob=0.25,
        repeated_aug=3, sampling="shuffle")


def extra(name: str, seed: int, card: str) -> dict:
    """One `--extra` run per epoch (captured) and fused against the eager
    loop, float32."""
    t0 = time.perf_counter()
    runs = {}
    with cs.deterministic_f32():
        for route, per_dispatch in (("eager", 1), ("per_epoch", 1),
                                    ("fused", 8)):
            model, hist = train_model(extra_config(name, seed, per_dispatch),
                                      eager=route == "eager")
            runs[route] = ([h["train_loss"] for h in hist],
                           {n: p.detach().clone()
                            for n, p in model.named_parameters()})
    ref_losses, ref = runs.pop("eager")
    out = {route: {"loss": max(abs(a - b) / abs(b)
                               for a, b in zip(losses, ref_losses)),
                   "params": cs._rel_dist(got, ref)}
           for route, (losses, got) in runs.items()}
    failed = any(r[k] > cs.FUSED_TOL[k] for r in out.values() for k in r)
    return {"phase": f"fused_{name}", "card": card, "vs_eager": out,
            "tolerance": {k: cs.FUSED_TOL[k] for k in ("loss", "params")},
            "failed": failed, "wall_s": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paths", nargs="*", default=list(cs.FUSED["paths"]),
                    choices=list(cs.FUSED["paths"]))
    ap.add_argument("--extra", nargs="*", default=[],
                    choices=["stiefel", "augment"])
    ap.add_argument("--phases", nargs="*", default=["fused"],
                    choices=["fused", "fused_methods", "guard",
                             "multi_rank", "nlp", "nlp_captured", "bench"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fused_check: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    print(card, flush=True)
    if args.extra or set(args.phases) - {"nlp", "nlp_captured"}:
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            list(pool.map(build.build, ("tucker2_factors",
                                        "tucker2_factors_ws", "subspace",
                                        "subspace_ws")))
    cs.FUSED["paths"] = tuple(args.paths)
    with cs.shared_sets(), tempfile.TemporaryDirectory() as workdir:
        rows = [extra(name, args.seed, card) for name in args.extra]
        for row in rows:
            cs.emit(row)
        if "guard" in args.phases:
            cs.phase_guard(args.seed, card)
        if "multi_rank" in args.phases:
            cs.phase_multi_rank(args.seed, card, workdir)
        if "fused" in args.phases:
            cs.phase_fused(args.seed, card, workdir)
        if "fused_methods" in args.phases:
            cs.phase_fused_methods(args.seed, card)
        if "nlp" in args.phases:
            cs.phase_nlp(args.seed, card, workdir)
        if "nlp_captured" in args.phases:
            cs.phase_nlp_captured(args.seed, card, workdir)
        if "bench" in args.phases:
            # the sets `chip_smoke.py`'s earlier phases have made by then,
            # so that the phase's wall time reads as it does there
            for name, size in (("synthetic-imagenet", 512),
                               ("synthetic-cifar10", None)):
                datasets.load_dataset(name, True, size)
            datasets.load_dataset("synthetic-cifar10", False, None)
            cs.phase_bench(args.seed, card, workdir)
    return 1 if any(row["failed"] for row in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
