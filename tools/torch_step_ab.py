#!/usr/bin/env python3
"""The per-epoch route's step time of another checkout against this one,
in turns on one card.

    python3 tools/torch_step_ab.py BASELINE_DIR [--seed S]

BASELINE_DIR holds another checkout (e.g. `git archive <rev> | tar -x -C
.scratch/parent`, its `results/` removed). Each turn is a process of its
own, run from that checkout's root, in the order baseline, this, this,
baseline: it builds the four kernel libraries there, then runs ResNet32
TK@3x and DeiT-tiny TT@2x ADMM at `chip_smoke.PATHS`' settings (bf16, 3
epochs x 20 steps, `--epochs-per-dispatch 1` where the checkout has it)
and prints one JSON line: each epoch's ms a step (its Z/U step and 20
X-steps) and its X-steps' ms a step. The card's `nvidia-smi` name and
power limit come first. Without CUDA it exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def turn(root: str, seed: int) -> dict:
    """One checkout's step times (run inside `root`'s own process)."""
    sys.path.insert(0, root)
    import concurrent.futures

    import chip_smoke as cs
    from dnn_compression_tensor_admm_tpu_torch.ops.cuda import build
    from dnn_compression_tensor_admm_tpu_torch.train import (TrainConfig,
                                                             train_model)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        list(pool.map(build.build, ("tucker2_factors", "tucker2_factors_ws",
                                    "subspace", "subspace_ws")))
    out, steps = {"root": root}, 20
    with cs.shared_sets():
        for key in ("tk", "deit"):
            path = cs.PATHS[key]
            kw = dict(model=path["dense"], dataset=path["dataset"],
                      synthetic_size=path["synthetic_size"],
                      batch_size=path["batch_size"], epochs=3,
                      steps_per_epoch=steps, opt=path["opt"], lr=path["lr"],
                      smoothing=0.1, admm=True, rho=1e-3, fmt=path["fmt"],
                      ratio=path["ratio_arg"], admm_method="kernel",
                      admm_hooi_iters=6, compute_dtype="bfloat16", seed=seed,
                      device="cuda", print_fn=lambda *a: None)
            if "epochs_per_dispatch" in TrainConfig.__dataclass_fields__:
                kw["epochs_per_dispatch"] = 1
            hist = train_model(TrainConfig(**kw))[1]
            out[key] = {
                "epoch_ms_per_step": [1000 * h["epoch_time_s"] / steps
                                      for h in hist],
                "x_ms_per_step": [1000 * h["x_step_s"] / steps
                                  for h in hist]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("baseline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn, args.seed)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_step_ab: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=60,
        check=True).stdout.strip(), flush=True)
    base = os.path.abspath(args.baseline)
    for root in (base, str(ROOT), str(ROOT), base):
        subprocess.run([sys.executable, os.path.abspath(__file__), base,
                        "--seed", str(args.seed), "--turn", root],
                       cwd=root, stdin=subprocess.DEVNULL, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
