#!/usr/bin/env python3
"""`chip_smoke.py`'s VGG16 TK@2x and DenseNet121 TK@2x pieces alone, on one
card.

    python3 tools/torch_zoo_paths_check.py [--seed S]
        [--phases decompose densenet121_tk vgg16_tk multi_rank]

Builds the four kernel libraries (four nvcc processes at once), then, in
the order given (default all four):

* `decompose`: `decompose_params` of a seeded dense VGG16 and DenseNet121
  on the card by their TK@2x plans (exact-SVD HOSVD and 10 HOOI sweeps a
  layer), timed whole and, for VGG16, `pre_logits.fc1` [4096, 512, 7, 7]
  alone, with the compressed model's ratio;
* `densenet121_tk`, `vgg16_tk`: `chip_smoke.phase_main` of that path
  (ADMM with the captured X-step, decompose, fine-tune, eval, launches,
  ratio and counts asserted);
* `multi_rank`: `chip_smoke.phase_multi_rank` (ResNet32 TK@3x and the
  recomputed DenseNet121 over 2 ranks).

Prints the card's `nvidia-smi` name and power limit, then one JSON line a
piece; exits non-zero where one fails. Without CUDA it exits 1.
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
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.models import (  # noqa: E402
    create_model, decompose_params)
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import build  # noqa: E402

PHASES = ("decompose", "densenet121_tk", "vgg16_tk", "multi_rank")
FC1 = "pre_logits.fc1.weight"


def _timed_decompose(sd, plan) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = decompose_params(sd, plan)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_decompose(seed: int, card: str) -> None:
    """Decompose of a seeded VGG16 and DenseNet121 by their TK@2x plans."""
    for key in ("vgg16_tk", "densenet121_tk"):
        path = cs.PATHS[key]
        t_start = time.perf_counter()
        dense = create_model(path["dense"],
                             generator=torch.Generator().manual_seed(seed))
        sd = dense.cuda().state_dict()
        plan = get_rank_plan(path["model"], "tk", path["ratio_arg"])
        out, decompose_s = _timed_decompose(sd, plan)
        compressed = create_model(path["model"], ratio=path["ratio_arg"])
        compressed.load_state_dict(out)
        row = {"phase": "decompose", "card": card, "model": path["name"],
               "layers": len(plan.names()), "decompose_s": decompose_s,
               "ratio": cs.compression_ratio(dense, compressed)}
        if FC1 in plan:
            one = dataclasses.replace(plan, layers={FC1: plan.spec(FC1)})
            _, row["fc1_decompose_s"] = _timed_decompose(
                {FC1: sd[FC1]}, one)
        row["wall_s"] = time.perf_counter() - t_start
        cs.emit(row)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", nargs="*", default=list(PHASES),
                    choices=PHASES)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_zoo_paths_check: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    print(card, flush=True)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        list(pool.map(build.build, ("tucker2_factors", "tucker2_factors_ws",
                                    "subspace", "subspace_ws")))
    with cs.shared_sets(), tempfile.TemporaryDirectory() as workdir:
        for phase in args.phases:
            if phase == "decompose":
                phase_decompose(args.seed, card)
            elif phase == "multi_rank":
                cs.phase_multi_rank(args.seed, card, workdir)
            else:
                model = cs.PATHS[phase]["dense"]
                n = len(cs.main_path_buckets(cs._program("tk", model, "2")))
                cs.phase_main(args.seed, card, phase, n, workdir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
