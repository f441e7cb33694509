#!/usr/bin/env python3
"""Phase profile of the Tucker-2 workspace kernel on one card.

Run from the root of a checkout:

    python3 tools/torch_ws_profile.py [--out FILE] [--launches N] [--seed S]

It builds `csrc/tucker2_factors_ws.cu` with -DTUCKER2_WS_PROFILE, in which
block 0 of a launch (layer 0, cluster rank 0) sums the SM cycles of each
phase of the iteration, launches it at the 4 DeiT-tiny TK@2x buckets
(`chip_smoke.py`'s shapes and sweeps, inputs from --seed) and prints, per
bucket, each phase's share of block 0's cycles and its milliseconds per
launch (that share of the launch's time by CUDA events). Phases nest
under `total`: the Grams of X, then per orthogonal-iteration step Y = G Q
(staging included), S = Y^T Y with its reduction over the cluster and
the trace, Newton-Schulz (set-up; per step the three products, a barrier
before the pushes where Y and Z have one copy, the pushes and the step's
barrier) and Q = Y Z, then the HOOI products and their Grams. The
default build has none of it. Needs a CUDA card; exits 1 without one.
"""

import argparse
import ctypes
import faulthandler
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import build  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk  # noqa: E402

# slots of ws_prof in the CUDA source (WS_SPAN)
PHASES = ("total", "gram_x", "y_eq_gq", "s_partial_reduce_trace", "ns_init",
          "ns_products", "ns_barrier_before_push", "ns_push_and_barrier",
          "q_eq_yz", "hooi_products", "hooi_gram")
DEFINE = "TUCKER2_WS_PROFILE=1"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=Path("build/ws_profile.jsonl"))
    ap.add_argument("--launches", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ws_profile: CUDA is not available", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(600, exit=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    out = args.out.open("w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        out.write(line + "\n")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], stdin=subprocess.DEVNULL,
        capture_output=True, text=True, timeout=60).stdout.strip()
    info = build.build("tucker2_factors_ws", defines=(DEFINE,))
    lib = tk.bind_ws(build.load("tucker2_factors_ws", defines=(DEFINE,)))
    lib.tucker2_factors_ws_profile.argtypes = [ctypes.c_void_p]
    lib.tucker2_factors_ws_profile.restype = ctypes.c_int
    emit({"card": smi, "ptxas": [ln for ln in info["compiler_output"].splitlines()
                                 if "registers" in ln or "spill" in ln]})
    prof = np.zeros(16, np.uint64)

    def read():
        err = lib.tucker2_factors_ws_profile(prof.ctypes.data)
        if err != 0:
            raise RuntimeError(f"profile read failed: CUDA error {err}")
        return prof.copy()

    rng = np.random.RandomState(args.seed)
    for shape, r0, r1 in cs.main_path_buckets(cs.deit_program("tk")):
        x = cs.tucker_input(rng, shape)

        def launch():
            tk.launch_ws(lib, x, r0, r1, sweeps=cs.SWEEPS)

        launch()
        torch.cuda.synchronize()
        read()  # drop the warm-up launch
        ms = cs.cuda_ms(launch, args.launches, warmup=0)
        cycles = read()[:len(PHASES)] / args.launches
        row = {"shape_LKOI": list(shape), "ranks": [r0, r1],
               "cluster": lib.tucker2_factors_ws_cluster(*shape[1:], r0, r1),
               "ms_per_launch": ms,
               "block0_cycles_per_ms": float(cycles[0]) / ms}
        for name, cyc in zip(PHASES, cycles):
            row[f"{name}_share"] = float(cyc / cycles[0])
            row[f"{name}_ms"] = float(cyc / cycles[0]) * ms
        emit(row)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
