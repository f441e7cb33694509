#!/usr/bin/env python3
"""Phase profile of a workspace kernel (Tucker-2 or subspace) on one card.

Run from the root of a checkout:

    python3 tools/torch_ws_profile.py [--kernel tucker2|subspace]
        [--out FILE] [--launches N] [--seed S]

It builds `csrc/tucker2_factors_ws.cu` with -DTUCKER2_WS_PROFILE (or, with
--kernel subspace, `csrc/subspace_ws.cu` with -DSUBSPACE_WS_PROFILE), in
which block 0 of a launch (layer 0, cluster rank 0) sums the SM cycles of
each phase of the iteration, launches it at the 4 DeiT-tiny TK@2x buckets
(or the 13 workspace launches of a DeiT-tiny TT@2x Z-step; `chip_smoke.py`'s
shapes, sweeps and iterations, inputs from --seed) and prints, per shape,
each phase's share of block 0's cycles and its milliseconds per launch
(that share of the launch's time by CUDA events). Phases nest under
`total`: the Grams of X (or t's Gram), then per orthogonal-iteration step
Y = G Q (staging included), S = Y^T Y with its reduction over the cluster
and the trace, Newton-Schulz (set-up; per step the three products, a
barrier before the pushes where Y and Z have one copy, the pushes and the
step's barrier) and Q = Y Z; then the HOOI products and their Grams, or
the tall lift (Y = t V, S, its Newton-Schulz, whose phases count under
theirs too, and q = Y Z under `q_eq_yz`). The default build has none of
it. Needs a CUDA card; exits 1 without one.
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
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import subspace_kernel as sk  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk  # noqa: E402

# slots of ws_prof in the CUDA sources (WS_SPAN; cluster_iter.cuh's 1-8)
ITER_PHASES = ("total", "gram_x", "y_eq_gq", "s_partial_reduce_trace",
               "ns_init", "ns_products", "ns_barrier_before_push",
               "ns_push_and_barrier", "q_eq_yz")
PHASES = {"tucker2": ITER_PHASES + ("hooi_products", "hooi_gram"),
          "subspace": ITER_PHASES + ("lift",)}
LIBRARY = {"tucker2": "tucker2_factors_ws", "subspace": "subspace_ws"}
DEFINE = {"tucker2": "TUCKER2_WS_PROFILE=1", "subspace": "SUBSPACE_WS_PROFILE=1"}


def shapes(kernel, rng):
    """(label dict, launch function of a library) per profiled shape."""
    if kernel == "tucker2":
        for shape, r0, r1 in cs.main_path_buckets(cs.deit_program("tk")):
            x = cs.tucker_input(rng, shape)
            yield ({"shape_LKOI": list(shape), "ranks": [r0, r1],
                    "dims": (*shape[1:], r0, r1)},
                   lambda lib, x=x, r0=r0, r1=r1: tk.launch_ws(
                       lib, x, r0, r1, sweeps=cs.SWEEPS))
        return
    for shape, r in cs.tt_launches(cs.deit_program()):
        if sk.plan_name(shape[1], shape[2], r) != "workspace":
            continue
        t = torch.from_numpy((rng.standard_normal(shape) / np.sqrt(
            shape[2])).astype(np.float32)).cuda()
        yield ({"shape_L_rows_cols": list(shape), "rank": r,
                "dims": (shape[1], shape[2], r)},
               lambda lib, t=t, r=r: sk.launch_ws(lib, t, r,
                                                  iters=cs.TT_ITERS))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=tuple(LIBRARY), default="tucker2")
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
    name, defines = LIBRARY[args.kernel], (DEFINE[args.kernel],)
    info = build.build(name, defines=defines)
    lib = build.load(name, defines=defines)
    lib = tk.bind_ws(lib) if args.kernel == "tucker2" else sk.bind_ws(lib)
    profile = getattr(lib, f"{name}_profile")
    profile.argtypes = [ctypes.c_void_p]
    profile.restype = ctypes.c_int
    emit({"card": smi, "kernel": name,
          "ptxas": [ln for ln in info["compiler_output"].splitlines()
                    if "registers" in ln or "spill" in ln]})
    prof = np.zeros(16, np.uint64)
    phases = PHASES[args.kernel]

    def read():
        err = profile(prof.ctypes.data)
        if err != 0:
            raise RuntimeError(f"profile read failed: CUDA error {err}")
        return prof.copy()

    rng = np.random.RandomState(args.seed)
    for label, run in shapes(args.kernel, rng):
        dims = label.pop("dims")

        def launch():
            run(lib)

        launch()
        torch.cuda.synchronize()
        read()  # drop the warm-up launch
        ms = cs.cuda_ms(launch, args.launches, warmup=0)
        cycles = read()[:len(phases)] / args.launches
        cluster = (lib.tucker2_factors_ws_cluster(*dims)
                   if args.kernel == "tucker2" else lib.subspace_ws_cluster())
        row = {**label, "cluster": cluster,
               "ms_per_launch": ms,
               "block0_cycles_per_ms": float(cycles[0]) / ms}
        for phase, cyc in zip(phases, cycles):
            row[f"{phase}_share"] = float(cyc / cycles[0])
            row[f"{phase}_ms"] = float(cyc / cycles[0]) * ms
        emit(row)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
