#!/usr/bin/env python3
"""The port's two Z-step kernels of another checkout against this one's, on one card.

Run from the root of a checkout, with the root of a second checkout (for
example the parent commit, unpacked with `git archive` into a directory
that .gitignore lists) as the baseline:

    python3 tools/torch_kernel_ab.py BASELINE_DIR [--out FILE] [--reps N]
        [--kernels subspace tucker2_factors] [-D NAME=VALUE ...]

It builds the kernels' libraries of both checkouts with nvcc (all
processes at once: `subspace.cu`, `subspace_ws.cu`, `tucker2_factors.cu`
and `tucker2_factors_ws.cu` where a checkout has them; a baseline from
before `subspace_ws.cu` keeps its workspace plan in `subspace.cu`) and,
at the shapes of the main paths (`chip_smoke.py`: the 24 subspace
launches of a ResNet32-TT@3x Z-step, the 33 of a DeiT-tiny-TT@2x Z-step,
13 of them in the workspace plan, the 5 Tucker-2 buckets of
ResNet32-TK@3x, the 4 of DeiT-tiny-TK@2x and the 16 of
MobileNetV2-CIFAR-SVD@2x, 11 of them in the workspace plan, inputs from
--seed) and at chip_smoke.py's two near-cap Tucker-2 buckets, times
baseline, this, this, baseline in device time (`chip_smoke.graph_ms`).
A shape that
takes a workspace plan the baseline does not have is timed in this build
alone. The subspace kernel is timed at the Z-step's iteration count and
at iters=0 (the Gram, the identity start and the lift), the Tucker-2
kernel at the Z-step's sweeps and at sweeps=0 (the Grams of X and the
HOSVD init). It reports this checkout's errors against the plain
versions, each workspace plan's cluster size and how many such clusters
the card holds at once (and at the subspace workspace launches and the
MobileNetV2 SVD buckets the time of `torch.linalg.svd` of the same t or
[L, O, I] stack), and the largest difference between
the two builds' outputs (at both counts, and over the block-plan and the
workspace-plan subspace launches), one JSON line per shape and
per-Z-step sums over the main-path shapes, also written to --out
(default build/kernel_ab.jsonl).

`-D` builds this checkout's side with any macro of the CUDA sources set
(ORTH_VEC_MIN_RP, ORTH_TILE_ROWS, SUBSPACE_LIFT_MIN_COLS), so with `.`
as the baseline it measures a threshold against the default:

    python3 tools/torch_kernel_ab.py . --kernels subspace -D ORTH_VEC_MIN_RP=4

Needs a CUDA card; exits 1 without one.
"""

import argparse
import concurrent.futures
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
from dnn_compression_tensor_admm_tpu_torch.ops.precision import full_f32  # noqa: E402
from torch_kernel_times import FEW_LAUNCHES  # noqa: E402  (tools/ is on the path)



def bind_subspace(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The block plans' launch of a `subspace` library and, for a baseline
    whose `subspace.cu` also holds the one-block workspace plan (before
    `subspace_ws.cu`), that plan's launch and int slab size."""
    lib.subspace_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                                    + [ctypes.c_void_p])
    lib.subspace_launch.restype = ctypes.c_int
    if hasattr(lib, "subspace_ws_launch"):
        lib.subspace_ws_launch.argtypes = ([ctypes.c_void_p] * 3
                                           + [ctypes.c_int] * 5
                                           + [ctypes.c_void_p])
        lib.subspace_ws_launch.restype = ctypes.c_int
        lib.subspace_ws_floats.argtypes = [ctypes.c_int] * 3
        lib.subspace_ws_floats.restype = ctypes.c_int
    return lib


def bind_tucker_ws(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`tucker_kernel.bind_ws`, or for a baseline from before the cluster
    plan (no `tucker2_factors_ws_cluster`; its slab size is an int) the
    launch and plan functions it has."""
    if hasattr(lib, "tucker2_factors_ws_cluster"):
        return tk.bind_ws(lib)
    lib.tucker2_factors_ws_launch.argtypes = ([ctypes.c_void_p] * 4
                                              + [ctypes.c_int] * 7
                                              + [ctypes.c_void_p])
    lib.tucker2_factors_ws_launch.restype = ctypes.c_int
    for name in ("tucker2_factors_ws_smem_bytes", "tucker2_factors_ws_floats"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 5
        getattr(lib, name).restype = ctypes.c_int
    return lib


BIND = {"subspace": bind_subspace, "subspace_ws": sk.bind_ws,
        "tucker2_factors": tk.bind, "tucker2_factors_ws": bind_tucker_ws}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("baseline", type=Path, help="root of the baseline checkout")
    ap.add_argument("--out", type=Path, default=Path("build/kernel_ab.jsonl"))
    ap.add_argument("--reps", type=int, default=4,
                    help="replays of a graph of 25 launches per turn")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", nargs="+",
                    choices=("subspace", "tucker2_factors"),
                    default=["subspace", "tucker2_factors"],
                    help="each includes its workspace plan where a checkout "
                         "has one")
    ap.add_argument("-D", "--define", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="a macro for this checkout's build (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    faulthandler.dump_traceback_later(900, exit=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    out = args.out.open("w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        out.write(line + "\n")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdin=subprocess.DEVNULL, capture_output=True, text=True,
        timeout=60).stdout.strip()
    base_src = (args.baseline.resolve() / "dnn_compression_tensor_admm_tpu_torch"
                / "csrc")
    sides = {"baseline": (base_src, ()),
             "this": (build.SRC_DIR, tuple(args.define))}
    names = list(args.kernels)
    names += [f"{n}_ws" for n in args.kernels]
    # a checkout from before a workspace plan's own library has no *_ws.cu
    items = [(side, name) for name in names for side in sides
             if (sides[side][0] / f"{name}.cu").exists()]

    def build_one(item):
        side, name = item
        return build.build(name, *sides[side])

    with concurrent.futures.ThreadPoolExecutor(len(items)) as pool:
        infos = list(pool.map(build_one, items))
    libs = {(side, name): BIND[name](build.load(name, *sides[side]))
            for side, name in items}
    emit({"card": smi, "defines": args.define,
          "builds_s": {f"{s} {n}": i["seconds"]
                       for (s, n), i in zip(items, infos)},
          "ptxas": {f"{s} {n}": [ln for ln in
                                 i["compiler_output"].splitlines()
                                 if "registers" in ln or "spill" in ln]
                    for (s, n), i in zip(items, infos)}})
    order = ("baseline", "this", "this", "baseline")

    def turns(fn, sides=order, graph=None):
        graph = graph or {"replays": args.reps}
        ms = [cs.graph_ms(lambda s=s: fn(s), **graph) for s in sides]
        if len(sides) == 2:  # this build alone
            return {"this": (ms[0] + ms[1]) / 2}
        return {"baseline": (ms[0] + ms[3]) / 2, "this": (ms[1] + ms[2]) / 2}

    rng = np.random.RandomState(args.seed)
    total = {}
    diff = {}  # the largest difference between the builds, by subspace plan

    def subspace_lib(side, plan):
        """The library that launches `plan` on this side, or None. A
        baseline from before `subspace_ws.cu` launches its workspace plan
        from its `subspace` library, with the same C signature
        (`bind_subspace`)."""
        if plan != "workspace":
            return libs[side, "subspace"]
        if (side, "subspace_ws") in libs:
            return libs[side, "subspace_ws"]
        lib = libs[side, "subspace"]
        return lib if hasattr(lib, "subspace_ws_launch") else None

    launches = []
    if "subspace" in args.kernels:
        launches = [("resnet32", s) for s in cs.tt_launches()]
        launches += [("deit", s) for s in cs.tt_launches(cs.deit_program())]
    for path, (shape, r) in launches:
        plan = sk.plan_name(shape[1], shape[2], r)
        if subspace_lib("this", plan) is None:
            continue  # this checkout has no workspace plan
        both = subspace_lib("baseline", plan) is not None
        t = torch.from_numpy((rng.standard_normal(shape)
                              / np.sqrt(shape[2])).astype(np.float32)).cuda()

        def subspace(side, iters=cs.TT_ITERS):
            run = sk.launch_ws if plan == "workspace" else sk.launch
            return run(subspace_lib(side, plan), t, r, iters=iters)

        q = subspace("this")
        p = sk.dominant_left_subspace_plain(t, r, iters=cs.TT_ITERS)
        with full_f32():
            proj = torch.linalg.matrix_norm(q @ q.mT - p @ p.mT).max().item()
            zq, zp = q @ (q.mT @ t), p @ (p.mT @ t)
        row = {"kernel": "subspace", "path": path, "shape": list(shape),
               "r": r, "plan": plan, "projector_err": proj,
               "projected_rel_err": (torch.linalg.vector_norm(zq - zp)
                                     / torch.linalg.vector_norm(zp)).item()}
        if plan == "workspace":  # the library yardstick, and this
            # build's cluster
            row["library_ms_batched_svd"] = cs.cuda_ms(
                lambda: torch.linalg.svd(t, full_matrices=False), 5, 1)
        if plan == "workspace" and ("this", "subspace_ws") in libs:
            lib = libs["this", "subspace_ws"]
            row["cluster"] = lib.subspace_ws_cluster()
            row["max_active_clusters"] = lib.subspace_ws_max_clusters(
                shape[1], shape[2], r)
        for iters in (cs.TT_ITERS, 0):
            if both:
                d = (subspace("this", iters)
                     - subspace("baseline", iters)).abs().max().item()
                row[f"max_abs_diff_vs_baseline_iters{iters}"] = d
                key = "block plans" if plan != "workspace" else plan
                diff[key] = max(diff.get(key, 0.0), d)
            for side, ms in turns(lambda s: subspace(s, iters),
                                  order if both else ("this", "this")).items():
                row[f"{side}_ms_iters{iters}"] = ms
                key = f"subspace {path} {side} iters={iters}"
                total[key] = total.get(key, 0.0) + ms
        emit(row)
    if diff:
        emit({"kernel": "subspace", "max_abs_diff_vs_baseline": diff})
    buckets = [(b, "resnet32") for b in cs.main_path_buckets()]
    buckets += [(b, None) for b in cs.NEAR_CAP_BUCKETS]
    buckets += [(b, "deit") for b in
                cs.main_path_buckets(cs.deit_program("tk"))]
    buckets += [(b, "mbv2_svd") for b in
                cs.main_path_buckets(cs.mbv2_program())]
    base_ws = ("baseline", "tucker2_factors_ws") in libs
    for (shape, r0, r1), path in (buckets if "tucker2_factors" in args.kernels
                                  else ()):
        x = torch.from_numpy((rng.standard_normal(shape) / np.sqrt(
            shape[1] * shape[3])).astype(np.float32)).cuda()

        plan = tk.plan_name(*shape[1:], r0, r1)
        if plan == "workspace" and ("this", "tucker2_factors_ws") not in libs:
            continue  # this checkout has no workspace plan

        def tucker(side, sweeps=cs.SWEEPS):
            if plan == "workspace":
                return tk.launch_ws(libs[side, "tucker2_factors_ws"], x, r0,
                                    r1, sweeps=sweeps)
            return tk.launch(libs[side, "tucker2_factors"], x, r0, r1,
                             sweeps=sweeps)

        both = plan != "workspace" or base_ws
        graph = FEW_LAUNCHES if plan == "workspace" else None
        p0, p1 = tk.tucker2_factors_plain(x, r0, r1, sweeps=cs.SWEEPS)
        row = {"kernel": "tucker2_factors", "path": path,
               "shape": list(shape), "ranks": [r0, r1], "plan": plan}
        if plan == "workspace":  # this build's cluster and its occupancy
            lib = libs["this", "tucker2_factors_ws"]
            row["cluster"] = lib.tucker2_factors_ws_cluster(*shape[1:], r0, r1)
            row["max_active_clusters"] = lib.tucker2_factors_ws_max_clusters(
                *shape[1:], r0, r1)
        if path == "mbv2_svd":  # K = 1, r0 = r1: the truncated SVD
            row["library_ms_batched_svd"] = cs.cuda_ms(
                lambda: torch.linalg.svd(x[:, 0], full_matrices=False), 5, 1)
        for sweeps in (cs.SWEEPS, 0):
            u0, u1 = tucker("this", sweeps)
            if both:
                b0, b1 = tucker("baseline", sweeps)
                row[f"max_abs_diff_vs_baseline_sweeps{sweeps}"] = max(
                    (u0 - b0).abs().max().item(),
                    (u1 - b1).abs().max().item())
            if sweeps == cs.SWEEPS:
                z = tk.tucker2_reconstruct(x, u0, u1)
                zp = tk.tucker2_reconstruct(x, p0, p1)
                row["z_rel_err"] = (torch.linalg.vector_norm(z - zp)
                                    / torch.linalg.vector_norm(zp)).item()
            sides = order if both else ("this", "this")
            for side, ms in turns(lambda s: tucker(s, sweeps), sides,
                                  graph).items():
                row[f"{side}_ms_sweeps{sweeps}"] = ms
                key = f"tucker2 {path} {side} sweeps={sweeps}"
                if path is not None:
                    total[key] = total.get(key, 0.0) + ms
        emit(row)
    emit({"ms_per_z_step": total, "card": smi, "defines": args.define})
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
