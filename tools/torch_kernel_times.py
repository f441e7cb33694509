#!/usr/bin/env python3
"""Device times of both CUDA kernels at every launch of every plan, the
Z/U step's kernel time against its other work, and the recipe path's
untraced X-step probes, on one card: the timing that `chip_smoke.py`
leaves out to stay a check.

    python3 tools/torch_kernel_times.py [--paths tk3 deit_tt2 ...]
        [--zstep-split] [--probes] [--out kernel_times.jsonl]

builds the four kernel libraries (four nvcc processes at once) and times
each chosen plan's launches at `chip_smoke`'s shapes (its shape tables
and inputs; the check against the plain version is `chip_smoke`'s): the
kernel from CUDA graphs of 25 launches (5 for a workspace-plan bucket or
an r >= 256 launch; a launch of TK_SINGLE_LAUNCH_FLOATS or more alone),
again without its iteration (`hosvd_ms`, `gram_ms`), and its plain
version and library yardstick over 5 calls after a warm-up, beside the
card's bound (`chip_smoke.bound_fields`). A `"phase": "kernel_times"`
line per plan sums them per Z-step. `--zstep-split` times one-process
Z/U steps (`admm_update`, the kernel route) of ResNet32 TK@3x and TT@3x
and DeiT-tiny TT@2x and TK@2x by CUDA events, and the kernel wrappers'
share of each (the rest: W + U, the products around the kernel, the
finite guard, the norms and U), on the whole stack and on each rank's
block of a 2-rank layer-sharded step, which is what that rank computes
before its all-gathers. `--probes` writes the DeiT-tiny
recipe's shards and times an untraced epoch (the second of two: the
first holds the capture) of its dense X-step streamed and read whole, its ADMM X-step streamed and its fine-tune's step, then
traces one streamed ADMM epoch (`utils/profiling.py`) and reads the
card's busy time a step against the untraced ADMM step's time
(`idle_share`), and times the dense step again after the trace; the
ADMM step streamed also in the eager loop (`train_model(eager=True)`).
It also times ResNet32 TK@3x and DeiT-tiny TT@2x ADMM (bf16, 4 epochs x
20 steps, an evaluation after epoch 2) in the eager loop, on the captured
per-epoch route and fused (`--epochs-per-dispatch`: the second chunk,
replays alone), before any trace, then traces the first epoch of X-steps
of the first two (the captured route's replays) and the fused route's
second chunk for the card's busy time a step and each route's idle share
of an untraced step (`"phase": "fused_probes"`). Each line carries the card's name and power
limit. Without CUDA it exits 1.
"""

import faulthandler
import sys

if __name__ == "__main__":
    faulthandler.dump_traceback_later(1800, exit=True)

import argparse  # noqa: E402
import concurrent.futures  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.admm import (  # noqa: E402
    admm_init, admm_update, build_program)
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.models import create_model  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import build  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import subspace_kernel as sk  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.parallel.mesh import Mesh  # noqa: E402

# A Tucker-2 workspace-plan launch does 0.1 to 10 G FMA a layer on a
# cluster of 8 SMs, 2 to 26 ms (DeiT TK, MobileNetV2 SVD), and a subspace
# launch at r >= TT_BIG_RANK ~10 G FMA of Newton-Schulz: graphs of 5
# launches keep their timing to seconds. Other launches take graph_ms's
# default of 25.
FEW_LAUNCHES = {"launches": 5, "replays": 2}
# Z/U steps timed per program by --zstep-split, after two warm-up steps;
# each rank's block of a ZSTEP_RANKS-rank layer-sharded step timed too
ZSTEP_REPS = 5
ZSTEP_RANKS = 2

# key -> (row name, model, format, ratio, library yardstick of a K = 1
# bucket: one batched SVD of the stack)
TK_PLANS = {
    "tk3": ("resnet32 tk@3x", "resnet32", "tk", "3", False),
    "deit_tk2": ("deit_tiny_patch16_224 tk@2x", "deit_tiny_patch16_224", "tk",
                 "2", False),
    "mbv2_svd2": ("mobilenetv2_cifar svd@2x", "mobilenetv2_cifar", "svd", "2",
                  True),
    "r50_tk3": ("resnet50 tk@3x", "resnet50", "tk", "3", True),
    "r56_tk3": ("resnet56 tk@3x", "resnet56", "tk", "3", False),
    "mbv2_inet_svd2": ("mobilenetv2 svd@2x", "mobilenetv2", "svd", "2", True),
    "mbv2_inet_tk2": ("mobilenetv2 tk@2x", "mobilenetv2", "tk", "2", True),
    "vgg16_tk2": ("vgg16 tk@2x", "vgg16", "tk", "2", True),
    "densenet121_tk2": ("densenet121 tk@2x", "densenet121", "tk", "2", True),
    "densenet40_tk2": ("densenet40 tk@2x", "densenet40", "tk", "2", True),
    "deit_svd2": ("deit_tiny_patch16_224 svd@2x (auto)",
                  "deit_tiny_patch16_224", "svd", "2", True),
}
# key -> (row name, model, ratio): TT plans
TT_PLANS = {
    "tt3": ("resnet32 tt@3x", "resnet32", "3"),
    "deit_tt2": ("deit_tiny_patch16_224 tt@2x", "deit_tiny_patch16_224", "2"),
    "r50_tt3": ("resnet50 tt@3x", "resnet50", "3"),
    "deit_s_tt2": ("deit_small_patch16_224 tt@2x", "deit_small_patch16_224",
                   "2"),
    "r56_tt3": ("resnet56 tt@3x", "resnet56", "3"),
    "mbv2_inet_tt2": ("mobilenetv2 tt@2x", "mobilenetv2", "2"),
}


def per_z_step(rows, split_key: str) -> dict:
    """A plan's launch rows summed per Z-step."""
    return {"launches": len(rows),
            **{k: sum(r[k] for r in rows)
               for k in ("kernel_ms", split_key, "plain_ms", "library_ms")},
            "bound_ms": sum(r["bound_us"] for r in rows) / 1000}


def tk_times(seed: int, buckets, path: str, svd: bool, emit) -> list:
    """Each Tucker-2 bucket of a plan timed in full (module docstring);
    the library yardstick as `chip_smoke.phase_kernel` takes it."""
    rng = np.random.RandomState(seed)
    rows = []
    for shape, r0, r1 in buckets:
        l, k, o, i = shape
        x = cs.tucker_input(rng, shape)
        plan = tk.plan_name(k, o, i, r0, r1)
        single = l * k * o * i >= cs.TK_SINGLE_LAUNCH_FLOATS
        if single:
            timing = {"launches": 1}
            timed = lambda fn: cs.cuda_ms(fn, 1, 1)  # noqa: E731
        else:
            timing = FEW_LAUNCHES if plan == "workspace" else {}
            timed = lambda fn: cs.graph_ms(fn, **timing)  # noqa: E731
        if svd and k == 1:
            def library():
                torch.linalg.svd(x[:, 0], full_matrices=False)
        else:
            unf0 = x.permute(0, 2, 1, 3).reshape(l, o, k * i)
            unf1 = x.permute(0, 3, 1, 2).reshape(l, i, k * o)

            def library():
                torch.linalg.svd(unf0, full_matrices=False)
                torch.linalg.svd(unf1, full_matrices=False)

        kernel_ms = timed(
            lambda: tk.tucker2_factors_batched(x, r0, r1, sweeps=cs.SWEEPS))
        # the same launch without the HOOI sweeps: the Grams of X and the
        # HOSVD init
        hosvd_ms = timed(
            lambda: tk.tucker2_factors_batched(x, r0, r1, sweeps=0))
        iters = 1 if single else 5
        flops, algorithm_flops, nbytes = cs.tucker_work(shape, r0, r1)
        row = {"phase": "kernel_time", "name": "tucker2_factors_batched",
               "path": path, "shape_LKOI": list(shape), "ranks": [r0, r1],
               "plan": plan,
               "timed_by": ("single launches" if single else
                            f"graphs of {timing.get('launches', 25)}"),
               "kernel_ms": kernel_ms, "hosvd_ms": hosvd_ms,
               "plain_ms": cs.cuda_ms(lambda: tk.tucker2_factors_plain(
                   x, r0, r1, sweeps=cs.SWEEPS), iters, 1),
               "library_ms": cs.cuda_ms(library, iters, 1),
               "library": ("batched svd" if svd and k == 1 else
                           "svd of both unfoldings"),
               "algorithm_flops": algorithm_flops,
               **cs.bound_fields(flops, nbytes, kernel_ms)}
        emit(row)
        rows.append(row)
    return rows


def tt_times(seed: int, launches, program, path: str, emit) -> list:
    """Each subspace launch of a TT plan timed in full (module docstring),
    then the plan's whole batched TT-SVD sweep of one Z-step."""
    rng = np.random.RandomState(seed)
    rows = []
    for shape, r in launches:
        _, rows_, cols = shape
        t_np = rng.standard_normal(shape).astype(np.float32)
        t = torch.from_numpy(t_np / np.float32(np.sqrt(cols))).cuda()
        timing = FEW_LAUNCHES if r >= cs.TT_BIG_RANK else {}
        kernel_ms = cs.graph_ms(lambda: sk.dominant_left_subspace_batched(
            t, r, iters=cs.TT_ITERS), **timing)
        flops, algorithm_flops, nbytes = cs.subspace_work(shape, r)
        row = {"phase": "kernel_time", "name": "dominant_left_subspace_batched",
               "path": path, "plan": sk.plan_name(rows_, cols, r),
               "shape_L_rows_cols": list(shape), "rank": r,
               "graph_launches": timing.get("launches", 25),
               "kernel_ms": kernel_ms,
               # the same launch without the iteration: the Gram, the
               # identity start and, in the tall case, the lift
               "gram_ms": cs.graph_ms(lambda: sk.dominant_left_subspace_batched(
                   t, r, iters=0), **timing),
               "plain_ms": cs.cuda_ms(lambda: sk.dominant_left_subspace_plain(
                   t, r, iters=cs.TT_ITERS), 5, 1),
               "library_ms": cs.cuda_ms(
                   lambda: torch.linalg.svd(t, full_matrices=False), 5, 1),
               "library": "batched svd",
               "algorithm_flops": algorithm_flops,
               **cs.bound_fields(flops, nbytes, kernel_ms)}
        emit(row)
        rows.append(row)
    xs = []
    for g in program.groups:
        numel = int(np.prod(g.param_shape))
        x = rng.standard_normal((len(g.names), numel)).astype(np.float32)
        xs.append((torch.from_numpy(x).cuda(), g.spec))
    emit({"phase": "kernel_time", "name": "tt_project_batched", "path": path,
          "buckets": len(xs), "ms_per_z_step": cs.cuda_ms(lambda: [
              sk.tt_project_batched(x, sp.tt_shapes, sp.tt_ranks,
                                    iters=cs.TT_ITERS)
              for x, sp in xs], 10, 2)})
    return rows


# key -> (model, format, ratio): the one-process Z/U steps --zstep-split
# times
ZSTEP_PROGRAMS = {
    "tk3": ("resnet32", "tk", "3"),
    "tt3": ("resnet32", "tt", "3"),
    "deit_tt2": ("deit_tiny_patch16_224", "tt", "2"),
    "deit_tk2": ("deit_tiny_patch16_224", "tk", "2"),
}


@contextlib.contextmanager
def kernel_events():
    """Inside the block both kernel wrappers record a pair of CUDA events
    around each call into the list yielded (the Z-step's callers look the
    wrappers up in their modules at each call)."""
    pairs = []

    def wrapped(fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            pairs.append((start, end))
            return out
        call.launches = 0  # the wrapper counts its launches by its name
        return call

    saved = tk.tucker2_factors_batched, sk.dominant_left_subspace_batched
    tk.tucker2_factors_batched = wrapped(saved[0])
    sk.dominant_left_subspace_batched = wrapped(saved[1])
    try:
        yield pairs
    finally:
        tk.tucker2_factors_batched, sk.dominant_left_subspace_batched = saved


def zstep_split(seed: int, key: str) -> dict:
    """One-process Z/U steps of a program (seeded weights, U = 0.01 N(0,
    1)), on the whole stack and on each rank's block (`_time_zsteps`)."""
    model_name, fmt, ratio = ZSTEP_PROGRAMS[key]
    model = create_model(model_name, generator=torch.Generator().manual_seed(
        seed)).cuda()
    params = dict(model.named_parameters())
    program = build_program(params, get_rank_plan(model_name, fmt, ratio))
    state = admm_init(params, program)
    gen = torch.Generator().manual_seed(seed + 1)
    for n in program.names:
        state.u[n] = 0.01 * torch.randn(params[n].shape, generator=gen).cuda()

    whole = _time_zsteps(params, state, program)
    # what each rank of a 2-rank layer-sharded step computes: the step on
    # its block of every bucket alone (the gathers left out)
    blocks = [_time_zsteps(params, state, cs.block_program(
        program, Mesh(1, ZSTEP_RANKS, r))) for r in range(ZSTEP_RANKS)]
    return {"phase": "zstep_split", "program": f"{model_name} {fmt}@{ratio}x",
            "buckets": len(program.groups), "layers": len(program.names),
            "steps": ZSTEP_REPS, **whole,
            f"rank_block_step_ms_{ZSTEP_RANKS}_ranks": [
                b["step_ms"] for b in blocks],
            f"rank_block_kernel_ms_{ZSTEP_RANKS}_ranks": [
                b["kernel_ms"] for b in blocks]}


def _time_zsteps(params, state, program) -> dict:
    """ZSTEP_REPS Z/U steps of `program` after two warm-up steps: device
    ms a step between CUDA events, the host's wall ms a step, and the
    kernel wrappers' device ms within it."""
    def step():
        return admm_update(params, state, program, update_u=True,
                           method="kernel", n_iter=6)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    step_ms, kernel_ms, wall_ms = [], [], []
    with kernel_events() as pairs:
        for _ in range(ZSTEP_REPS):
            pairs.clear()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            step()
            end.record()
            torch.cuda.synchronize()
            wall_ms.append(1000 * (time.perf_counter() - t0))
            step_ms.append(start.elapsed_time(end))
            kernel_ms.append(sum(s.elapsed_time(e) for s, e in pairs))
            launches = len(pairs)
    step_mean = sum(step_ms) / ZSTEP_REPS
    kernel_mean = sum(kernel_ms) / ZSTEP_REPS
    return {"wrapper_calls_per_step": launches, "step_ms": step_mean,
            "wall_ms": sum(wall_ms) / ZSTEP_REPS, "kernel_ms": kernel_mean,
            "other_ms": step_mean - kernel_mean,
            "other_share": 1 - kernel_mean / step_mean}


def probes(seed: int, card: str) -> dict:
    """The DeiT-tiny recipe's untraced X-step probes and one traced ADMM
    epoch (see the module docstring)."""
    from dnn_compression_tensor_admm_tpu_torch.train import (TrainConfig,
                                                             train_model)
    from dnn_compression_tensor_admm_tpu_torch.utils.profiling import (
        trace_summary)
    path = cs.DEIT_R
    with tempfile.TemporaryDirectory() as workdir:
        shards = cs.recipe_shards(workdir)[0]
        out = {"dense_streamed": cs.recipe_probe(seed, shards, None),
               "dense_cached": cs.recipe_probe(seed, shards, "hbm"),
               "admm_streamed": cs.recipe_probe(seed, shards, None,
                                                admm=True),
               "admm_streamed_eager": cs.recipe_probe(seed, shards, None,
                                                      admm=True, eager=True),
               "finetune_cached": cs.recipe_probe(
                   seed, shards, "hbm", model=path["model"],
                   randaug_magnitude=9, randaug_std=0.5, erase_prob=0.25,
                   repeated_aug=3, sampling="shuffle")}
        profile_dir = os.path.join(workdir, "profile")
        cfg = TrainConfig(model=path["dense"], dataset=path["dataset"],
                          shard_dir=shards, epochs=1, admm=True, fmt="tt",
                          ratio=path["ratio_arg"],
                          steps_per_epoch=path["steps_per_epoch"],
                          batch_size=path["batch_size"], opt="adamw",
                          lr=path["lr"], mixup=0.8, cutmix=1.0,
                          smoothing=0.1,
                          loader_workers=path["loader_workers"],
                          compute_dtype="bfloat16", seed=seed, device="cuda",
                          profile_dir=profile_dir, print_fn=cs.log)
        hist = train_model(cfg)[1]
        profile = trace_summary(hist[0]["profile_trace"], top=10)
        busy = profile["device_busy_ms"] / hist[0]["profile_steps"]
        out["traced_admm_epoch"] = {
            "device_busy_ms_per_step": busy,
            "idle_share_of_untraced_step":
                1 - busy / out["admm_streamed"]["ms_per_step"],
            "top_ops": profile["top_ops"]}
        out["dense_cached_after_trace"] = cs.recipe_probe(seed, shards, "hbm")
    return {"phase": "probes", "card": card, "model": path["name"], **out}


# the fused probes' runs: an evaluation after epoch 2 ends the first chunk,
# so the second chunk is replays alone
FUSED_PROBE = dict(epochs=4, eval_every=2, steps=20)


def fused_probe_config(key: str, seed: int, per_dispatch: int, **kw):
    cfg = cs.fused_config(key, seed, FUSED_PROBE["epochs"],
                          FUSED_PROBE["steps"], per_dispatch, "bfloat16")
    return dataclasses.replace(cfg, eval_every=FUSED_PROBE["eval_every"],
                               **kw)


@contextlib.contextmanager
def traced_second_chunk(logdir: str):
    """The run's second fused chunk inside a `torch.profiler` trace."""
    from dnn_compression_tensor_admm_tpu_torch.train import capture
    from dnn_compression_tensor_admm_tpu_torch.utils.profiling import trace
    run, calls = capture.EpochChunks.run, []

    def traced(self, k):
        calls.append(k)
        if len(calls) != 2:
            return run(self, k)
        with trace(logdir):
            return run(self, k)

    capture.EpochChunks.run = traced
    try:
        yield calls
    finally:
        capture.EpochChunks.run = run


def fused_untraced(seed: int) -> dict:
    """ms a step of the three routes, before any trace: the eager loop's
    and the captured per-epoch route's epochs 3-4 (a Z/U step and 20
    X-steps each, and its X-steps alone), the fused route's second chunk
    (its Z/U steps included)."""
    from dnn_compression_tensor_admm_tpu_torch.train import train_model
    steps, out = FUSED_PROBE["steps"], {}
    with cs.shared_sets():
        for key in cs.FUSED["paths"]:
            out[key] = {"model": cs.PATHS[key]["name"]}
            for route, eager in (("eager", True), ("per_epoch", False)):
                rows = train_model(fused_probe_config(key, seed, 1),
                                   eager=eager)[1][2:]
                out[key][f"{route}_ms_per_step"] = [
                    1000 * h["epoch_time_s"] / steps for h in rows]
                out[key][f"{route}_x_ms_per_step"] = [
                    1000 * h["x_step_s"] / steps for h in rows]
            fused = train_model(fused_probe_config(key, seed, 8))[1][-1]
            out[key]["fused_ms_per_step"] = (1000 * fused["epoch_time_s"]
                                             / steps)
    return out


def fused_traced(seed: int, card: str, out: dict, workdir: str) -> dict:
    """`fused_untraced`'s rows with the card's busy time a step from
    traces: the first epoch's X-steps of the eager loop and of the
    captured per-epoch route (`profile_dir`, which keeps a run per epoch;
    the captured route traces its replays), and the fused route's second
    chunk (Z/U steps included); idle = 1 - busy / the untraced ms."""
    from dnn_compression_tensor_admm_tpu_torch.train import train_model
    from dnn_compression_tensor_admm_tpu_torch.utils.profiling import (
        trace_summary)
    steps = FUSED_PROBE["steps"]
    with cs.shared_sets():
        for key in cs.FUSED["paths"]:
            o = out[key]
            for route, eager in (("eager", True), ("per_epoch", False)):
                logdir = os.path.join(workdir, f"{key}_{route}")
                row = train_model(fused_probe_config(
                    key, seed, 1, epochs=1, profile_dir=logdir),
                    eager=eager)[1][0]
                busy = trace_summary(row["profile_trace"])["device_busy_ms"]
                o[f"{route}_busy_ms_per_x_step"] = busy / row["profile_steps"]
                o[f"{route}_idle_share"] = 1 - o[
                    f"{route}_busy_ms_per_x_step"] / min(
                    o[f"{route}_x_ms_per_step"])
            logdir = os.path.join(workdir, f"{key}_fused")
            with traced_second_chunk(logdir) as calls:
                train_model(fused_probe_config(key, seed, 8))
            fused_busy = trace_summary(os.path.join(logdir, "trace.json"))
            o["fused_busy_ms_per_step"] = (fused_busy["device_busy_ms"]
                                           / (calls[1] * steps))
            o["fused_idle_share"] = (1 - o["fused_busy_ms_per_step"]
                                     / o["fused_ms_per_step"])
            o["fused_trace_top_ops"] = fused_busy["top_ops"][:5]
    return {"phase": "fused_probes", "card": card, "bf16": FUSED_PROBE, **out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", nargs="*", default=None,
                    choices=[*TK_PLANS, *TT_PLANS],
                    help="plans to time (default: all)")
    ap.add_argument("--zstep-split", action="store_true",
                    help="the Z/U step's kernel time against its other work "
                         "(alone unless --paths)")
    ap.add_argument("--probes", action="store_true",
                    help="the recipe's X-step probes (alone unless --paths)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.log("torch_kernel_times: CUDA is not available")
        return 1
    keys = args.paths
    if keys is None:
        keys = ([] if args.probes or args.zstep_split
                else [*TK_PLANS, *TT_PLANS])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], stdin=subprocess.DEVNULL,
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    out = open(args.out, "a") if args.out else None

    def emit(row):
        line = json.dumps({**row, "card": card})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        list(pool.map(build.build, ("tucker2_factors", "tucker2_factors_ws",
                                    "subspace", "subspace_ws")))
    emit({"phase": "build", "wall_s": time.perf_counter() - t0})
    for key in keys:
        t0 = time.perf_counter()
        if key in TK_PLANS:
            name, model, fmt, ratio, svd = TK_PLANS[key]
            rows = tk_times(args.seed, cs.main_path_buckets(
                cs._program(fmt, model, ratio)), name, svd, emit)
            split = "hosvd_ms"
        else:
            name, model, ratio = TT_PLANS[key]
            program = cs._program("tt", model, ratio)
            rows = tt_times(args.seed, cs.tt_launches(program), program, name,
                            emit)
            split = "gram_ms"
        emit({"phase": "kernel_times", "plan": key, "path": name,
              "ms_per_z_step": per_z_step(rows, split),
              "wall_s": time.perf_counter() - t0})
    if args.zstep_split:
        for key in ZSTEP_PROGRAMS:
            t0 = time.perf_counter()
            emit({**zstep_split(args.seed, key),
                  "wall_s": time.perf_counter() - t0})
    if args.probes:
        cs.emit = emit  # the probes' rows too
        t0 = time.perf_counter()
        untraced = fused_untraced(args.seed)  # before the recipe's trace
        fused_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        emit({**probes(args.seed, card), "wall_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as workdir:
            emit({**fused_traced(args.seed, card, untraced, workdir),
                  "wall_s": fused_s + time.perf_counter() - t0})
    if out:
        out.close()
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
