"""Z/U-step layer-sharding A/B: `admm_update` in one process against the
same step sharded over layers on n ranks (the JAX package's
`bench/zstep_ab.py`).

The JAX harness times one jitted `admm_update`, replicated against
layer-sharded over a virtual CPU mesh. Here n ranks are processes of
their own (`parallel/launch.py::run_jobs`) on a `make_mesh(n)` grid,
each running the whole step on its block of every bucket
(`admm_update(mesh=)`) and three all-gathers a bucket. Where the machine
has fewer cards than ranks they share cuda:0 over gloo, which stages
every gathered block through the host: such a row measures n ranks
sharing one card, and no row of it is a scaling claim. Each row says
its ranks, backend and the GPUs visible.

`measure_isolated` times only the projection of each rank's block of a
[layers, ch, ch, 3, 3] stack, with no collective (the JAX row without
`admm_update`'s replicated bookkeeping).

Each rank warms its step up for at least a second and until two
successive calls agree within `STEADY` (`warm_up`: a fresh process's
first calls can run well above the steady step's time), then times
`iters` calls between device syncs on the host clock: the step is
host-driven, and its row is its wall time.

Methods: `kernel` (the port's counterpart of JAX's `pallas`: a bucket
through the Tucker-2 CUDA kernel, in one process and on each rank's
block), `subspace`, `gram`, `svd`, `ns` (layer by layer).

Run: python -m dnn_compression_tensor_admm_tpu_torch.bench.zstep_ab
[--isolate] [--methods kernel,subspace,ns] [--device cuda] [n_layer ...]
"""

from __future__ import annotations

import json
import math
import sys
import time
from typing import Callable, List, Sequence, Tuple

import torch

from ..admm import admm_init, admm_update, build_program
from ..configs import get_rank_plan
from ..models import create_model
from ..ops.cuda import subspace_kernel as sk
from ..ops.cuda import tucker_kernel as tk
from ..ops.tucker import tucker2_project
from ..parallel import dist
from ..parallel.launch import Job, run_jobs
from ..parallel.mesh import Mesh, make_mesh
from ..utils.card import card_info
from ..utils.profiling import device_sync

WARMUPS = 2  # at least: the first call loads the kernel library and allocates
MIN_WARMUP_S = 1.0  # and at least this long after the first call,
STEADY = 0.05  # then until two successive calls agree within 5 %,
MAX_WARMUP_S = 10.0  # or this long after the first call


def work_model(sizes: Sequence[int], n: int) -> dict:
    """The JAX harness's analytic model of its virtual mesh
    (`bench/zstep_ab.py:66-79` there) from the buckets' layer counts
    `sizes`: each [L] stack padded to n * ceil(L / n) solver slots, the
    padding solved on zeros; `slots_inflation` = slots / layers, the
    padded work the shared cores run, and `real_latency_model_x` = layers
    / sum ceil(L / n), the speed-up n devices would see on the solver.
    The port launches nothing for a block of padding (ROADMAP
    "Differences kept on purpose"), so `slots_inflation` describes the
    JAX virtual mesh, not the port's launches."""
    slots = sum(n * math.ceil(l / n) for l in sizes)
    inflation = slots / sum(sizes)
    real_model = sum(sizes) / sum(math.ceil(l / n) for l in sizes)
    return {"slots_inflation": round(inflation, 3),
            "real_latency_model_x": round(real_model, 2)}


def warm_up(call: Callable[[], None], device: torch.device
            ) -> Tuple[int, bool]:
    """Calls `call`, at least `WARMUPS` times and for `MIN_WARMUP_S` after
    the first call, until two successive calls' times agree within
    `STEADY` on every rank or `MAX_WARMUP_S` after the first call has
    passed. The ranks decide together, so they make the same calls.
    Returns the calls made and whether this rank's last two agreed."""
    prev = start = None
    i = 0
    while True:
        i += 1
        device_sync()
        t0 = time.perf_counter()
        call()
        device_sync()
        now = time.perf_counter()
        dt = now - t0
        if start is None:  # the first call loads (or builds) the kernels
            start = now
        steady = prev is not None and abs(dt - prev) <= STEADY * prev
        waited = now - start
        done = i >= WARMUPS and ((steady and waited >= MIN_WARMUP_S)
                                 or waited >= MAX_WARMUP_S)
        if dist.all_reduce(torch.tensor(
                [0.0 if done else 1.0], device=device)).item() == 0:
            return i, steady
        prev = dt


def _launches():
    return {"tucker2": tk.tucker2_factors_batched.launches,
            "subspace": sk.dominant_left_subspace_batched.launches}


def zstep_rank(device: torch.device, *, n_layer: int, model: str,
               fmt: str, ratio: str, iters: int, method: str) -> dict:
    """One rank's timed Z/U steps: the model from seed 0, its plan's
    program and state, `warm_up`, then `iters` steps (each feeding the
    next) between device syncs; ms a step and the kernels' launches a
    step."""
    m = create_model(model, generator=torch.Generator().manual_seed(0))
    params = {n: p.detach().to(device) for n, p in m.named_parameters()}
    program = build_program(params, get_rank_plan(model, fmt, ratio))
    state = admm_init(params, program)
    mesh = make_mesh(n_layer) if n_layer > 1 else None

    def step():
        nonlocal state
        state = admm_update(params, state, program, update_u=True,
                            method=method, n_iter=6, mesh=mesh)[0]

    warmups, steady = warm_up(step, device)
    before = _launches()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    device_sync()
    dt = (time.perf_counter() - t0) / iters
    after = _launches()
    return {"z_step_ms": 1000 * dt, "warmups": warmups, "steady": steady,
            "layers": len(program.names),
            "bucket_layers": [len(g.names) for g in program.groups],
            "launches_per_z_step": {k: (after[k] - before[k]) / iters
                                    for k in after},
            "nonfinite": int(state.nonfinite)}


def _with_ranks(row: dict, outs: List[dict], ranks: dict,
                device: str) -> dict:
    """The ranks' part of a row: the slowest rank's ms as the row's, each
    rank's, the warm-up calls (the same on every rank) and whether every
    rank reached a steady step, and where n > 1 the ranks, backend and GPUs
    visible."""
    row["z_step_ms"] = round(max(o["z_step_ms"] for o in outs), 2)
    row["z_step_ms_per_rank"] = [o["z_step_ms"] for o in outs]
    row["warmups"] = outs[0]["warmups"]
    row["steady"] = all(o["steady"] for o in outs)
    if ranks["ranks"] > 1:
        row.update(ranks=ranks["ranks"], backend=ranks["backend"],
                   gpus_visible=ranks["gpus_visible"])
    row["device"] = device
    row["card"] = card_info(torch.device(device))
    return row


def zstep_job(n_layer: int, model: str = "resnet32", fmt: str = "tk",
              ratio: str = "3", iters: int = 5, method: str = "subspace",
              device: str = "cuda") -> Job:
    """`measure`'s job, for `run_jobs` beside other jobs on the same
    ranks."""
    kw = dict(n_layer=n_layer, model=model, fmt=fmt, ratio=ratio,
              iters=iters, method=method)

    def merge(outs, ranks):
        row = {"n_layer_shards": n_layer, "method": method,
               "layers": outs[0]["layers"],
               **work_model(outs[0]["bucket_layers"], n_layer),
               "launches_per_z_step_per_rank": [o["launches_per_z_step"]
                                                for o in outs],
               "nonfinite": outs[0]["nonfinite"]}
        return _with_ranks(row, outs, ranks, device)
    return Job(zstep_rank, kw, merge)


def measure(n_layer: int, model: str = "resnet32", fmt: str = "tk",
            ratio: str = "3", iters: int = 5, method: str = "subspace",
            device: str = "cuda") -> dict:
    """One Z/U step of `model`'s `fmt`@`ratio` plan, in one process
    (n_layer 1) or sharded over n_layer ranks: its row."""
    return run_jobs([zstep_job(n_layer, model, fmt, ratio, iters, method,
                               device)], n_layer, device)[0]


def isolated_rank(device: torch.device, *, n_layer: int, method: str,
                  layers: int, ch: int, iters: int) -> dict:
    """This rank's block of a seeded [layers, ch, ch, 3, 3] stack
    projected to Tucker-2 ranks (ch / 2, ch / 2): `kernel` launches the
    Tucker-2 kernel on the block as the engine's kernel route does, the
    other methods go layer by layer through `ops/tucker.py`. `warm_up`,
    then `iters` timed; the ranks start together, no collective inside
    the timed loop."""
    rank = torch.distributed.get_rank() if n_layer > 1 else 0
    lo, hi, _ = Mesh(1, n_layer, rank).block(layers)
    x = torch.randn((layers, ch, ch, 3, 3),
                    generator=torch.Generator().manual_seed(0))
    block = x[lo:hi].to(device)
    r = ch // 2

    def solve():
        if method == "kernel":
            k = block.permute(0, 3, 4, 1, 2).reshape(
                hi - lo, 9, ch, ch).contiguous()
            return tk.tucker2_project_batched(k, r, r, sweeps=max(1, 6 // 3))
        return torch.stack([tucker2_project(w, r, r, n_iter=6, method=method)
                            for w in block])

    warmups, steady = warm_up(solve, device)
    dist.barrier(device)
    before = _launches()
    t0 = time.perf_counter()
    for _ in range(iters):
        solve()
    device_sync()
    dt = (time.perf_counter() - t0) / iters
    after = _launches()
    return {"z_step_ms": 1000 * dt, "warmups": warmups, "steady": steady,
            "block_layers": hi - lo,
            "launches_per_z_step": {k: (after[k] - before[k]) / iters
                                    for k in after}}


def measure_isolated(n_layer: int, method: str = "ns", layers: int = 32,
                     ch: int = 64, iters: int = 5,
                     device: str = "cuda") -> dict:
    """Only each rank's share of the projection (see the module
    docstring): its row."""
    kw = dict(n_layer=n_layer, method=method, layers=layers, ch=ch,
              iters=iters)

    def merge(outs, ranks):
        row = {"n_layer_shards": n_layer, "method": method,
               "isolated": True, "layers": layers,
               "block_layers_per_rank": [o["block_layers"] for o in outs],
               "launches_per_z_step_per_rank": [o["launches_per_z_step"]
                                                for o in outs]}
        return _with_ranks(row, outs, ranks, device)
    return run_jobs([Job(isolated_rank, kw, merge)], n_layer, device)[0]


def main(argv=None) -> list:
    argv = list(argv if argv is not None else sys.argv[1:])
    isolate = "--isolate" in argv
    if isolate:
        argv.remove("--isolate")
    methods = ["subspace"]
    if "--methods" in argv:
        i = argv.index("--methods")
        methods = argv[i + 1].split(",")
        del argv[i:i + 2]
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    ns = [int(a) for a in argv] or [1, 2, 4, 8]
    if 1 not in ns:
        ns = [1] + ns  # the 'unsharded' baseline must actually be measured
    rows = []
    for method in methods:
        mrows = [(measure_isolated if isolate else measure)(
            n, method=method, device=device) for n in ns]
        base = next(r["z_step_ms"] for r in mrows if r["n_layer_shards"] == 1)
        for r in mrows:
            r["speedup_vs_unsharded"] = round(base / r["z_step_ms"], 3)
            print(json.dumps(r), flush=True)
        rows.extend(mrows)
    return rows


if __name__ == "__main__":
    main()
