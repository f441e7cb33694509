"""Scaling harness: ADMM step efficiency at 1..N ranks, with its controls
(the JAX package's `bench/scaling.py`).

The JAX harness runs the same sharded programs over a virtual CPU mesh,
whose devices share the host's cores, and two communication-free
controls measure that sharing: a matmul chain and the train step's own
forward and backward with the gradients kept local, each at fixed work a
device, so that a real mesh would keep their time flat. Here n ranks are
processes of their own (`parallel/launch.py::run_jobs`) on a
`make_mesh(n_layer)` grid running `train_model`; where the machine has
fewer cards than ranks they share cuda:0 over gloo, so the controls
measure n ranks sharing one card as JAX's measured shared host cores,
and no row is a scaling claim.

A mesh of several ranks runs its X-step eagerly (its collectives are not
captured, `train/capture.py`), one rank captures it: so the 1-rank
baseline also runs `train_model(eager=True)`, every efficiency is taken
against that eager row, and the captured 1-rank row is printed beside
it. Each row says its route: `captured` where the run captured its
X-step (`CapturedStep.captures`), else `eager`.

Run: python -m dnn_compression_tensor_admm_tpu_torch.bench.scaling
[--dense] [--device cuda] [N ...]
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict, List

import torch

from ..models import create_model
from ..ops.precision import full_f32
from ..parallel import dist
from ..parallel.launch import Job, run_jobs
from ..parallel.mesh import make_mesh
from ..train import TrainConfig, train_model
from ..train.capture import CapturedStep
from ..utils.card import card_info
from ..utils.profiling import device_sync


def n_layer_of(n: int, admm: bool) -> int:
    """Ranks along 'layer': 2 where ADMM runs on an even count (the JAX
    rule), else every rank on 'data'."""
    return 2 if (admm and n % 2 == 0 and n >= 2) else 1


def train_rank(device: torch.device, *, n: int, batch_per_device: int,
               steps: int, model: str, admm: bool, eager: bool) -> dict:
    """This rank's `train_model` run; the last epoch's time (the first
    holds the capture) and whether the run captured its X-step."""
    n_layer = n_layer_of(n, admm)
    mesh = make_mesh(n_layer) if n > 1 else None
    cfg = TrainConfig(
        model=model, dataset="synthetic-cifar10",
        batch_size=batch_per_device * (n // n_layer),
        epochs=2, steps_per_epoch=steps, lr=0.1, admm=admm, fmt="tk",
        ratio="3", admm_method="subspace", compute_dtype=None,
        # no epoch fusion: epoch 1 (the capture) and epoch 2 (steady)
        # are separate
        epochs_per_dispatch=1, synthetic_size=1024,
        eval_every=10 ** 9, device=str(device), print_fn=lambda *a: None)
    captures = CapturedStep.captures
    _, hist = train_model(cfg, mesh=mesh, eager=eager)
    route = "captured" if CapturedStep.captures > captures else "eager"
    return {"epoch_time_s": hist[-1]["epoch_time_s"], "route": route,
            "global_batch": cfg.batch_size, "mesh": [n // n_layer, n_layer]}


def train_job(n: int, batch_per_device: int = 32, steps: int = 4,
              model: str = "resnet20", admm: bool = True,
              eager: bool = False, device: str = "cuda") -> Job:
    """`measure`'s job, for `run_jobs` beside other jobs on the same
    ranks."""
    kw = dict(n=n, batch_per_device=batch_per_device, steps=steps,
              model=model, admm=admm, eager=eager)

    def merge(outs, ranks):
        per_epoch = max(o["epoch_time_s"] for o in outs)
        out = outs[0]
        row = {"devices": n, "mesh": out["mesh"], "admm": admm,
               "global_batch": out["global_batch"],
               "steps_per_s": steps / per_epoch,
               "images_per_s": steps * out["global_batch"] / per_epoch,
               "route": out["route"],
               "epoch_time_s_per_rank": [o["epoch_time_s"] for o in outs]}
        if n > 1:
            row.update(ranks=ranks["ranks"], backend=ranks["backend"],
                       gpus_visible=ranks["gpus_visible"])
        return {**row, "device": device,
                "card": card_info(torch.device(device))}
    return Job(train_rank, kw, merge)


def measure(n_devices: int, batch_per_device: int = 32, steps: int = 4,
            model: str = "resnet20", admm: bool = True, eager: bool = False,
            device: str = "cuda") -> dict:
    """`train_model` on n_devices ranks (n_layer by `n_layer_of`): the
    last epoch's steps/s and images/s."""
    return run_jobs([train_job(n_devices, batch_per_device, steps, model,
                               admm, eager, device)], n_devices, device)[0]


def control_rank(device: torch.device, *, size: int, iters: int,
                 reps: int) -> dict:
    """This rank's matmul chain: iters products of a [size, size] block
    by 0.999 I in float32 (TF32 off), one warm-up, then reps calls timed
    after the ranks start together; no collective inside."""
    x = torch.ones((size, size), device=device)
    w = torch.eye(size, device=device) * 0.999

    def f(b):
        for _ in range(iters):
            b = b @ w + 1e-6
        return b

    with full_f32():
        y = f(x)
        dist.barrier(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            y = f(y)
        device_sync()
    return {"control_s": (time.perf_counter() - t0) / reps}


def control_job(n: int, size: int = 768, iters: int = 12,
                reps: int = 5) -> Job:
    def merge(outs, ranks):
        dt = max(o["control_s"] for o in outs)
        flops = 2.0 * n * iters * size ** 3
        return {"devices": n, "control_s": dt,
                "control_s_per_rank": [o["control_s"] for o in outs],
                "control_gflops_s": round(flops / dt / 1e9, 1)}
    return Job(control_rank, dict(size=size, iters=iters, reps=reps), merge)


def measure_control(n_devices: int, size: int = 768, iters: int = 12,
                    reps: int = 5, device: str = "cuda") -> dict:
    """Compute-bound, communication-free control: each rank runs the same
    matmul chain (fixed FLOPs a rank). On ranks of their own cards it
    weak-scales at ~1.0 by construction, so the efficiency it loses
    measures the sharing (here: of one card)."""
    return run_jobs([control_job(n_devices, size, iters, reps)], n_devices,
                    device)[0]


def control_step_rank(device: torch.device, *, batch_per_device: int,
                      model: str, iters: int, reps: int) -> dict:
    """This rank's forward and backward of `model` (eval mode, float32,
    seed 0) on a [b, 3, 32, 32] batch, iters times a call with the
    gradients kept local (their squared norm folded into the input, a
    data-dependent carry as JAX's); one warm-up, reps calls timed after
    the ranks start together."""
    m = create_model(model, generator=torch.Generator().manual_seed(0))
    m = m.to(device).eval()
    params = list(m.parameters())

    def f(b):
        for _ in range(iters):
            logits = m(b)
            lse = torch.logsumexp(logits, -1)
            loss = torch.mean(lse - logits[:, 0])
            grads = torch.autograd.grad(loss, params)
            gn = sum(torch.sum(g.float() ** 2) for g in grads)
            b = b * (1.0 + 0.0 * loss.detach()) + gn * 1e-12
        return b

    x = torch.ones((batch_per_device, 3, 32, 32), device=device)
    y = f(x)
    dist.barrier(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        y = f(y)
    device_sync()
    return {"control_step_s": (time.perf_counter() - t0) / reps}


def control_step_job(n: int, batch_per_device: int = 32,
                     model: str = "resnet20", iters: int = 4,
                     reps: int = 3) -> Job:
    def merge(outs, ranks):
        return {"devices": n, "control_step_s": round(
            max(o["control_step_s"] for o in outs), 4),
            "control_step_s_per_rank": [o["control_step_s"] for o in outs]}
    return Job(control_step_rank, dict(batch_per_device=batch_per_device,
                                       model=model, iters=iters, reps=reps),
               merge)


def measure_control_step(n_devices: int, batch_per_device: int = 32,
                         model: str = "resnet20", iters: int = 4,
                         reps: int = 3, device: str = "cuda") -> dict:
    """Matched-working-set, communication-free control: each rank runs
    the same forward and backward the dense row runs, same model and
    batch a rank, the gradients kept local (the train step with its
    collectives taken out). Its efficiency drop is the sharing at the
    train step's own footprint."""
    return run_jobs([control_step_job(n_devices, batch_per_device, model,
                                      iters, reps)], n_devices, device)[0]


def efficiencies(results: List[dict], controls: Dict[int, dict],
                 step_controls: Dict[int, dict], base: dict) -> List[dict]:
    """The JAX harness's arithmetic (`bench/scaling.py:168-191` there) on
    each row of `results`, against `base` (the 1-rank eager row) and the
    controls at each row's rank count; the rows are updated and
    returned."""
    cbase = controls[base["devices"]]
    sbase = step_controls[base["devices"]]
    for r in results:
        c = controls[r["devices"]]
        s = step_controls[r["devices"]]
        raw = ((r["images_per_s"] / base["images_per_s"]) /
               (r["devices"] / base["devices"]))
        # each control's own weak-scaling efficiency at this rank count
        # (its time should stay flat; a shared card makes it grow)
        host_artifact = cbase["control_s"] / c["control_s"]
        step_artifact = sbase["control_step_s"] / s["control_step_s"]
        r["control_gflops_s"] = c["control_gflops_s"]
        r["scaling_efficiency_vs_1dev"] = round(raw, 3)
        r["host_artifact_efficiency"] = round(host_artifact, 3)
        r["step_control_artifact_efficiency"] = round(step_artifact, 3)
        # the efficiency with the sharing divided out: ~1.0 means the
        # sharded program itself adds no overhead
        r["corrected_efficiency"] = round(raw / max(step_artifact, 1e-9), 3)
        r["corrected_efficiency_matmul_ctl"] = round(
            raw / max(host_artifact, 1e-9), 3)
    return results


def rank_jobs(n: int, admm: bool, steps: int, device: str) -> List[Job]:
    """At n ranks: the matmul control, the step control, `train_model`;
    at one rank also its eager run (the base)."""
    jobs = [control_job(n), control_step_job(n),
            train_job(n, steps=steps, admm=admm, device=device)]
    if n == 1:
        jobs.append(train_job(1, steps=steps, admm=admm, eager=True,
                              device=device))
    return jobs


def main(argv=None) -> list:
    argv = list(argv if argv is not None else sys.argv[1:])
    # --dense: the X-step alone, the batch weak-scaled
    admm = "--dense" not in argv
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    ns = [int(a) for a in argv if not a.startswith("-")] or [1, 2, 4, 8]
    if 1 not in ns:
        ns = [1] + ns  # the eager base must be measured
    steps = 16 if not admm else 4
    controls, step_controls, results = {}, {}, []
    for n in ns:
        rows = run_jobs(rank_jobs(n, admm, steps, device), n, device)
        controls[n], step_controls[n] = rows[0], rows[1]
        results.extend(rows[2:])
    base = next(r for r in results
                if r["devices"] == 1 and r["route"] == "eager")
    results = efficiencies(results, controls, step_controls, base)
    for r in results:
        print(json.dumps(r), flush=True)
    return results


if __name__ == "__main__":
    main()
