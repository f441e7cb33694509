#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the root of a checkout: `python3 chip_smoke.py [--seed N]`.
It imports the port, torch, numpy and the standard library only, and
prints one JSON line per phase:

1. device  — the card's name, count and power limit;
2. build   — compiles every CUDA kernel of the main path from `csrc/`;
3. kernel  — each kernel at the main path's shapes (inputs from --seed)
   against its plain PyTorch version on the card, with its time, the
   plain version's, a library yardstick's and the card's bound;
4. main    — ResNet32 Tucker-2 @3x at full width and batch 256: ADMM
   (first projection + 2 epochs x 20 steps), decompose, fine-tune 20
   steps, eval and runtime, counting the kernels' launches.

Then the kernel summary, the card's `nvidia-smi` name and power limit,
and last the line {"ok": true, "device": {...}}. Any failure exits
non-zero before that line; without CUDA it exits 1 and prints nothing.
"""

import faulthandler
import sys

# a hang becomes a traceback and a non-zero exit
faulthandler.dump_traceback_later(900, exit=True)

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dnn_compression_tensor_admm_tpu_torch.admm import (  # noqa: E402
    admm_init, admm_update, build_program)
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.data.datasets import load_dataset  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.models import (  # noqa: E402
    compression_ratio, create_model, decompose_params)
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import build  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.precision import full_f32  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.train import (  # noqa: E402
    TrainConfig, eval_runtime, evaluate_model, train_model)

# H100 SXM peaks (NVIDIA data sheet, 700 W): float32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Z relative error: the kernel and the plain version run the same
# iteration in full float32 (the plain version turns TF32 off itself)
# and differ only in summation order (~1e-6 seen).
Z_REL_TOL = 1e-4
# ||U U^T - U' U'^T||_F: rounding differences after ~1000 dependent products.
SUBSPACE_TOL = 1e-3
SWEEPS = max(1, 6 // 3)  # admm_hooi_iters=6, as the main path runs it


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main_path_buckets():
    """(shape [L, K, O, I], r0, r1) of every Z-step bucket of the main path."""
    model = create_model("resnet32")
    program = build_program(dict(model.named_parameters()),
                            get_rank_plan("resnet32", "tk", "3"))
    out = []
    for g in program.groups:
        o, i, kh, kw = g.param_shape
        sp = g.spec.clamped(g.param_shape)
        out.append(((len(g.names), kh * kw, o, i), sp.out_rank, sp.in_rank))
    return out


def phase_kernel(seed: int, buckets):
    rng = np.random.RandomState(seed)
    rows = []
    for shape, r0, r1 in buckets:
        l, k, o, i = shape
        x_np = rng.standard_normal(shape).astype(np.float32)
        x = torch.from_numpy(x_np / np.float32(np.sqrt(k * i))).cuda()
        u0, u1 = tk.tucker2_factors_batched(x, r0, r1, sweeps=SWEEPS)
        torch.cuda.synchronize()
        p0, p1 = tk.tucker2_factors_plain(x, r0, r1, sweeps=SWEEPS)
        z = tk.tucker2_reconstruct(x, u0, u1)
        zp = tk.tucker2_reconstruct(x, p0, p1)
        z_rel = (torch.linalg.vector_norm(z - zp)
                 / torch.linalg.vector_norm(zp)).item()
        sub0 = torch.linalg.matrix_norm(
            u0 @ u0.mT - p0 @ p0.mT).max().item()
        sub1 = torch.linalg.matrix_norm(
            u1 @ u1.mT - p1 @ p1.mT).max().item()
        max_abs = max((u0 - p0).abs().max().item(), (u1 - p1).abs().max().item())
        if not (z_rel < Z_REL_TOL and sub0 < SUBSPACE_TOL
                and sub1 < SUBSPACE_TOL):
            raise AssertionError(f"kernel disagrees with plain at {shape}: "
                                 f"z_rel={z_rel} sub=({sub0}, {sub1})")
        unf0 = x.permute(0, 2, 1, 3).reshape(l, o, k * i)
        unf1 = x.permute(0, 3, 1, 2).reshape(l, i, k * o)

        def library():
            torch.linalg.svd(unf0, full_matrices=False)
            torch.linalg.svd(unf1, full_matrices=False)

        kernel_ms = cuda_ms(
            lambda: tk.tucker2_factors_batched(x, r0, r1, sweeps=SWEEPS), 50)
        plain_ms = cuda_ms(
            lambda: tk.tucker2_factors_plain(x, r0, r1, sweeps=SWEEPS), 5, 1)
        library_ms = cuda_ms(library, 5, 1)
        flops = tk.factor_flops(shape, r0, r1, sweeps=SWEEPS)
        nbytes = 4 * (l * k * o * i + l * o * r0 + l * i * r1)
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
        row = {"phase": "kernel", "name": "tucker2_factors_batched",
               "shape_LKOI": list(shape), "ranks": [r0, r1],
               "z_rel_err": z_rel, "z_rel_tol": Z_REL_TOL,
               "subspace_err": [sub0, sub1], "subspace_tol": SUBSPACE_TOL,
               "max_abs_err": max_abs, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms,
               "library_ms_hosvd_only_svd_of_both_unfoldings": library_ms,
               "flops": flops, "bytes": nbytes,
               "bound_us": 1e6 * max(t_ops, t_bytes), "ops_us": 1e6 * t_ops,
               "bytes_us": 1e6 * t_bytes,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        emit(row)
        rows.append(row)
    return rows


def check_full_rank_layer(dense, compressed) -> float:
    """A full-rank Tucker-2 layer (layer1.0.conv1, 16/16) must reproduce the
    dense conv on a small input in full float32 (cuDNN's TF32 alone would
    put the two 3e-4 apart)."""
    x = torch.randn(2, 16, 8, 8, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad(), full_f32():
        ref = dense.layer1[0].conv1(x)
        out = compressed.layer1[0].conv1(x)
    rel = (torch.linalg.vector_norm(out - ref)
           / torch.linalg.vector_norm(ref)).item()
    if not rel < 1e-4:
        raise AssertionError(f"full-rank TK layer differs from dense: {rel}")
    return rel


def check_projection_quality(model):
    """On the trained weights, the kernel route's Z must fit W as well as
    the 'subspace' route's (the JAX package's criterion, within 0.02)."""
    params = dict(model.named_parameters())
    program = build_program(params, get_rank_plan("resnet32", "tk", "3"))
    state = admm_init(params, program)
    errs = {}
    for method in ("kernel", "subspace"):
        new, _ = admm_update(params, state, program, update_u=False,
                             method=method, n_iter=6)
        num = sum(torch.sum((new.z[n] - params[n].detach()) ** 2)
                  for n in program.names)
        den = sum(torch.sum(params[n].detach() ** 2) for n in program.names)
        errs[method] = (num / den).sqrt().item()
    if not errs["kernel"] <= errs["subspace"] + 0.02:
        raise AssertionError(f"kernel projection worse than subspace: {errs}")
    return errs


def phase_main(seed: int, card: str, num_buckets: int, workdir: str):
    common = dict(dataset="synthetic-cifar10", batch_size=256,
                  steps_per_epoch=20, lr=0.1, smoothing=0.1,
                  compute_dtype="bfloat16", seed=seed, device="cuda",
                  print_fn=log)  # per-epoch rows go to stderr
    admm_cfg = TrainConfig(model="resnet32", epochs=2, admm=True, rho=1e-3,
                           ratio="3", admm_method="kernel",
                           admm_hooi_iters=6,
                           log_path=f"{workdir}/admm.log", **common)
    tk.tucker2_factors_batched.launches = 0
    t0 = time.perf_counter()
    dense, hist = train_model(admm_cfg)
    torch.cuda.synchronize()
    admm_s = time.perf_counter() - t0
    launches = tk.tucker2_factors_batched.launches
    z_steps = 1 + admm_cfg.epochs
    if launches != z_steps * num_buckets:
        raise AssertionError(f"kernel launched {launches} times, expected "
                             f"{z_steps} Z-steps x {num_buckets} buckets")

    plan = get_rank_plan("tkc_resnet32", "tk", "3")
    t0 = time.perf_counter()
    sd = decompose_params(dense.state_dict(), plan)
    torch.cuda.synchronize()
    decompose_s = time.perf_counter() - t0
    compressed = create_model("tkc_resnet32", ratio="3")
    compressed.load_state_dict(sd)
    ratio = compression_ratio(dense, compressed)
    if round(ratio, 2) != 2.83:
        raise AssertionError(f"compression ratio {ratio}, expected 2.83")

    ft_cfg = TrainConfig(model="tkc_resnet32", epochs=1, ratio="3", **common)
    ft, ft_hist = train_model(ft_cfg, init_state_dict=sd)
    x_va, y_va, info = load_dataset("synthetic-cifar10", False)
    ev = evaluate_model(ft, x_va, y_va, info, compute_dtype="bfloat16")
    rt = eval_runtime(ft, info, batch_size=256, compute_dtype="bfloat16")
    with torch.no_grad():
        logits = ft.eval()(torch.zeros(4, 3, 32, 32, device="cuda"))
    if tuple(logits.shape) != (4, 10) or not torch.isfinite(logits).all():
        raise AssertionError(f"bad logits {tuple(logits.shape)}")

    losses = ([h["train_loss"] for h in hist + ft_hist]
              + [h["test_loss"] for h in hist + ft_hist] + [ev["loss"]])
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss in {losses}")
    full_rank_rel = check_full_rank_layer(dense, compressed.cuda())
    proj = check_projection_quality(dense)
    last = hist[-1]
    steps = admm_cfg.steps_per_epoch
    emit({"phase": "main", "card": card, "model": "resnet32 tk@3x",
          "batch": 256, "admm_epochs": admm_cfg.epochs,
          "steps_per_epoch": steps, "z_steps": z_steps,
          "kernel_launches": launches, "buckets_routed": num_buckets,
          "admm_it_per_s": steps / last["epoch_time_s"],
          "admm_x_step_it_per_s": steps / last["x_step_s"],
          "z_step_ms": 1000 * last["z_step_s"],
          "admm_wall_s": admm_s,
          "admm_train_loss": [h["train_loss"] for h in hist],
          "admm_residual_total": [h["admm_residual_total"] for h in hist],
          "decompose_s": decompose_s, "compression_ratio": ratio,
          "finetune_it_per_s": steps / ft_hist[-1]["epoch_time_s"],
          "finetune_train_loss": ft_hist[-1]["train_loss"],
          "eval": ev, "ms_per_image": rt["ms_per_image"],
          "images_per_s": rt["images_per_s"],
          "full_rank_layer_rel_err": full_rank_rel,
          "projection_rel_err": proj})
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this check needs the card")
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "name": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    info = build.build("tucker2_factors")
    lib = tk._library()
    buckets = main_path_buckets()
    for shape, r0, r1 in buckets:
        planned = lib.tucker2_factors_smem_bytes(shape[2], shape[3], r0, r1)
        if planned != tk.smem_bytes(shape[2], shape[3], r0, r1):
            raise AssertionError(f"shared-memory plans differ at {shape}")
        if not tk.kernel_supported(shape, r0, r1):
            raise AssertionError(f"main-path bucket {shape} fails the gate")
    emit({"phase": "build", "kernel": "tucker2_factors",
          "build_seconds": info["seconds"],
          "compiler_output": info["compiler_output"].splitlines(),
          "buckets": [[list(s), r0, r1, tk.smem_bytes(s[2], s[3], r0, r1)]
                      for s, r0, r1 in buckets]})

    rows = phase_kernel(args.seed, buckets)
    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_main(args.seed, smi, len(buckets), workdir)

    emit({"kernels": [{
        "name": "tucker2_factors_batched", "route": "cuda",
        "source": "dnn_compression_tensor_admm_tpu_torch/csrc/tucker2_factors.cu",
        "replaces": "dnn_compression_tensor_admm_tpu/ops/pallas/tucker_kernel.py:142",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # per Z-step: the sum over the main path's buckets
        "ms": sum(r["kernel_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_us"] for r in rows) / 1000,
        "bound_by": ("operations" if sum(r["ops_us"] for r in rows)
                     >= sum(r["bytes_us"] for r in rows) else "bytes"),
        "library_ms": sum(r["library_ms_hosvd_only_svd_of_both_unfoldings"]
                          for r in rows)}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
