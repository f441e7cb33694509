#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the root of a checkout: `python3 chip_smoke.py [--seed N]`.
It imports the port, torch, numpy and the standard library only, and
prints one JSON line per phase:

1. device  — the card's name, count and power limit;
2. build   — compiles the CUDA kernels from `csrc/` (the Tucker-2 block
   plans and its workspace plan, the subspace block plans and its
   workspace plan: four nvcc processes at once) and checks each compiled
   shared-memory plan (and each workspace, and each workspace plan's
   cluster size) against the Python gate at every main-path, near-cap and
   extra workspace shape; it prints how many clusters of each DeiT TT
   workspace launch the card holds at once and fails if a launch that
   fits the card (L x C <= 132 SMs) cannot hold all its L;
3. kernel  — each kernel at its main paths' shapes (inputs from --seed)
   against its plain PyTorch version on the card, with its time, the
   plain version's, a library yardstick's and the card's bound (the
   function's least work: a singular subspace's for a subspace launch or
   a K = 1 Tucker-2 bucket, HOOI's for K > 1): the Tucker-2 factor kernel at the 5 buckets of ResNet32-TK@3x and the 4 of
   DeiT-tiny-TK@2x (all 4 in the workspace plan, one thread-block
   cluster per layer: its size and how many such clusters the card holds
   at once are printed), each also at sweeps=0
   (`hosvd_ms`: the Grams of X and the HOSVD init), and untimed at two
   workspace-plan buckets of other plans (ResNet50 TK 3, DenseNet40 TK
   2), the
   subspace kernel at the 24 launches of a ResNet32-TT@3x Z-step and at
   the 33 of a DeiT-tiny-TT@2x Z-step (13 of them in the workspace
   plan, one thread-block cluster per layer, printed as for Tucker-2),
   each also at iters=0 (`gram_ms`: the Gram, the identity start
   and the lift), the Tucker-2 kernel at the 16 buckets of
   MobileNetV2-CIFAR-SVD@2x (plain SVD of 1x1 convs as K = 1 at
   r0 = r1: 4 resident, 1 streamed, 11 workspace), each beside
   `torch.linalg.svd` of the same [L, O, I] stack and both rank-r fits,
   and both kernels at two shapes near a block's
   shared-memory limit, which take the Tucker-2 kernel's streamed plan
   and the subspace kernel's unpadded plan; then both kernels at
   ImageNet ResNet-50's shapes: the subspace kernel at the 27 launches of
   a ResNet-50-TT@3x Z-step (14 in the workspace plan, up to r = 130; the
   block plans up to 73,728 columns; the sweep's 9 full-rank steps launch
   nothing) and the Tucker-2 kernel at the 15 buckets of ResNet-50-TK@3x
   (K = 9 and K = 1; 13 in the workspace plan), then one whole Z/U step
   of the TK@3x plan from a seeded dense init (15 launches asserted);
   then the subspace kernel at the 24 launches of a DeiT-small-TT@2x
   Z-step (16 in the workspace plan, r = 256 and 320 among them, at 89
   to 91% of full rank); then CIFAR ResNet56's 10 TK@3x buckets (all in
   the resident plan, one full rank in both modes) and 18 TT@3x launches,
   and for each plan one Z-step (`admm_update`) on layers of exactly the
   plan's ranks, which must come back within 1e-3 with the finite guard
   at 0, every launch held against the plain version there too; then the
   zoo: the Tucker-2 kernel at the 15 buckets of ImageNet
   MobileNetV2-SVD@2x (the ninth path's), the 21 of MobileNetV2-TK@2x, the
   9 of VGG16-TK@2x (`pre_logits.fc1` [1, 49, 4096, 512] at 256/288 among
   them, timed by single launches), the 4 of DenseNet121-TK@2x, the 38
   one-layer buckets of DenseNet40-TK@2x and the 4 `svd_linear` buckets of
   DeiT-tiny's automatic SVD@2 plan, the subspace kernel at the 21
   launches of MobileNetV2-TT@2x, each plan also through one whole Z/U
   step from a seeded dense init (its launches counted); then the Stiefel
   fine-tune: `stftkc_resnet32` from ResNet32's decomposed TK@3x weights,
   20 steps at batch 256 with Riemannian SGD on its factors, each of which
   must stay orthonormal within 1e-4;
   kernel times are device times (launches captured in a CUDA graph and
   replayed);
4. main    — ResNet32 Tucker-2 @3x and ResNet32 Tensor-Train @3x, each at
   full width and batch 256, then DeiT-tiny Tensor-Train @2x and
   DeiT-tiny Tucker-2 @2x, each at full width (embed 192, depth 12,
   224 x 224, 1000 classes) and batch 128 with AdamW, then
   MobileNetV2-CIFAR plain SVD @2x at full width and batch 256 (its 28
   1x1 convs in 16 Tucker-2 launches a Z-step; parameter counts
   asserted), then ImageNet ResNet-50 Tensor-Train @3x (general) at full
   width, 224 x 224, 1000 classes and batch 256 with SGD momentum, lr 0.1
   after a one-epoch warmup and gradients clipped at global norm 1.0 (34
   TT convs in 27 subspace launches a Z-step; parameter counts
   asserted), each path with its own wall time: ADMM (first
   projection + 2 epochs x 20 steps), decompose,
   fine-tune 20 steps, eval and runtime, counting both kernels' launches
   (on the card the Z-step raises where a kernel's gate refuses a
   bucket, so every bucket goes through a kernel); then DeiT-small
   Tensor-Train @2x (embed 384, 6 heads) as `results/run_deit_small.sh`
   runs it, cut to 7 ADMM epochs x 10 steps with the late rho boost at the
   last (192 launches asserted), the dense model written to a msgpack,
   then the CLI's `--decompose` from that file with hard distillation from
   the dense teacher read from it too (1.53x and the parameter counts
   asserted), eval, and the subspace kernel against its plain version at
   every launch of a Z-step on the trained weights; last CIFAR ResNet56
   Tucker-2 @3x as the JAX package's CIFAR recipes run it: ADMM with a
   checkpoint after each epoch, stopped after epoch 2 and resumed through
   the CLI for epoch 3 with `--save-model` (a msgpack), the checkpoint
   read back bit for bit, the resumed run held against the same 3 epochs
   uninterrupted (the same lr at every step, step counter and generator
   states; Z, U and the weights within RESUME_TOL), then `--decompose
   --model-path` of the msgpack into `tkc_resnet56` (3.10x, 853,018 /
   275,266 parameters asserted) and 2 x 10 fine-tune steps at lr 0.003
   with `--ema-decay 0.999 --sched step --opt sgd`, evaluated raw and as
   the EMA (40 Tucker-2 launches asserted), and both kernels against their
   plain versions at every launch of a TK and a TT Z-step on its trained
   weights; then ImageNet MobileNetV2 plain SVD @2x at full width, 224 x
   224, 1000 classes and batch 256 with SGD momentum at lr 0.05 (its 29
   1x1 convs in 15 Tucker-2 launches a Z-step; 3,504,872 / 2,514,184
   parameters and 1.39x asserted), fine-tuned at lr 0.01; last DeiT-tiny
   Tensor-Train @2x as `run.sh`'s `deit-tiny-tt-admm` runs it, through
   the CLI (`phase_deit_recipe`): `synthetic-imagenet` written as DCTA
   shards (512 train, 128 val images) by the port's `write_shards`, ADMM
   streamed from them by the native loader (4 threads, pinned buffers,
   two batches in flight) with AdamW lr 5e-4, a cosine after a one-epoch
   warmup, Mixup 0.8, CutMix 1.0 and smoothing 0.1, the first epoch
   traced (`--profile-dir`: the device's idle share and its ten longest
   ops are printed) and `--save-model`; then `--decompose` of that
   msgpack (1.88x asserted) and 20 fine-tune steps from the shards read
   whole (`--shard-cache hbm`) with RandAugment m9, RandomErasing 0.25
   and 3 repeated views over a shuffled copy, eval on the val shards and
   `--flops`; 99 subspace launches asserted (33 a Z-step), every step's
   batch of the config's shapes and the shards' labels, each mixed target
   row summing to 1 within MIX_ROW_TOL. Every synthetic CIFAR set is made
   once and shared by the CIFAR phases (`shared_cifar_sets`);
5. nlp     — the BERT subsystem's three subcommands through
   `nlp.cli.main` at the JAX CLI's defaults (BERT-base, sequence 128,
   batch 32, TT@2x linears, SVD@4.5x word embedding; see NLP): ms a step
   by stage, tokens/s, peak device memory, the parameter counts asserted
   equal to the JAX package's (NLP_PARAMS), finite losses, the dev
   accuracy, SQuAD's EM/F1 and both prediction files, then
   `factorize_encoder` of the fine-tuned teacher's 144 blocks, timed,
   with its fit;
6. export  — the fine-tuned models of three main paths (ResNet32 TK@3x,
   ResNet-50 TT@3x, DeiT-tiny TT@2x; `phase_main` writes each as the JAX
   msgpack, as --save-model does) through the CLI's `--pretrained
   --export-onnx --export`: the ONNX file run on the card at batch 1 by
   the runner below (`run_onnx`: a protobuf reader and the exporter's
   opset-13 ops as torch ops, float32 with TF32 off) against the model's
   float32 forward within rtol = atol = 2e-3, the torch.export program
   read back (`load_exported`) against the eager forward within 1e-5
   relative, and the weights written as a reference-named `.pth`
   (`state_dict_to_torch`) evaluated through `--pretrained --eval` to the
   msgpack's numbers exactly; then an ONNX export of ImageNet MobileNetV2,
   which must be refused, and the TT-LSTM latency demo at the JAX
   package's defaults. The phase must take under 60 s.

Then the script's wall time, earlier CUDA versions' times as PERF.md
records them (on a line of their own), the kernel summary, the card's
`nvidia-smi` name and power limit, and last the line
{"ok": true, "device": {...}}. Any failure exits non-zero before that
line; without CUDA it exits 1 and prints nothing.
"""

import faulthandler
import sys

if __name__ == "__main__":
    # a hang becomes a traceback and a non-zero exit
    faulthandler.dump_traceback_later(900, exit=True)

import argparse  # noqa: E402
import concurrent.futures  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.optim.optimizer import register_optimizer_step_post_hook  # noqa: E402

from dnn_compression_tensor_admm_tpu_torch.admm import (  # noqa: E402
    AdmmState, admm_init, admm_update, build_program, tk_ranks)
from dnn_compression_tensor_admm_tpu_torch.cli.main import main as cli_main  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.configs import get_rank_plan  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.data.datasets import load_dataset  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.models import (  # noqa: E402
    compression_ratio, count_params, create_model, decompose_params)
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import build  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import subspace_kernel as sk  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.cuda import tucker_kernel as tk  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.precision import full_f32  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.ttd import clamp_tt_ranks, tt_project  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.ops.tucker import tucker2_project  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.train import (  # noqa: E402
    TrainConfig, eval_runtime, evaluate_model, train_model)
from dnn_compression_tensor_admm_tpu_torch.train.optim import make_schedule  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.train.state import (  # noqa: E402
    CHECKPOINT_NAME, TrainState, load_train_state, save_train_state)
from dnn_compression_tensor_admm_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_any_variables, save_variables)
from dnn_compression_tensor_admm_tpu_torch.utils.jax_weights import (  # noqa: E402
    jax_to_state_dict, state_dict_to_jax)
from dnn_compression_tensor_admm_tpu_torch.nlp import bert as nlp_bert  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.nlp import shared_tucker  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.nlp.cli import main as nlp_main  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_variables)
from dnn_compression_tensor_admm_tpu_torch.analysis import (  # noqa: E402
    tt_lstm_inference_demo)
from dnn_compression_tensor_admm_tpu_torch.utils.export import load_exported  # noqa: E402
from dnn_compression_tensor_admm_tpu_torch.utils.onnx_export import (  # noqa: E402
    export_onnx, onnx_attrs, pb_fields)
from dnn_compression_tensor_admm_tpu_torch.utils.torch_import import (  # noqa: E402
    save_torch_state_dict, state_dict_to_torch)

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
# The subspace kernel against its plain version: ||Q Q^T - P P^T||_F below
# 1e-3 (the same float32 iteration, 8 x 12 dependent Newton-Schulz steps,
# summed in another order), and Q Q^T t against P P^T t within 1e-4
# relative (what the TT sweep carries on; a few 1e-7 on the CPU against
# the Pallas kernel).
TT_PROJ_TOL = 1e-3
TT_REL_TOL = 1e-4
TT_ITERS = max(8, 6)  # iters = max(8, admm_hooi_iters), as the Z-step runs it
# Launches near a block's 227 KB that take the subspace kernel's unpadded
# plan (scalar products, the lift from L2), wide and tall; not on the main
# path, so outside its per-Z-step sums.
NEAR_CAP_LAUNCHES = [((2, 193, 197), 33), ((2, 197, 193), 33)]
# Tucker-2 buckets near a block's 227 KB whose X does not fit in shared
# memory: the streamed plan (X_k through chunk buffers, scalar products);
# not on the main path, so outside its per-Z-step sums.
NEAR_CAP_BUCKETS = [((2, 9, 144, 144), 40, 40), ((2, 9, 160, 96), 40, 30)]
# Tucker-2 buckets of other plans that the Pallas gate takes and that take
# the workspace plan: ResNet50 TK 3's largest (layer3's 3 x 3 convs) and
# DenseNet40 TK 2's largest (a 3 x 3 conv of the last dense block); not
# on a main path, so outside its per-Z-step sums.
WS_EXTRA_BUCKETS = [((6, 9, 256, 256), 64, 64), ((1, 9, 16, 328), 8, 75)]
# A Tucker-2 workspace-plan launch does 0.1 to 10 G FMA a layer on a
# cluster of 8 SMs, 2 to 26 ms (DeiT TK, MobileNetV2 SVD): fewer launches
# per graph keep its timing to seconds. Block-plan launches take
# graph_ms's default.
TK_WS_GRAPH = {"launches": 5, "replays": 2}
# MobileNetV2-CIFAR SVD@2x's parameter counts, dense and compressed (the
# JAX package's)
MBV2_PARAMS = (2_237_770, 1_289_754)
# ImageNet ResNet-50 TT@3x (general)'s, the JAX package's too (2.509x)
R50_TT_PARAMS = (25_557_032, 10_187_501)
# DeiT-small TT@2x's, the JAX package's `ttm_deit_small_patch16_224` too
# (1.5322x)
DEIT_S_PARAMS = (22_050_664, 14_391_736)
# ImageNet MobileNetV2 SVD@2x's, dense and compressed, the JAX package's
# `svdc_mobilenetv2` too (1.3940x)
MBV2_INET_PARAMS = (3_504_872, 2_514_184)
# CIFAR ResNet56 TK@3x's, dense and compressed, the JAX package's
# `tkc_resnet56` too (its TT@3x has the same count; 3.0989x)
R56_PARAMS = (853_018, 275_266)
# A Z-step of a layer of exactly the plan's ranks must give the layer back:
# ||Z - W|| / ||W|| below this (the projection is exact up to float32
# rounding of ~100 dependent products)
EXACT_RANK_TOL = 1e-3
# ResNet56 TK@3x resumed after epoch 2 against the run that never stopped:
# the two take the same batches, crops, flips, lr and Z-steps (their
# generator states, step counters and lr at every step are asserted equal
# apart from this). cuDNN's convolution backward is not deterministic by
# default, so ||A - B|| / ||B|| over all parameters, all Z and all U is held
# to a bound, not to 0: on the H100 the two runs came out bit for bit (0.0;
# cuDNN picked deterministic algorithms at these shapes), where a
# nondeterministic pick would add float32 rounding, ~1e-7 of a gradient a
# step through 60 steps; a resume that dropped the momentum buffers or
# redrew the batches would move the weights by a share of an epoch's
# update at lr 0.1, far past the bound. U sums every epoch's W - Z, so its
# relative bound is 10x looser.
RESUME_TOL = {"params": 1e-3, "z": 1e-3, "u": 1e-2}
# DeiT-small TT@2x's launches near full rank (r = 256 and 320 at 89 to 91%
# of min(rows, cols), gaps sigma_r - sigma_r+1 of 1e-4 to 1e-3 of sigma_1
# on N(0, 1/cols) inputs) are held to TT_PROJ_TOL and TT_REL_TOL like every
# other launch, on those inputs and on the ADMM run's trained weights: the
# plain version summed in another order moves such a projector by 1e-4,
# and the kernel's stayed within 1.2e-4 on the H100.
# A subspace launch at r >= 256 does ~10 G FMA of Newton-Schulz a layer on
# one cluster of 8 SMs: its graphs hold 5 launches, not 25.
TT_BIG_RANK = 256
TT_BIG_GRAPH = {"launches": 5, "replays": 2}
# A Tucker-2 bucket of this many floats or more (VGG16's `pre_logits.fc1`,
# [1, 49, 4096, 512]: 102.8 M floats, a mode-0 Gram of ~842 GFLOP on one
# cluster of 8 SMs, 4.4 s a launch on the H100) is timed by one launch
# after the check's, its plain version and library yardstick by one call
# each, not by graphs.
TK_SINGLE_LAUNCH_FLOATS = 50_000_000
# Riemannian SGD keeps the Stiefel fine-tune's factors orthonormal:
# max |Q^T Q - I| on the tall side after its steps (float32 QR each step:
# ~1e-6 expected; a Euclidean step at lr 0.1 would leave ~1e-2)
STIEFEL_TOL = 1e-4

# the NLP phase's parameter counts at BERT-base width (the CLI's plan: TT@2x
# linears, SVD@4.5x word embedding) on each synthetic corpus's vocabulary
# (215, 305 and 116 entries); tests/test_torch_port_nlp_model.py takes them
# from the JAX package by `jax.eval_shape`
NLP_PARAMS = {"task_teacher": 86_208_002, "task_student": 17_454_613,
              "general_teacher": 86_275_584, "general_student": 17_468_208,
              "squad": 17_437_690}


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


def graph_ms(fn, launches: int = 25, replays: int = 4) -> float:
    """Device milliseconds per call of `fn`, a call that only launches
    kernels: `launches` calls captured in one CUDA graph, timed over
    `replays` replays, so the host's rate of issuing launches does not
    enter (a launch of the subspace kernel at iters=0 is 10 to 70 us of
    work)."""
    fn()  # builds, loads and sets the kernel's attributes outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, replays, warmup=1) / launches


def _program(fmt: str, model: str = "resnet32", ratio: str = "3"):
    """The Z-step's buckets of `model`'s plan (the model built on the meta
    device: its shapes alone)."""
    with torch.device("meta"):
        dense = create_model(model)
    return build_program(dict(dense.named_parameters()),
                         get_rank_plan(model, fmt, ratio))


def main_path_buckets(program=None):
    """(shape [L, K, O, I], r0, r1) of every Z-step bucket of a TK or SVD
    path (ResNet32-TK@3x's unless another program is given; a linear, and
    an SVD 1x1 conv at r0 = r1, as K = 1)."""
    out = []
    for g in (program or _program("tk")).groups:
        o, i, kh, kw = (*g.param_shape, 1, 1)[:4]
        sp = tk_ranks(g.spec, g.param_shape)
        out.append(((len(g.names), kh * kw, o, i), sp.out_rank, sp.in_rank))
    return out


def tt_launches(program=None):
    """(shape [L, rows, cols], r) of every subspace launch of a TT Z-step
    (ResNet32-TT@3x's unless another program is given), bucket by bucket
    in sweep order; full-rank steps do not launch."""
    program = program or _program("tt")
    return [((len(g.names), rows, cols), r) for g in program.groups
            for rows, cols, r in sk.sweep_steps(g.spec.tt_shapes,
                                                g.spec.tt_ranks)
            if r != rows]


def deit_program(fmt: str = "tt"):
    return _program(fmt, "deit_tiny_patch16_224", "2")


def deit_small_program():
    return _program("tt", "deit_small_patch16_224", "2")


def mbv2_program(fmt: str = "svd"):
    return _program(fmt, "mobilenetv2_cifar", "2")


def r50_program(fmt: str = "tt"):
    return _program(fmt, "resnet50", "3")


def tucker_input(rng, shape):
    l, k, o, i = shape
    x_np = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x_np / np.float32(np.sqrt(k * i))).cuda()


def check_tucker(x, r0, r1):
    """The kernel at x against its plain version: (max abs difference,
    Z relative error, projector errors); raises past the tolerances."""
    u0, u1 = tk.tucker2_factors_batched(x, r0, r1, sweeps=SWEEPS)
    torch.cuda.synchronize()
    p0, p1 = tk.tucker2_factors_plain(x, r0, r1, sweeps=SWEEPS)
    z = tk.tucker2_reconstruct(x, u0, u1)
    zp = tk.tucker2_reconstruct(x, p0, p1)
    z_rel = (torch.linalg.vector_norm(z - zp)
             / torch.linalg.vector_norm(zp)).item()
    sub0 = torch.linalg.matrix_norm(u0 @ u0.mT - p0 @ p0.mT).max().item()
    sub1 = torch.linalg.matrix_norm(u1 @ u1.mT - p1 @ p1.mT).max().item()
    max_abs = max((u0 - p0).abs().max().item(), (u1 - p1).abs().max().item())
    if not (z_rel < Z_REL_TOL and sub0 < SUBSPACE_TOL
            and sub1 < SUBSPACE_TOL):
        raise AssertionError(f"kernel disagrees with plain at "
                             f"{tuple(x.shape)}: z_rel={z_rel} "
                             f"sub=({sub0}, {sub1})")
    return max_abs, z_rel, [sub0, sub1]


def svd_fits(x, u0, u1, r):
    """Rank-r fits ||X - Z|| / ||X|| of a K = 1 stack x [L, 1, O, I]: the
    kernel's Z from (u0, u1) and the truncated SVD's (the optimum)."""
    with full_f32():
        u, s, vh = torch.linalg.svd(x[:, 0], full_matrices=False)
        zs = (u[..., :r] * s[:, None, :r]) @ vh[:, :r]
        zk = tk.tucker2_reconstruct(x, u0, u1)[:, 0]
    norm = torch.linalg.vector_norm(x)
    return ((torch.linalg.vector_norm(x[:, 0] - zk) / norm).item(),
            (torch.linalg.vector_norm(x[:, 0] - zs) / norm).item())


def k1_flops(shape, r0: int, r1: int) -> int:
    """Least operations of the factors of a K = 1 stack [L, 1, O, I] (2 per
    multiply-add). U0 and U1 are each layer's top-r0 left and top-r1 right
    singular subspaces: the Gram of the smaller side gives one, its product
    with X the other (U0 = X V or U1 = X^T U); the min(O, I)-square
    eigensolve is left out. The bound of a K = 1 bucket (an SVD or a
    Tucker-2 linear); `tk.factor_flops` counts the kernel's own iteration,
    which is the function itself only where K > 1 (HOOI)."""
    l, _, o, i = shape
    return l * (2 * o * i * min(o, i) + 2 * o * i * (r0 if i <= o else r1))


def subspace_least_flops(shape, r: int) -> int:
    """Least operations of the top-r left singular subspace of each layer
    of t [L, rows, cols]: the smaller side's Gram, and for a tall t the
    lift t V; the eigensolve is left out. 0 for a full-rank request, which
    does not launch; `sk.subspace_flops` counts the kernel's own
    iteration."""
    l, rows, cols = shape
    r = min(r, rows, cols)
    if r == rows:
        return 0
    lift = 2 * rows * cols * r if cols < rows else 0
    return l * (2 * rows * cols * min(rows, cols) + lift)


def phase_kernel(seed: int, buckets, path: str, extra=NEAR_CAP_BUCKETS,
                 extra_plan: str = "streamed", svd=False):
    """The Tucker-2 kernel at every bucket of a TK path's Z-step, then
    untimed at `extra`, which must take `extra_plan`; workspace-plan
    buckets are timed with TK_WS_GRAPH's launches and replays. The
    library yardstick is a batched SVD of both unfoldings (the HOSVD's),
    or with `svd` at a K = 1 bucket (an SVD 1x1 conv: r0 = r1) one
    `torch.linalg.svd` of the [L, O, I] stack, whose rank-r fit is
    printed beside the kernel's; each row also gives it as
    `library_ms`."""
    t_start = time.perf_counter()
    rng = np.random.RandomState(seed)
    rows = []
    for shape, r0, r1 in buckets:
        l, k, o, i = shape
        x = tucker_input(rng, shape)
        max_abs, z_rel, sub = check_tucker(x, r0, r1)
        fits = {}
        if svd and k == 1:
            u0, u1 = tk.tucker2_factors_batched(x, r0, r1, sweeps=SWEEPS)
            fits = dict(zip(("kernel_fit_rel_err", "svd_fit_rel_err"),
                            svd_fits(x, u0, u1, r0)))

            def library():
                torch.linalg.svd(x[:, 0], full_matrices=False)
        else:
            unf0 = x.permute(0, 2, 1, 3).reshape(l, o, k * i)
            unf1 = x.permute(0, 3, 1, 2).reshape(l, i, k * o)

            def library():
                torch.linalg.svd(unf0, full_matrices=False)
                torch.linalg.svd(unf1, full_matrices=False)

        plan = tk.plan_name(k, o, i, r0, r1)
        if plan == "workspace":  # one cluster per layer: its size, and how
            # many the card holds at once (cudaOccupancyMaxActiveClusters)
            lib = tk._ws_library()
            cluster = {"cluster": lib.tucker2_factors_ws_cluster(k, o, i, r0,
                                                                 r1),
                       "max_active_clusters":
                           lib.tucker2_factors_ws_max_clusters(k, o, i, r0,
                                                               r1)}
            if cluster["max_active_clusters"] < 1:
                raise AssertionError(f"{shape}: no cluster of the workspace "
                                     f"plan fits the card: {cluster}")
        else:
            cluster = {}
        single = l * k * o * i >= TK_SINGLE_LAUNCH_FLOATS
        if single:  # seconds a launch: one timed launch, the check's
            # launch above its warm-up (the plain version's too)
            timing = {"launches": 1}
            timed = lambda fn: cuda_ms(fn, 1, 0)  # noqa: E731
        else:
            timing = TK_WS_GRAPH if plan == "workspace" else {}
            timed = lambda fn: graph_ms(fn, **timing)  # noqa: E731
        kernel_ms = timed(
            lambda: tk.tucker2_factors_batched(x, r0, r1, sweeps=SWEEPS))
        # the same launch without the HOOI sweeps: the Grams of X and the
        # HOSVD init
        hosvd_ms = timed(
            lambda: tk.tucker2_factors_batched(x, r0, r1, sweeps=0))
        iters, warmup = (1, 0) if single else (5, 1)
        plain_ms = cuda_ms(
            lambda: tk.tucker2_factors_plain(x, r0, r1, sweeps=SWEEPS),
            iters, warmup)
        library_ms = cuda_ms(library, iters, warmup)
        algorithm_flops = tk.factor_flops(shape, r0, r1, sweeps=SWEEPS)
        flops = k1_flops(shape, r0, r1) if k == 1 else algorithm_flops
        nbytes = 4 * (l * k * o * i + l * o * r0 + l * i * r1)
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
        library_key = ("library_ms_batched_svd" if svd and k == 1 else
                       "library_ms_hosvd_only_svd_of_both_unfoldings")
        row = {"phase": "kernel", "name": "tucker2_factors_batched",
               "path": path, "shape_LKOI": list(shape), "ranks": [r0, r1],
               "plan": plan, **cluster,
               "timed_by": ("single launches" if single else
                            f"graphs of {timing.get('launches', 25)}"),
               "z_rel_err": z_rel, "z_rel_tol": Z_REL_TOL,
               "subspace_err": sub, "subspace_tol": SUBSPACE_TOL,
               "max_abs_err": max_abs, "kernel_ms": kernel_ms,
               "hosvd_ms": hosvd_ms, "plain_ms": plain_ms,
               library_key: library_ms, "library_ms": library_ms, **fits,
               "flops": flops, "algorithm_flops": algorithm_flops,
               "bytes": nbytes,
               "bound_us": 1e6 * max(t_ops, t_bytes), "ops_us": 1e6 * t_ops,
               "bytes_us": 1e6 * t_bytes,
               "bound_share": 1e3 * max(t_ops, t_bytes) / kernel_ms,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        emit(row)
        rows.append(row)
    for shape, r0, r1 in extra:
        _, k, o, i = shape
        if (tk.plan_name(k, o, i, r0, r1) != extra_plan
                or not tk.kernel_supported(shape, r0, r1)):
            raise AssertionError(f"{shape} {r0}/{r1} does not take the "
                                 f"{extra_plan} plan")
        x = tucker_input(rng, shape)
        max_abs, z_rel, sub = check_tucker(x, r0, r1)
        row = {"phase": "kernel", "name": "tucker2_factors_batched",
               "plan": extra_plan, "shape_LKOI": list(shape),
               "ranks": [r0, r1], "z_rel_err": z_rel, "z_rel_tol": Z_REL_TOL,
               "subspace_err": sub, "subspace_tol": SUBSPACE_TOL,
               "max_abs_err": max_abs}
        if extra_plan == "streamed":
            row["kernel_ms"] = graph_ms(lambda: tk.tucker2_factors_batched(
                x, r0, r1, sweeps=SWEEPS))
        emit(row)
    emit({"phase": "kernel_wall", "name": "tucker2_factors_batched",
          "path": path, "buckets": len(buckets),
          "wall_s": time.perf_counter() - t_start})
    return rows


def check_subspace(t, r):
    """The kernel at t against its plain version: (max abs difference,
    projector error, QQ^T t relative error); raises past the tolerances."""
    q = sk.dominant_left_subspace_batched(t, r, iters=TT_ITERS)
    torch.cuda.synchronize()
    p = sk.dominant_left_subspace_plain(t, r, iters=TT_ITERS)
    with full_f32():
        proj = torch.linalg.matrix_norm(q @ q.mT - p @ p.mT).max().item()
        zq, zp = q @ (q.mT @ t), p @ (p.mT @ t)
    rel = (torch.linalg.vector_norm(zq - zp)
           / torch.linalg.vector_norm(zp)).item()
    if not (proj < TT_PROJ_TOL and rel < TT_REL_TOL):
        raise AssertionError(f"subspace kernel disagrees with plain at "
                             f"{tuple(t.shape)} r={r}: proj={proj} rel={rel}")
    return (q - p).abs().max().item(), proj, rel


def phase_kernel_tt(seed: int, launches, program, path: str,
                    near_cap=NEAR_CAP_LAUNCHES):
    """The subspace kernel at every launch of `program`'s Z-step, then at
    `near_cap`, then the whole TT sweep of one Z-step."""
    t_start = time.perf_counter()
    rng = np.random.RandomState(seed)
    rows_out = []
    for shape, r in launches:
        l, rows, cols = shape
        t_np = rng.standard_normal(shape).astype(np.float32)
        t = torch.from_numpy(t_np / np.float32(np.sqrt(cols))).cuda()
        max_abs, proj, rel = check_subspace(t, r)
        plan = sk.plan_name(rows, cols, r)
        if plan == "workspace":  # one cluster per layer: its size, and how
            # many the card holds at once (cudaOccupancyMaxActiveClusters)
            lib = sk._ws_library()
            cluster = {"cluster": lib.subspace_ws_cluster(),
                       "max_active_clusters":
                           lib.subspace_ws_max_clusters(rows, cols, r)}
        else:
            cluster = {}
        per_rank = TT_BIG_GRAPH if r >= TT_BIG_RANK else {}
        kernel_ms = graph_ms(
            lambda: sk.dominant_left_subspace_batched(t, r, iters=TT_ITERS),
            **per_rank)
        # the same launch without the iteration: the Gram, the identity
        # start and, in the tall case, the lift
        gram_ms = graph_ms(
            lambda: sk.dominant_left_subspace_batched(t, r, iters=0),
            **per_rank)
        plain_ms = cuda_ms(
            lambda: sk.dominant_left_subspace_plain(t, r, iters=TT_ITERS), 5, 1)
        library_ms = cuda_ms(
            lambda: torch.linalg.svd(t, full_matrices=False), 5, 1)
        algorithm_flops = sk.subspace_flops(shape, r, iters=TT_ITERS)
        flops = subspace_least_flops(shape, r)
        nbytes = 4 * (l * rows * cols + l * rows * r)
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
        row = {"phase": "kernel", "name": "dominant_left_subspace_batched",
               "path": path, "plan": plan, **cluster,
               "shape_L_rows_cols": list(shape), "rank": r,
               "projector_err": proj, "projector_tol": TT_PROJ_TOL,
               "projected_rel_err": rel, "projected_rel_tol": TT_REL_TOL,
               "graph_launches": per_rank.get("launches", 25),
               "max_abs_err": max_abs, "kernel_ms": kernel_ms,
               "gram_ms": gram_ms, "plain_ms": plain_ms,
               "library_ms_batched_svd": library_ms,
               "flops": flops, "algorithm_flops": algorithm_flops,
               "bytes": nbytes,
               "bound_us": 1e6 * max(t_ops, t_bytes), "ops_us": 1e6 * t_ops,
               "bytes_us": 1e6 * t_bytes,
               "bound_share": 1e3 * max(t_ops, t_bytes) / kernel_ms,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        emit(row)
        rows_out.append(row)
    for shape, r in near_cap:
        l, rows, cols = shape
        if sk.padded_plan(rows, cols, r) or not sk.subspace_supported(shape, r):
            raise AssertionError(f"{shape} r={r} does not take the unpadded plan")
        t_np = rng.standard_normal(shape).astype(np.float32)
        t = torch.from_numpy(t_np / np.float32(np.sqrt(cols))).cuda()
        max_abs, proj, rel = check_subspace(t, r)
        emit({"phase": "kernel", "name": "dominant_left_subspace_batched",
              "plan": "unpadded", "shape_L_rows_cols": list(shape), "rank": r,
              "projector_err": proj, "projector_tol": TT_PROJ_TOL,
              "projected_rel_err": rel, "projected_rel_tol": TT_REL_TOL,
              "max_abs_err": max_abs,
              "kernel_ms": graph_ms(lambda: sk.dominant_left_subspace_batched(
                  t, r, iters=TT_ITERS))})
    # the whole batched TT-SVD sweep (kernel, residuals, reconstruction) of
    # one Z-step, bucket by bucket on random weights
    xs = []
    for g in program.groups:
        numel = int(np.prod(g.param_shape))
        x = rng.standard_normal((len(g.names), numel)).astype(np.float32)
        xs.append((torch.from_numpy(x).cuda(), g.spec))
    sweep_ms = cuda_ms(lambda: [
        sk.tt_project_batched(x, sp.tt_shapes, sp.tt_ranks, iters=TT_ITERS)
        for x, sp in xs], 10)
    emit({"phase": "kernel", "name": "tt_project_batched", "path": path,
          "buckets": len(xs), "ms_per_z_step": sweep_ms})
    emit({"phase": "kernel_wall", "name": "dominant_left_subspace_batched",
          "path": path, "launches": len(launches),
          "wall_s": time.perf_counter() - t_start})
    return rows_out


def check_full_rank_layer(dense, compressed) -> float:
    """A full-rank layer (layer1.0.conv1: Tucker-2 16/16, or TT ranks
    [1, 16, 16, 1]) must reproduce the dense conv on a small input in full
    float32 (cuDNN's TF32 alone would put the two 3e-4 apart)."""
    x = torch.randn(2, 16, 8, 8, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad(), full_f32():
        ref = dense.layer1[0].conv1(x)
        out = compressed.layer1[0].conv1(x)
    rel = (torch.linalg.vector_norm(out - ref)
           / torch.linalg.vector_norm(ref)).item()
    if not rel < 1e-4:
        raise AssertionError(f"full-rank layer differs from dense: {rel}")
    return rel


def check_projection_quality(model, name: str, fmt: str, ratio: str,
                             kernel_z=None):
    """On the trained weights, the kernel route's Z must fit W as well as
    the 'subspace' route's (the JAX package's criterion, within 0.02).
    `kernel_z`: the kernel route's Z of W, where the caller has it."""
    params = dict(model.named_parameters())
    program = build_program(params, get_rank_plan(name, fmt, ratio))
    state = admm_init(params, program)
    errs = {}
    for method in ("kernel", "subspace"):
        if method == "kernel" and kernel_z is not None:
            z = kernel_z
        else:
            z = admm_update(params, state, program, update_u=False,
                            method=method, n_iter=6)[0].z
        num = sum(torch.sum((z[n] - params[n].detach()) ** 2)
                  for n in program.names)
        den = sum(torch.sum(params[n].detach() ** 2) for n in program.names)
        errs[method] = (num / den).sqrt().item()
    if not errs["kernel"] <= errs["subspace"] + 0.02:
        raise AssertionError(f"kernel projection worse than subspace: {errs}")
    return errs


def phase_zstep(seed: int, model: str, fmt: str, ratio: str,
                launches_per_z_step: int):
    """One whole Z/U step of `model`'s plan on the card, kernel route,
    from a seeded dense init: the Tucker-2 kernel (a TK or SVD plan) or the
    subspace kernel (a TT plan) must launch once a bucket (a sweep step)
    and the other kernel never; then the fit against the 'subspace'
    route's."""
    t_start = time.perf_counter()
    dense = create_model(model, generator=torch.Generator().manual_seed(seed))
    dense.cuda()
    params = dict(dense.named_parameters())
    program = build_program(params, get_rank_plan(model, fmt, ratio))
    state = admm_init(params, program)
    kernel, other_kernel = ((sk.dominant_left_subspace_batched,
                             tk.tucker2_factors_batched) if fmt == "tt" else
                            (tk.tucker2_factors_batched,
                             sk.dominant_left_subspace_batched))
    kernel.launches = other_kernel.launches = 0
    t0 = time.perf_counter()
    state, residuals = admm_update(params, state, program, update_u=True,
                                   method="kernel", n_iter=6)
    torch.cuda.synchronize()
    z_step_ms = 1000 * (time.perf_counter() - t0)
    launches, other = kernel.launches, other_kernel.launches
    if launches != launches_per_z_step or other != 0:
        raise AssertionError(f"{model} {fmt}@{ratio}x Z-step: the kernel "
                             f"launched {launches} times (expected "
                             f"{launches_per_z_step}), the other {other}")
    if int(state.nonfinite) != 0 or not all(
            bool(torch.isfinite(state.z[n]).all()) for n in program.names):
        raise AssertionError(f"{model} Z-step: non-finite Z")
    # from U = 0 the step's Z is the kernel route's projection of W
    proj = check_projection_quality(dense, model, fmt, ratio,
                                    kernel_z=state.z)
    emit({"phase": "zstep", "model": f"{model} {fmt}@{ratio}x",
          "buckets": len(program.groups), "layers": len(program.names),
          "kernel_launches": launches, "other_kernel_launches": other,
          "z_step_ms_host_clock": z_step_ms,
          "residual_total": float(sum(r.item() for r in residuals.values())),
          "projection_rel_err": proj,
          "wall_s": time.perf_counter() - t_start})
    return launches


# per main path: the dense and compressed models, the ratio (the JAX
# package's, to 2 decimals), the training set-up (`bench.py`'s tk3x, tt3x
# and deit_tt2, with the depth cut; DeiT-tiny TK@2x as deit_tt2;
# MobileNetV2-CIFAR SVD@2x as RESULTS.md's mbv2_svd_r03 run, lr 0.05;
# ResNet-50 TT@3x as `results/run_r50tt.sh`: ADMM at lr 0.1 with warmup
# and clipping, fine-tune at lr 0.01; ImageNet MobileNetV2 SVD@2x at
# ResNet-50's geometry with the JAX package's MobileNetV2 lr 0.05 and
# fine-tune lr 0.01), the kernel the Z-step must launch and the one it
# must not
RESNET = dict(dense="resnet32", ratio_arg="3", dataset="synthetic-cifar10",
              synthetic_size=None, batch_size=256, opt="momentum", lr=0.1,
              input=(3, 32, 32), classes=10, full_rank_check=True)
DEIT = dict(dense="deit_tiny_patch16_224", ratio_arg="2",
            dataset="synthetic-imagenet", synthetic_size=512, batch_size=128,
            opt="adamw", lr=5e-4, input=(3, 224, 224), classes=1000,
            full_rank_check=False)
PATHS = {
    "tk": {**RESNET, "name": "resnet32 tk@3x", "fmt": "tk",
           "model": "tkc_resnet32", "ratio": 2.83,
           "kernel": tk.tucker2_factors_batched,
           "other": sk.dominant_left_subspace_batched},
    "tt": {**RESNET, "name": "resnet32 tt@3x", "fmt": "tt",
           "model": "ttm_resnet32", "ratio": 2.78,
           "kernel": sk.dominant_left_subspace_batched,
           "other": tk.tucker2_factors_batched},
    "deit": {**DEIT, "name": "deit_tiny_patch16_224 tt@2x", "fmt": "tt",
             "model": "ttm_deit_tiny_patch16_224", "ratio": 1.88,
             "kernel": sk.dominant_left_subspace_batched,
             "other": tk.tucker2_factors_batched},
    "deit_tk": {**DEIT, "name": "deit_tiny_patch16_224 tk@2x", "fmt": "tk",
                "model": "tkc_deit_tiny_patch16_224", "ratio": 1.17,
                "kernel": tk.tucker2_factors_batched,
                "other": sk.dominant_left_subspace_batched},
    "mbv2_svd": {**RESNET, "dense": "mobilenetv2_cifar", "ratio_arg": "2",
                 "lr": 0.05, "full_rank_check": False,
                 "name": "mobilenetv2_cifar svd@2x", "fmt": "svd",
                 "model": "svdc_mobilenetv2_cifar", "ratio": 1.74,
                 "params": MBV2_PARAMS,
                 "kernel": tk.tucker2_factors_batched,
                 "other": sk.dominant_left_subspace_batched},
    "r50_tt3": {**DEIT, "dense": "resnet50", "ratio_arg": "3",
                "dataset": "synthetic-hard-imagenet", "batch_size": 256,
                "opt": "momentum", "lr": 0.1, "ft_lr": 0.01,
                "admm_extra": {"warmup_epochs": 1, "clip_grad": 1.0},
                "name": "resnet50 tt@3x", "fmt": "tt",
                "model": "ttm_resnet50", "ratio": 2.51,
                "params": R50_TT_PARAMS,
                "kernel": sk.dominant_left_subspace_batched,
                "other": tk.tucker2_factors_batched},
    "mbv2_inet_svd": {**DEIT, "dense": "mobilenetv2", "ratio_arg": "2",
                      "dataset": "synthetic-hard-imagenet", "batch_size": 256,
                      "opt": "momentum", "lr": 0.05, "ft_lr": 0.01,
                      "name": "mobilenetv2 svd@2x", "fmt": "svd",
                      "model": "svdc_mobilenetv2", "ratio": 1.39,
                      "params": MBV2_INET_PARAMS,
                      "kernel": tk.tucker2_factors_batched,
                      "other": sk.dominant_left_subspace_batched},
}
# the depth of every main path: bench.py runs 24 epochs of 196 (ResNet) or
# 128 (DeiT) steps and the JAX package's fine-tune as many again
CUT = {"admm": "first projection + 2 epochs x 20 steps",
       "finetune": "1 epoch x 20 steps",
       "bench_py": "24 epochs x 196 (resnet32) or 128 (deit) steps",
       "run_r50tt_sh": "150 ADMM epochs (warmup 5, here 1) + 105 fine-tune "
                       "epochs of 50 steps"}


def phase_main(seed: int, card: str, key: str, launches_per_z_step: int,
               workdir: str):
    path = PATHS[key]
    fmt = path["fmt"]
    t_start = t0 = time.perf_counter()
    x_va, y_va, info = load_dataset(path["dataset"], False,
                                    path["synthetic_size"]
                                    and path["synthetic_size"] // 4)
    load_dataset(path["dataset"], True, path["synthetic_size"])
    dataset_s = time.perf_counter() - t0  # train_model makes both again
    common = dict(dataset=path["dataset"], batch_size=path["batch_size"],
                  synthetic_size=path["synthetic_size"], steps_per_epoch=20,
                  opt=path["opt"], smoothing=0.1,
                  compute_dtype="bfloat16", seed=seed, device="cuda",
                  print_fn=log)  # per-epoch rows go to stderr
    admm_cfg = TrainConfig(model=path["dense"], epochs=2, admm=True,
                           lr=path["lr"], rho=1e-3, fmt=fmt,
                           ratio=path["ratio_arg"], admm_method="kernel",
                           admm_hooi_iters=6,
                           log_path=f"{workdir}/admm_{key}.log",
                           **path.get("admm_extra", {}), **common)
    tk.tucker2_factors_batched.launches = 0
    sk.dominant_left_subspace_batched.launches = 0
    t0 = time.perf_counter()
    dense, hist = train_model(admm_cfg)
    torch.cuda.synchronize()
    admm_s = time.perf_counter() - t0
    launches = path["kernel"].launches
    other = path["other"].launches
    z_steps = 1 + admm_cfg.epochs
    if launches != z_steps * launches_per_z_step or other != 0:
        raise AssertionError(
            f"{key}: kernel launched {launches} times (expected {z_steps} "
            f"Z-steps x {launches_per_z_step}), the other kernel {other}")

    plan = get_rank_plan(path["model"], fmt, path["ratio_arg"])
    t0 = time.perf_counter()
    sd = decompose_params(dense.state_dict(), plan)
    torch.cuda.synchronize()
    decompose_s = time.perf_counter() - t0
    compressed = create_model(path["model"], ratio=path["ratio_arg"],
                              num_classes=path["classes"])
    compressed.load_state_dict(sd)
    ratio = compression_ratio(dense, compressed)
    if round(ratio, 2) != path["ratio"]:
        raise AssertionError(f"compression ratio {ratio}, expected "
                             f"{path['ratio']}")
    counts = (count_params(dense), count_params(compressed))
    if counts != path.get("params", counts):
        raise AssertionError(f"parameter counts {counts}, expected "
                             f"{path['params']}")

    ft_cfg = TrainConfig(model=path["model"], epochs=1,
                         lr=path.get("ft_lr", path["lr"]),
                         ratio=path["ratio_arg"], **common)
    ft, ft_hist = train_model(ft_cfg, init_state_dict=sd)
    save_variables(ft_checkpoint(workdir, key),
                   state_dict_to_jax(ft.state_dict()))  # as --save-model
    ev = evaluate_model(ft, x_va, y_va, info, compute_dtype="bfloat16")
    rt = eval_runtime(ft, info, batch_size=path["batch_size"],
                      compute_dtype="bfloat16")
    with torch.no_grad():
        logits = ft.eval()(torch.zeros(4, *path["input"], device="cuda"))
    if (tuple(logits.shape) != (4, path["classes"])
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")

    losses = ([h["train_loss"] for h in hist + ft_hist]
              + [h["test_loss"] for h in hist + ft_hist] + [ev["loss"]])
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss in {losses}")
    full_rank_rel = (check_full_rank_layer(dense, compressed.cuda())
                     if path["full_rank_check"] else None)
    proj = check_projection_quality(dense, path["dense"], fmt,
                                    path["ratio_arg"])
    last = hist[-1]
    steps = admm_cfg.steps_per_epoch
    emit({"phase": "main", "card": card, "model": path["name"],
          "batch": path["batch_size"], "optimizer": path["opt"],
          "lr": admm_cfg.lr, "finetune_lr": ft_cfg.lr,
          "warmup_epochs": admm_cfg.warmup_epochs,
          "clip_grad": admm_cfg.clip_grad,
          "depth_cut": CUT, "admm_epochs": admm_cfg.epochs,
          "steps_per_epoch": steps, "z_steps": z_steps,
          "kernel_launches": launches, "other_kernel_launches": other,
          "launches_per_z_step": launches_per_z_step,
          "dataset_s": dataset_s,
          "admm_it_per_s": steps / last["epoch_time_s"],
          "admm_x_step_it_per_s": steps / last["x_step_s"],
          "z_step_ms": 1000 * last["z_step_s"],
          "admm_wall_s": admm_s,
          "admm_train_loss": [h["train_loss"] for h in hist],
          "admm_residual_total": [h["admm_residual_total"] for h in hist],
          "decompose_s": decompose_s, "compression_ratio": ratio,
          "params_dense_compressed": list(counts),
          "finetune_it_per_s": steps / ft_hist[-1]["epoch_time_s"],
          "finetune_train_loss": ft_hist[-1]["train_loss"],
          "eval": ev, "ms_per_image": rt["ms_per_image"],
          "images_per_s": rt["images_per_s"],
          "full_rank_layer_rel_err": full_rank_rel,
          "projection_rel_err": proj,
          "wall_s": time.perf_counter() - t_start})
    return launches


# DeiT-small TT@2x: `results/run_deit_small.sh`'s recipe (AdamW lr 5e-4,
# warmup, clip 1.0, smoothing 0.1, the late rho boost; fine-tune at lr
# 1e-4) at DEIT's geometry on `synthetic-hard-imagenet`, with its depth cut
# to the least number of epochs at which the boost fires: int(0.85 * 7) =
# 5, so epoch index 6 runs at 5 rho. The fine-tune distils from the dense
# teacher (hard), both read from the msgpack the ADMM phase writes.
DEIT_S = dict(dense="deit_small_patch16_224", model="ttm_deit_small_patch16_224",
              name="deit_small_patch16_224 tt@2x", ratio_arg="2", ratio=1.53,
              params=DEIT_S_PARAMS, dataset="synthetic-hard-imagenet",
              synthetic_size=512, batch_size=128, lr=5e-4, ft_lr=1e-4,
              epochs=7, steps_per_epoch=10, ft_steps=20, plain_ft_steps=5,
              rho=1e-3, input=(3, 224, 224), classes=1000)
CUT["deit_s_tt2"] = ("first projection + 7 epochs x 10 steps (warmup 1), "
                     "then 1 fine-tune epoch x 20 steps")
CUT["run_deit_small_sh"] = ("300 ADMM epochs of 32 steps (warmup 5), then 60 "
                            "fine-tune epochs, at 4096 images")


@full_f32()
def sweep_launch_inputs(x, tt_shapes, tt_ranks):
    """(t, r) of every launch of the TT sweep of x [L, numel], the residual
    carried on by the plain version, as `tt_project_batched` carries it."""
    l = x.shape[0]
    ranks = clamp_tt_ranks(list(tt_shapes), tt_ranks)
    t, out = x, []
    for i in range(len(tt_shapes) - 1):
        t = t.reshape(l, ranks[i] * tt_shapes[i], -1).contiguous()
        r = min(ranks[i + 1], *t.shape[1:])
        if r != t.shape[1]:
            out.append((t, r))
        u = sk.dominant_left_subspace_plain(t, r, iters=TT_ITERS)
        t = torch.einsum("lrc,lrk->lkc", t, u)
    return out


def phase_kernel_trained(model, name: str, fmt: str, ratio: str, path: str):
    """The subspace kernel against its plain version at every launch of a
    Z-step on `model`'s trained weights (the W + U of the path's own fit
    check, U = 0): a trained spectrum beside the kernel phase's random
    one."""
    params = dict(model.named_parameters())
    program = build_program(params, get_rank_plan(name, fmt, ratio))
    rows_out = []
    for g in program.groups:
        x = torch.stack([params[n].detach().float() for n in g.names])
        for t, r in sweep_launch_inputs(x.reshape(len(g.names), -1),
                                        g.spec.tt_shapes, g.spec.tt_ranks):
            max_abs, proj, rel = check_subspace(t, r)
            row = {"phase": "kernel_trained_w",
                   "name": "dominant_left_subspace_batched", "path": path,
                   "shape_L_rows_cols": list(t.shape), "rank": r,
                   "plan": sk.plan_name(*t.shape[1:], r),
                   "projector_err": proj, "projector_tol": TT_PROJ_TOL,
                   "projected_rel_err": rel, "projected_rel_tol": TT_REL_TOL,
                   "max_abs_err": max_abs}
            emit(row)
            rows_out.append(row)
    return rows_out


def phase_deit_small(seed: int, card: str, launches_per_z_step: int,
                     workdir: str):
    """DeiT-small TT@2x through the port's entry points: ADMM with the
    late rho boost (`train_model`), the dense model to a msgpack, then
    `cli_main` decomposing it and fine-tuning with hard distillation from
    the dense teacher read back from the same file, then eval; one extra
    undistilled fine-tune of `plain_ft_steps` steps for its step time."""
    path = DEIT_S
    t_start = t0 = time.perf_counter()
    x_va, y_va, info = load_dataset(path["dataset"], False,
                                    path["synthetic_size"] // 4)
    dataset_s = time.perf_counter() - t0  # the validation set alone
    common = dict(dataset=path["dataset"], batch_size=path["batch_size"],
                  synthetic_size=path["synthetic_size"], opt="adamw",
                  smoothing=0.1, compute_dtype="bfloat16", seed=seed,
                  device="cuda", print_fn=log)
    admm_cfg = TrainConfig(model=path["dense"], epochs=path["epochs"],
                           steps_per_epoch=path["steps_per_epoch"],
                           lr=path["lr"], warmup_epochs=1, clip_grad=1.0,
                           admm=True, rho=path["rho"], adjust_rho_late=True,
                           fmt="tt", ratio=path["ratio_arg"],
                           admm_method="kernel", admm_hooi_iters=6,
                           eval_every=path["epochs"],
                           log_path=f"{workdir}/admm_deit_s.log", **common)
    tk.tucker2_factors_batched.launches = 0
    sk.dominant_left_subspace_batched.launches = 0
    t0 = time.perf_counter()
    dense, hist = train_model(admm_cfg)
    torch.cuda.synchronize()
    admm_s = time.perf_counter() - t0
    launches = sk.dominant_left_subspace_batched.launches
    other = tk.tucker2_factors_batched.launches
    z_steps = 1 + admm_cfg.epochs
    if launches != z_steps * launches_per_z_step or other != 0:
        raise AssertionError(
            f"deit_s_tt2: subspace kernel launched {launches} times "
            f"(expected {z_steps} Z-steps x {launches_per_z_step}), the "
            f"Tucker-2 kernel {other}")
    rhos = [h["rho"] for h in hist]
    boosted = [5 * path["rho"] if e > int(0.85 * admm_cfg.epochs)
               else path["rho"] for e in range(admm_cfg.epochs)]
    if rhos != boosted or rhos[-1] != 5 * path["rho"]:
        raise AssertionError(f"rho by epoch {rhos}, expected {boosted}")
    evaluated = [h["epoch"] for h in hist if "test_loss" in h]
    if evaluated != [admm_cfg.epochs]:
        raise AssertionError(f"evaluated after epochs {evaluated}")

    ckpt = os.path.join(workdir, "deit_small_admm.msgpack")
    t0 = time.perf_counter()
    save_variables(ckpt, state_dict_to_jax(dense.state_dict()))
    back = load_any_variables(ckpt, dense.state_dict)
    if not all(torch.equal(back[k], v.cpu())
               for k, v in dense.state_dict().items()):
        raise AssertionError("the msgpack does not read back the dense model")
    msgpack_s = time.perf_counter() - t0

    argv = ["--model", path["model"], "--ratio", path["ratio_arg"],
            "--decompose", "--model-path", ckpt, "--distillation-type",
            "hard", "--teacher-model", path["dense"], "--teacher-path", ckpt,
            "--epochs", "1", "--steps-per-epoch", str(path["ft_steps"]),
            "--lr", str(path["ft_lr"]), "--opt", "adamw", "--smoothing",
            "0.1", "--dataset", path["dataset"], "--synthetic-size",
            str(path["synthetic_size"]), "--batch-size",
            str(path["batch_size"]), "--seed", str(seed)]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):  # its rows, as the others'
        ft, ft_hist = cli_main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    ratio = compression_ratio(dense, ft)
    counts = (count_params(dense), count_params(ft))
    if round(ratio, 2) != path["ratio"] or counts != path["params"]:
        raise AssertionError(f"compression {ratio}, parameters {counts}; "
                             f"expected {path['ratio']}, {path['params']}")

    # the same fine-tune without the teacher, for its step time
    plain_cfg = TrainConfig(model=path["model"], epochs=1,
                            steps_per_epoch=path["plain_ft_steps"],
                            lr=path["ft_lr"], ratio=path["ratio_arg"],
                            **{**common, "synthetic_size": path["batch_size"]})
    _, plain_hist = train_model(plain_cfg, init_state_dict=ft.state_dict())

    ev = evaluate_model(ft, x_va, y_va, info, compute_dtype="bfloat16")
    rt = eval_runtime(ft, info, batch_size=path["batch_size"],
                      compute_dtype="bfloat16")
    with torch.no_grad():
        logits = ft.eval()(torch.zeros(4, *path["input"], device="cuda"))
    if (tuple(logits.shape) != (4, path["classes"])
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    losses = ([h["train_loss"] for h in hist + ft_hist + plain_hist]
              + [h["test_loss"] for h in hist + ft_hist if "test_loss" in h]
              + [ev["loss"]])
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss in {losses}")
    proj = check_projection_quality(dense, path["dense"], "tt",
                                    path["ratio_arg"])
    trained_rows = phase_kernel_trained(dense, path["dense"], "tt",
                                        path["ratio_arg"], path["name"])
    last = hist[-1]
    steps = admm_cfg.steps_per_epoch
    emit({"phase": "main", "card": card, "model": path["name"],
          "batch": path["batch_size"], "optimizer": "adamw",
          "lr": admm_cfg.lr, "finetune_lr": path["ft_lr"],
          "warmup_epochs": admm_cfg.warmup_epochs,
          "clip_grad": admm_cfg.clip_grad, "depth_cut": CUT,
          "admm_epochs": admm_cfg.epochs, "steps_per_epoch": steps,
          "z_steps": z_steps, "kernel_launches": launches,
          "other_kernel_launches": other,
          "launches_per_z_step": launches_per_z_step,
          "rho_by_epoch": rhos, "evaluated_after_epochs": evaluated,
          "admm_nonfinite_layers": [h["admm_nonfinite_layers"] for h in hist],
          "dataset_s_validation": dataset_s,
          "admm_it_per_s": steps / last["epoch_time_s"],
          "admm_x_step_it_per_s": steps / last["x_step_s"],
          "z_step_ms": 1000 * last["z_step_s"],
          "z_step_ms_by_epoch": [1000 * h["z_step_s"] for h in hist],
          "admm_wall_s": admm_s,
          "admm_train_loss": [h["train_loss"] for h in hist],
          "admm_residual_total": [h["admm_residual_total"] for h in hist],
          "msgpack_bytes": os.path.getsize(ckpt), "msgpack_s": msgpack_s,
          "cli_decompose_finetune_s": cli_s, "compression_ratio": ratio,
          "params_dense_compressed": list(counts),
          "distillation": "hard",
          "finetune_distilled_it_per_s": (path["ft_steps"]
                                          / ft_hist[-1]["x_step_s"]),
          "finetune_undistilled_it_per_s": (path["plain_ft_steps"]
                                            / plain_hist[-1]["x_step_s"]),
          "finetune_train_loss": ft_hist[-1]["train_loss"],
          "eval": ev, "ms_per_image": rt["ms_per_image"],
          "images_per_s": rt["images_per_s"],
          "projection_rel_err": proj,
          "trained_w_launches_checked": len(trained_rows),
          "trained_w_max_projector_err": max(r["projector_err"]
                                             for r in trained_rows),
          "wall_s": time.perf_counter() - t_start})
    return launches


# CIFAR ResNet56 TK@3x: the JAX package's CIFAR recipes (`results/
# run_flagship.sh`: ADMM at lr 0.1, smoothing 0.1, rho 1e-3, `--save-model`,
# then `--decompose --model-path` of that file; `results/run_ft_ablation.sh`'s
# `lr003_ema`: fine-tune at lr 0.003 with `--ema-decay 0.999`) with a
# checkpoint and a resume in the middle of ADMM, at CIFAR-10 geometry and
# batch 256, the depth cut to 3 ADMM epochs x 20 steps (the resume after
# epoch 2) and 2 fine-tune epochs x 10 steps on the step schedule (x 0.1
# after the first epoch) with Nesterov SGD.
R56 = dict(dense="resnet56", model="tkc_resnet56", name="resnet56 tk@3x",
           ratio_arg="3", ratio=3.10, params=R56_PARAMS,
           dataset="synthetic-cifar10", synthetic_size=None, batch_size=256,
           lr=0.1, rho=1e-3,
           epochs=3, stop_after=2, steps_per_epoch=20, ft_lr=0.003,
           ft_epochs=2, ft_steps=10, ema_decay=0.999, input=(3, 32, 32),
           classes=10)
CUT["r56_tk3"] = ("first projection + 3 ADMM epochs x 20 steps (checkpoint "
                  "after each, resumed after epoch 2), then 2 fine-tune "
                  "epochs x 10 steps")
CUT["run_flagship_sh"] = ("200 ADMM epochs of 196 steps, then 150 fine-tune "
                          "epochs (ResNet32)")


@contextlib.contextmanager
def recorded_lr():
    """The lr of every optimizer step taken inside the block, in order
    (a global step hook: it reads `param_groups` after each step)."""
    lrs = []
    handle = register_optimizer_step_post_hook(
        lambda opt, args, kwargs: lrs.append(opt.param_groups[0]["lr"]))
    try:
        yield lrs
    finally:
        handle.remove()


def _rel_dist(a, b) -> float:
    """||A - B|| / ||B|| over two name -> tensor maps."""
    num = sum(torch.sum((a[n].double() - b[n].double()) ** 2) for n in b)
    den = sum(torch.sum(b[n].double() ** 2) for n in b)
    return (num / den).sqrt().item()


def _same_tree(a, b) -> bool:
    """Bit for bit: tensors by dtype and value, the rest by ==."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str)
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    return a == b


def _checkpoint(ckpt_dir: str) -> dict:
    """A train-state file's contents as written (CPU tensors and values)."""
    return torch.load(os.path.join(ckpt_dir, CHECKPOINT_NAME),
                      map_location="cpu", weights_only=True)


def phase_kernel_trained_tk(model, name: str, ratio: str, path: str):
    """The Tucker-2 kernel against its plain version at every bucket of a
    Z-step on `model`'s trained weights (U = 0)."""
    params = dict(model.named_parameters())
    program = build_program(params, get_rank_plan(name, "tk", ratio))
    rows_out = []
    for g in program.groups:
        ts = torch.stack([params[n].detach().float() for n in g.names])
        l, o, i, kh, kw = ts.shape
        sp = tk_ranks(g.spec, (o, i, kh, kw))
        x = ts.permute(0, 3, 4, 1, 2).reshape(l, kh * kw, o, i).contiguous()
        max_abs, z_rel, sub = check_tucker(x, sp.out_rank, sp.in_rank)
        row = {"phase": "kernel_trained_w", "name": "tucker2_factors_batched",
               "path": path, "shape_LKOI": list(x.shape),
               "ranks": [sp.out_rank, sp.in_rank], "z_rel_err": z_rel,
               "z_rel_tol": Z_REL_TOL, "subspace_err": sub,
               "subspace_tol": SUBSPACE_TOL, "max_abs_err": max_abs}
        emit(row)
        rows_out.append(row)
    return rows_out


@torch.no_grad()
def exact_rank_weights(program, seed: int):
    """Every plan layer of `program` at exactly the plan's ranks, unit
    norm: a random N(0, 1) layer projected by exact SVD (HOSVD onto the
    Tucker-2 ranks, or TT-SVD onto the clamped TT ranks of its
    [O, kh*kw, I] view), so the spectrum within the ranks is a random
    matrix's and beyond them zero. (Gaussian factors instead make the
    spectrum within the ranks as ill-conditioned as their products: there
    the fixed iteration counts leave the plain version itself 8.6% from
    the input at ResNet56's layer1.5.conv1.)"""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for g in program.groups:
        for name in g.names:
            x = torch.randn(g.param_shape, generator=gen)
            if g.kind == "tk_conv":
                sp = tk_ranks(g.spec, g.param_shape)
                w = tucker2_project(x, sp.out_rank, sp.in_rank, n_iter=0)
            else:  # tt_conv, in the [O, kh*kw, I] view
                o, i, kh, kw = g.param_shape
                t = tt_project(x.permute(0, 2, 3, 1).reshape(o, kh * kw, i),
                               g.spec.tt_shapes, g.spec.tt_ranks)
                w = t.reshape(o, kh, kw, i).permute(0, 3, 1, 2)
            out[name] = (w / torch.linalg.vector_norm(w)).contiguous().cuda()
    return out


def phase_exact_rank(seed: int, model: str, fmt: str, ratio: str, path: str,
                     launches_per_z_step: int):
    """One Z-step (kernel route, `admm_update`) of `model`'s `fmt` plan on
    layers of exactly the plan's ranks: Z finite and within EXACT_RANK_TOL
    of each layer, the finite guard's count 0, one launch a bucket (TK) or
    a sweep step (TT) and none of the other kernel; then the kernel against
    its plain version at every launch of those inputs."""
    t_start = time.perf_counter()
    program = _program(fmt, model, ratio)
    params = exact_rank_weights(program, seed)
    kernel, other = ((tk.tucker2_factors_batched,
                      sk.dominant_left_subspace_batched) if fmt == "tk"
                     else (sk.dominant_left_subspace_batched,
                           tk.tucker2_factors_batched))
    kernel.launches = other.launches = 0
    state, _ = admm_update(params, admm_init(params, program), program,
                           update_u=False, method="kernel", n_iter=6)
    torch.cuda.synchronize()
    launches, other_launches = kernel.launches, other.launches
    if launches != launches_per_z_step or other_launches != 0:
        raise AssertionError(f"{path} exact-rank Z-step: {launches} launches "
                             f"(expected {launches_per_z_step}), the other "
                             f"kernel {other_launches}")
    errs = {n: (torch.linalg.vector_norm(state.z[n] - params[n])
                / torch.linalg.vector_norm(params[n])).item()
            for n in program.names}
    finite = all(bool(torch.isfinite(state.z[n]).all()) for n in program.names)
    if not finite or int(state.nonfinite) != 0 or max(errs.values()) >= \
            EXACT_RANK_TOL:
        raise AssertionError(f"{path} exact-rank Z-step: finite={finite}, "
                             f"guard={int(state.nonfinite)}, worst "
                             f"{max(errs.items(), key=lambda kv: kv[1])}")
    checked, worst = 0, 0.0
    for g in program.groups:
        ts = torch.stack([params[n] for n in g.names])
        if fmt == "tk":
            l, o, i, kh, kw = ts.shape
            sp = tk_ranks(g.spec, (o, i, kh, kw))
            x = ts.permute(0, 3, 4, 1, 2).reshape(l, kh * kw, o, i)
            worst = max(worst, check_tucker(x.contiguous(), sp.out_rank,
                                            sp.in_rank)[1])
            checked += 1
        else:
            x = ts.permute(0, 1, 3, 4, 2).reshape(len(g.names), -1)
            for t, r in sweep_launch_inputs(x, g.spec.tt_shapes,
                                            g.spec.tt_ranks):
                worst = max(worst, check_subspace(t, r)[2])
                checked += 1
    row = {"phase": "exact_rank", "path": path, "layers": len(program.names),
           "kernel_launches": launches, "other_kernel_launches": other_launches,
           "guard_nonfinite_layers": int(state.nonfinite),
           "max_z_rel_err_to_input": max(errs.values()),
           "z_rel_tol": EXACT_RANK_TOL, "launches_checked_against_plain":
               checked, "max_rel_err_against_plain": worst,
           "wall_s": time.perf_counter() - t_start}
    emit(row)
    return launches


def phase_r56(seed: int, card: str, launches_per_z_step: int, workdir: str):
    """ResNet56 TK@3x through the port's entry points: ADMM by
    `train_model` with a checkpoint after each epoch, stopped after epoch 2
    (`max_epochs`); the checkpoint read back; the CLI with `--resume` for
    the last epoch and `--save-model` (a msgpack); `cli_main`'s
    `--decompose --model-path` of that file into `tkc_resnet56` and an EMA
    fine-tune on the step schedule with Nesterov SGD; eval of the raw and
    the EMA weights. Beside it, the same 3 ADMM epochs uninterrupted."""
    path = R56
    t_start = t0 = time.perf_counter()
    size = path["synthetic_size"]
    x_va, y_va, info = load_dataset(path["dataset"], False, size and size // 4)
    dataset_s = time.perf_counter() - t0  # the validation set alone
    ckpt = os.path.join(workdir, "r56_ckpt")
    admm_kw = dict(model=path["dense"], dataset=path["dataset"],
                   synthetic_size=size, batch_size=path["batch_size"],
                   epochs=path["epochs"],
                   steps_per_epoch=path["steps_per_epoch"], lr=path["lr"],
                   smoothing=0.1, admm=True, rho=path["rho"], fmt="tk",
                   ratio=path["ratio_arg"], admm_method="kernel",
                   admm_hooi_iters=6, compute_dtype="bfloat16", seed=seed,
                   device="cuda", print_fn=log)
    cli_common = ["--dataset", path["dataset"], "--batch-size",
                  str(path["batch_size"]), "--smoothing", "0.1", "--seed",
                  str(seed), *(["--synthetic-size", str(size)] if size else [])]
    tk.tucker2_factors_batched.launches = 0
    sk.dominant_left_subspace_batched.launches = 0
    t0 = time.perf_counter()
    with recorded_lr() as lrs:
        stopped, hist1 = train_model(TrainConfig(checkpoint_dir=ckpt,
                                                 **admm_kw),
                                     max_epochs=path["stop_after"])
        torch.cuda.synchronize()
        admm_s = time.perf_counter() - t0
        # the checkpoint read back holds the stopped run's model, and
        # written again from what was read it is the same file's contents,
        # tensor for tensor, bit for bit
        t0 = time.perf_counter()
        dense_template = create_model(path["dense"]).state_dict()
        saved, extra = load_train_state(ckpt, _template_state(
            dense_template, admm_kw))
        again = os.path.join(workdir, "r56_ckpt_again")
        save_train_state(again, saved, extra)
        live = {k: v.cpu() for k, v in stopped.state_dict().items()}
        if not (_same_tree(saved.model, live)
                and _same_tree(_checkpoint(ckpt), _checkpoint(again))):
            raise AssertionError("the train state does not read back")
        checkpoint_s = time.perf_counter() - t0
        checkpoint_bytes = os.path.getsize(os.path.join(ckpt,
                                                        CHECKPOINT_NAME))
        if saved.epoch != path["stop_after"] - 1 or saved.step != (
                path["stop_after"] * path["steps_per_epoch"]):
            raise AssertionError(f"checkpoint at epoch {saved.epoch}, step "
                                 f"{saved.step}")
        argv = ["--model", path["dense"], "--admm", "--format", "tk",
                "--ratio", path["ratio_arg"], "--rho", str(path["rho"]),
                "--admm-method", "kernel", "--epochs", str(path["epochs"]),
                "--steps-per-epoch", str(path["steps_per_epoch"]), "--lr",
                str(path["lr"]), "--resume", ckpt, "--checkpoint-dir", ckpt,
                "--save-model", "--output-dir",
                os.path.join(workdir, "r56_admm"), *cli_common]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # its rows, as the others'
            dense, hist2 = cli_main(argv)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    admm_lrs = list(lrs)
    launches = tk.tucker2_factors_batched.launches
    other = sk.dominant_left_subspace_batched.launches
    z_steps = 1 + path["epochs"]  # the first projection is not run again
    if launches != z_steps * launches_per_z_step or other != 0:
        raise AssertionError(
            f"r56_tk3: Tucker-2 kernel launched {launches} times (expected "
            f"{z_steps} Z-steps x {launches_per_z_step}), the subspace "
            f"kernel {other}")
    if [h["epoch"] for h in hist1 + hist2] != [1, 2, 3]:
        raise AssertionError(f"epochs {[h['epoch'] for h in hist1 + hist2]}")
    (msgpack_path,) = [os.path.join(workdir, "r56_admm", f) for f in
                       os.listdir(os.path.join(workdir, "r56_admm"))
                       if f.endswith("_model.msgpack")]
    sd = {k: v.cpu() for k, v in dense.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    back_sd = load_any_variables(msgpack_path, dense.state_dict)
    if not all(torch.equal(back_sd[k], v) for k, v in sd.items()):
        raise AssertionError("the --save-model msgpack does not read back "
                             "the dense model")

    # the same ADMM run, never stopped
    ref_dir = os.path.join(workdir, "r56_ref")
    tk.tucker2_factors_batched.launches = 0
    t0 = time.perf_counter()
    with recorded_lr() as ref_lrs:
        _, ref_hist = train_model(TrainConfig(checkpoint_dir=ref_dir,
                                              **admm_kw))
        torch.cuda.synchronize()
    reference_s = time.perf_counter() - t0
    ref_launches = tk.tucker2_factors_batched.launches
    resumed = load_train_state(ckpt, _template_state(dense_template,
                                                     admm_kw))[0]
    ref = load_train_state(ref_dir, _template_state(dense_template,
                                                    admm_kw))[0]
    if admm_lrs != list(ref_lrs) or resumed.step != ref.step or (
            resumed.epoch != ref.epoch):
        raise AssertionError(f"resumed lr/step differ: {len(admm_lrs)} vs "
                             f"{len(ref_lrs)} steps, step {resumed.step} vs "
                             f"{ref.step}")
    if not _same_tree(resumed.rng, ref.rng):
        raise AssertionError("the resumed run's generators are not the "
                             "uninterrupted run's")
    names = [n for n, _ in create_model(path["dense"]).named_parameters()]
    drift = {"params": _rel_dist({n: resumed.model[n] for n in names},
                                 {n: ref.model[n] for n in names}),
             "z": _rel_dist(resumed.admm.z, ref.admm.z),
             "u": _rel_dist(resumed.admm.u, ref.admm.u)}
    if not all(drift[k] < RESUME_TOL[k] for k in drift):
        raise AssertionError(f"resumed state drifts {drift}, tolerance "
                             f"{RESUME_TOL}")

    # decompose the msgpack through the CLI and fine-tune with the EMA
    argv = ["--model", path["model"], "--ratio", path["ratio_arg"],
            "--decompose", "--model-path", msgpack_path, "--epochs",
            str(path["ft_epochs"]), "--steps-per-epoch",
            str(path["ft_steps"]), "--lr", str(path["ft_lr"]), "--ema-decay",
            str(path["ema_decay"]), "--sched", "step", "--decay-epochs", "1",
            "--opt", "sgd", *cli_common]
    t0 = time.perf_counter()
    with recorded_lr() as ft_lrs, contextlib.redirect_stdout(sys.stderr):
        ft, ft_hist = cli_main(argv)
    torch.cuda.synchronize()
    finetune_s = time.perf_counter() - t0
    schedule = make_schedule("step", path["ft_lr"], path["ft_epochs"],
                             path["ft_steps"], decay_epochs=1)
    if list(ft_lrs) != [schedule(i) for i in range(len(ft_lrs))] or len(
            ft_lrs) != path["ft_epochs"] * path["ft_steps"]:
        raise AssertionError(f"fine-tune lr {list(ft_lrs)}")
    ema_rows = [h for h in ft_hist if "ema_test_loss" in h]
    if len(ema_rows) != path["ft_epochs"]:
        raise AssertionError("no ema_test_* in the fine-tune's eval rows")
    ratio = compression_ratio(dense, ft)
    counts = (count_params(dense), count_params(ft))
    if round(ratio, 2) != path["ratio"] or counts != path["params"]:
        raise AssertionError(f"compression {ratio}, parameters {counts}; "
                             f"expected {path['ratio']}, {path['params']}")
    ev = evaluate_model(ft, x_va, y_va, info, compute_dtype="bfloat16")
    rt = eval_runtime(ft, info, batch_size=path["batch_size"],
                      compute_dtype="bfloat16")
    with torch.no_grad():
        logits = ft.eval()(torch.zeros(4, *path["input"],
                                       device=next(ft.parameters()).device))
    if (tuple(logits.shape) != (4, path["classes"])
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    losses = ([h[k] for h in hist1 + hist2 + ref_hist + ft_hist
               for k in ("train_loss", "test_loss")]
              + [h["ema_test_loss"] for h in ema_rows] + [ev["loss"]])
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss in {losses}")
    proj = check_projection_quality(dense, path["dense"], "tk",
                                    path["ratio_arg"])
    trained_tk = phase_kernel_trained_tk(dense, path["dense"],
                                         path["ratio_arg"], path["name"])
    trained_tt = phase_kernel_trained(dense, path["dense"], "tt",
                                      path["ratio_arg"], "resnet56 tt@3x")
    steps = path["steps_per_epoch"]
    last = hist2[-1]
    emit({"phase": "main", "card": card, "model": path["name"],
          "batch": path["batch_size"], "optimizer": "momentum",
          "lr": path["lr"], "finetune": {"lr": path["ft_lr"], "opt": "sgd",
                                         "sched": "step", "decay_epochs": 1,
                                         "ema_decay": path["ema_decay"]},
          "depth_cut": CUT, "admm_epochs": path["epochs"],
          "resumed_after_epoch": path["stop_after"], "steps_per_epoch": steps,
          "z_steps": z_steps, "kernel_launches": launches,
          "other_kernel_launches": other,
          "launches_per_z_step": launches_per_z_step,
          "reference_run_kernel_launches": ref_launches,
          "dataset_s_validation": dataset_s,
          "admm_it_per_s": steps / last["epoch_time_s"],
          "admm_x_step_it_per_s": steps / last["x_step_s"],
          "z_step_ms": 1000 * last["z_step_s"],
          "admm_wall_s": admm_s, "resume_cli_s": resume_s,
          "reference_wall_s": reference_s,
          "checkpoint_bytes": checkpoint_bytes, "checkpoint_s": checkpoint_s,
          "resumed_step": resumed.step, "lr_steps_equal": len(admm_lrs),
          "resume_drift": drift, "resume_tol": RESUME_TOL,
          "admm_train_loss": [h["train_loss"] for h in hist1 + hist2],
          "reference_train_loss": [h["train_loss"] for h in ref_hist],
          "admm_residual_total": [h["admm_residual_total"]
                                  for h in hist1 + hist2],
          "admm_nonfinite_layers": [h["admm_nonfinite_layers"]
                                    for h in hist1 + hist2],
          "msgpack_bytes": os.path.getsize(msgpack_path),
          "cli_decompose_finetune_s": finetune_s, "compression_ratio": ratio,
          "params_dense_compressed": list(counts),
          "finetune_it_per_s": path["ft_steps"] / ft_hist[-1]["x_step_s"],
          "finetune_lr_by_step": list(ft_lrs),
          "finetune_train_loss": [h["train_loss"] for h in ft_hist],
          "finetune_eval": [{k: h[k] for k in h if k.startswith(
              ("test_", "ema_test_"))} for h in ft_hist],
          "eval": ev, "ms_per_image": rt["ms_per_image"],
          "images_per_s": rt["images_per_s"], "projection_rel_err": proj,
          "trained_w_launches_checked": len(trained_tk) + len(trained_tt),
          "wall_s": time.perf_counter() - t_start})
    return launches


def _template_state(dense_sd, admm_kw):
    """A train state of ResNet56 TK@3x's shapes (no EMA), to check a
    checkpoint against."""
    plan = get_rank_plan(admm_kw["model"], "tk", admm_kw["ratio"])
    z = {n: dense_sd[n] for n in plan.names()}
    return TrainState(step=0, epoch=-1, model=dense_sd, optimizer={},
                      admm=AdmmState(u=z, z=z), ema=None, rng={})


# The Stiefel fine-tune: `stftkc_resnet32` from ResNet32 TK@3x's
# decomposed weights, its 2-D first and last factors stepped by Riemannian
# SGD (the 'stf' prefix picks it), the rest by SGD momentum, at CIFAR-10
# geometry and batch 256.
STIEFEL = dict(dense="resnet32", model="stftkc_resnet32", ratio_arg="3",
               dataset="synthetic-cifar10", synthetic_size=2560,
               batch_size=256, lr=0.1, steps=20)


def _max_ortho_err(model) -> dict:
    """name -> max |Q^T Q - I| of each 2-D first or last factor on its
    tall side, in float64."""
    out = {}
    for name, p in model.named_parameters():
        if name.endswith(("first_factor", "last_factor")) and p.dim() == 2:
            q = p.detach().double()
            q = q if q.shape[0] >= q.shape[1] else q.T
            eye = torch.eye(q.shape[1], dtype=q.dtype, device=q.device)
            out[name] = (q.T @ q - eye).abs().max().item()
    return out


def phase_stiefel(seed: int, card: str):
    """The Stiefel fine-tune through `train_model`: ResNet32's seeded
    weights decomposed at the TK@3x plan into `stftkc_resnet32`, then
    STIEFEL['steps'] steps with Riemannian SGD on the factors; every
    factor stays orthonormal (STIEFEL_TOL) and moves, losses finite."""
    path = STIEFEL
    t_start = time.perf_counter()
    dense = create_model(path["dense"],
                         generator=torch.Generator().manual_seed(seed))
    plan = get_rank_plan(path["model"], "stftk", path["ratio_arg"])
    sd = decompose_params(dense.cuda().state_dict(), plan)
    cfg = TrainConfig(model=path["model"], ratio=path["ratio_arg"],
                      dataset=path["dataset"],
                      synthetic_size=path["synthetic_size"],
                      batch_size=path["batch_size"], epochs=1,
                      steps_per_epoch=path["steps"], opt="momentum",
                      lr=path["lr"], smoothing=0.1, compute_dtype="bfloat16",
                      seed=seed, device="cuda", print_fn=log)
    start = create_model(path["model"], ratio=path["ratio_arg"])
    start.load_state_dict(sd)
    err_start = _max_ortho_err(start)
    model, hist = train_model(cfg, init_state_dict=sd)
    torch.cuda.synchronize()
    err = _max_ortho_err(model)
    if len(err) != 2 * len(plan.layers) or max(err.values()) >= STIEFEL_TOL:
        raise AssertionError(f"Stiefel factors off the manifold: "
                             f"{max(err.items(), key=lambda kv: kv[1])}")
    moved = min((p.detach().cpu() - sd[n].cpu()).abs().max().item()
                for n, p in model.named_parameters() if n in err)
    if not moved > 0:
        raise AssertionError("a Stiefel factor did not move")
    losses = [h[k] for h in hist for k in ("train_loss", "test_loss")]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss in {losses}")
    emit({"phase": "stiefel", "card": card, "model": path["model"],
          "ratio_plan": path["ratio_arg"], "batch": path["batch_size"],
          "lr": path["lr"], "steps": path["steps"],
          "factors": len(err), "max_ortho_err_start": max(err_start.values()),
          "max_ortho_err": max(err.values()), "ortho_tol": STIEFEL_TOL,
          "min_factor_move": moved, "train_loss": hist[-1]["train_loss"],
          "eval": {k: hist[-1][k] for k in hist[-1]
                   if k.startswith("test_")},
          "finetune_it_per_s": path["steps"] / hist[-1]["x_step_s"],
          "wall_s": time.perf_counter() - t_start})


# The NLP phase: `python -m dnn_compression_tensor_admm_tpu_torch.nlp`'s
# three subcommands through its `cli.main` at the JAX CLI's defaults
# (BERT-base: hidden 768, 12 layers, 12 heads, FFN 3072; sequence 128,
# batch 32; TT@2x linears at tt_dim 2, SVD@4.5x word embedding) on the
# synthetic corpora: task-distill on SST-2 at 512 examples (teacher 4
# epochs, stages 1 and 2 one epoch each), general-distill one epoch over
# 256 documents, squad at 128 examples, doc stride 64, 2 epochs. Float32
# with TF32 off (`ops/precision.py::full_f32`), as the JAX package's f32
# modules; no kernel of this repo runs there (XLA compiled all of it in
# the JAX package). Then `factorize_encoder` (HOOI onto
# NLP_TUCKER) of the fine-tuned teacher's 144 blocks.
NLP = dict(batch=32, seq=128)  # the CLI's defaults, for tokens/s
NLP_TUCKER = shared_tucker.SharedTuckerConfig(60, 384, 384)
NLP_WALL_LIMIT_S = 120.0


def _nlp_cli(argv):
    """`nlp.cli.main(argv)`, its printed rows sent to stderr; the peak
    device memory of the run and its wall seconds beside its result."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        model, hist = nlp_main(argv)
    torch.cuda.synchronize()
    return model, hist, {"wall_s": time.perf_counter() - t0,
                         "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def _finite_losses(rows):
    losses = [r[k] for r in rows for k in ("loss", "finetune_loss") if k in r]
    if not losses or not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite or no NLP losses: {rows}")
    return losses


def phase_nlp(seed: int, card: str, workdir: str) -> None:
    """The NLP subcommands at BERT-base width on the card (see NLP)."""
    t_start = time.perf_counter()
    tokens = NLP["batch"] * NLP["seq"]
    out = os.path.join(workdir, "nlp")
    common = ["--seed", str(seed), "--device", "cuda"]
    paths = {k: os.path.join(out, f"{k}.msgpack")
             for k in ("student", "teacher", "squad")}
    student, td, td_run = _nlp_cli([
        "task-distill", "--save", paths["student"],
        "--save-teacher", paths["teacher"], *common])
    teacher_sd = jax_to_state_dict(load_variables(paths["teacher"]))
    student_back = jax_to_state_dict(load_variables(paths["student"]))
    for name, t in student.state_dict().items():
        if not torch.equal(t.cpu(), student_back[name]):
            raise AssertionError(f"the student's msgpack differs at {name}")
    general, gd, gd_run = _nlp_cli(["general-distill", *common])
    squad_dir = os.path.join(out, "squad")
    squad, sq, sq_run = _nlp_cli(["squad", "--output-dir", squad_dir,
                                  "--save", paths["squad"], *common])
    files = {f: os.path.getsize(os.path.join(squad_dir, f))
             for f in ("predictions.json", "nbest_predictions.json")}
    vocab_general = general.embeddings.word_embeddings.first_factor.shape[0]
    with torch.device("meta"):
        general_teacher = nlp_bert.BertModel(
            nlp_bert.BertConfig(vocab_size=vocab_general))
    counts = {"task_teacher": sum(t.numel() for t in teacher_sd.values()),
              "task_student": count_params(student),
              "general_teacher": count_params(general_teacher),
              "general_student": count_params(general),
              "squad": count_params(squad)}
    if counts != NLP_PARAMS:
        raise AssertionError(f"NLP parameter counts {counts} != the JAX "
                             f"package's {NLP_PARAMS}")
    losses = {"task": _finite_losses(td), "general": _finite_losses(gd),
              "squad": _finite_losses(sq)}
    teacher_row, stage1, stage2 = td[0], td[1], td[-1]
    steps_ms = {"teacher_finetune": teacher_row["finetune_ms_per_step"],
                "stage1": stage1["ms_per_step"],
                "stage2": stage2["ms_per_step"],
                "general_distill": gd[-1]["ms_per_step"],
                "squad": sq[-1]["ms_per_step"]}
    # HOOI of the fine-tuned teacher's 144 [768, 768] blocks
    blocks = shared_tucker.stack_encoder_blocks(
        teacher_sd, 12, prefix="bert.encoder.layer").cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factors = shared_tucker.factorize_encoder(blocks, NLP_TUCKER)
    torch.cuda.synchronize()
    factorize_s = time.perf_counter() - t0
    with full_f32():
        fit = float(torch.linalg.vector_norm(
            blocks - shared_tucker.reconstruct_blocks(factors))
            / torch.linalg.vector_norm(blocks))
    if not (np.isfinite(fit) and fit < 1.0):
        raise AssertionError(f"factorize_encoder fit {fit}")
    wall = time.perf_counter() - t_start
    emit({"phase": "nlp", "card": card,
          "config": "bert-base (768, 12 layers, 12 heads, FFN 3072), "
                    "seq 128, batch 32, tt@2x linears, svd@4.5x embedding",
          "matmul_precision": "float32, TF32 off (full_f32); "
                              f"torch {torch.get_float32_matmul_precision()}",
          "params": counts,
          "task_ratio": counts["task_teacher"] / counts["task_student"],
          "ms_per_step": steps_ms,
          "tokens_per_s": {k: tokens / (v / 1e3) for k, v in steps_ms.items()},
          "peak_mem_bytes": {"task_distill": td_run["peak_mem_bytes"],
                             "general_distill": gd_run["peak_mem_bytes"],
                             "squad": sq_run["peak_mem_bytes"]},
          "wall_s_by_command": {"task_distill": td_run["wall_s"],
                                "general_distill": gd_run["wall_s"],
                                "squad": sq_run["wall_s"]},
          "final_loss": {k: v[-1] for k, v in losses.items()},
          "teacher_finetune_loss": teacher_row["finetune_loss"],
          "teacher_dev_acc": teacher_row["acc"],
          "student_dev_acc": stage2["acc"],
          "squad_exact_match": sq[-1]["exact_match"],
          "squad_f1": sq[-1]["f1"], "squad_prediction_files_bytes": files,
          "factorize_encoder": {"blocks": list(blocks.shape),
                                "ranks": dataclasses.astuple(NLP_TUCKER),
                                "seconds": factorize_s, "rel_err": fit},
          "wall_s": wall, "wall_limit_s": NLP_WALL_LIMIT_S})
    if wall > NLP_WALL_LIMIT_S:
        raise AssertionError(f"the NLP phase took {wall:.1f} s")


# ms per Z-step of earlier CUDA versions of each kernel, as PERF.md
# records them (NVIDIA H100 80GB HBM3, 700 W): printed on a line of their
# own, labelled as recorded, apart from this run's measurements
# DeiT-tiny TT@2x as `run.sh`'s `deit-tiny-tt-admm` runs it: AdamW lr
# 5e-4, cosine after a warmup, Mixup 0.8 and CutMix 1.0, the train set
# streamed from DCTA shards by the native loader; here with smoothing 0.1
# and the same msgpack chained into `--decompose`, whose fine-tune adds the
# DeiT recipe's RandAugment, RandomErasing and repeated augmentation over
# the shards read whole (`--shard-cache hbm`, `--sampling shuffle`). The
# shards hold `synthetic-imagenet` at 512 train and 128 val images.
DEIT_R = dict(dense="deit_tiny_patch16_224", model="ttm_deit_tiny_patch16_224",
              name="deit_tiny_patch16_224 tt@2x (run.sh recipe)",
              ratio_arg="2", ratio=1.88, dataset="synthetic-imagenet",
              train_images=512, val_images=128, images_per_shard=128,
              batch_size=128, epochs=2, steps_per_epoch=20, warmup_epochs=1,
              lr=5e-4, ft_steps=20, loader_workers=4, input=(3, 224, 224),
              classes=1000)
CUT["deit_tt2_recipe"] = ("first projection + 2 ADMM epochs x 20 streamed "
                          "steps (warmup 1 epoch, run.sh: 5 of 300), then "
                          "20 fine-tune steps from the shards read whole")
CUT["run_sh_deit_tiny_tt_admm"] = "300 ADMM epochs, warmup 5, batch 256"
# every Mixup/CutMix target row is a probability vector: sums to 1 within
# float32 rounding of 1,000 smoothed, mixed entries
MIX_ROW_TOL = 1e-5


@contextlib.contextmanager
def shared_cifar_sets():
    """Makes each synthetic CIFAR set once for the whole run: the CIFAR
    paths (ResNet32 TK and TT, MobileNetV2-CIFAR, ResNet56, the Stiefel
    fine-tune) read the same bytes as when each made its own, without
    making 50,000 images again (~75% of a ResNet32 path's wall time)."""
    from dnn_compression_tensor_admm_tpu_torch.data import datasets
    from dnn_compression_tensor_admm_tpu_torch.train import engine
    made, original = {}, datasets.load_dataset

    def load(name, train, synthetic_size=None, data_dir=None):
        if not (name.startswith("synthetic-") and "cifar" in name):
            return original(name, train, synthetic_size, data_dir)
        key = (name, train, synthetic_size)
        if key not in made:
            made[key] = original(name, train, synthetic_size, data_dir)
        return made[key]

    owners = (datasets, engine, sys.modules[__name__])
    for m in owners:
        m.load_dataset = load
    try:
        yield made
    finally:
        for m in owners:
            m.load_dataset = original


@contextlib.contextmanager
def observed_mixing():
    """Records what reaches Mixup/CutMix in the engine, a step at a time:
    the images' shape, the labels and the targets' worst row sum (kept on
    the card; read after the block)."""
    from dnn_compression_tensor_admm_tpu_torch.train import engine
    seen = {"shapes": set(), "labels": [], "row_err": []}
    original = engine.mixup_cutmix

    def mixing(x, labels, draws, **kw):
        out, target = original(x, labels, draws, **kw)
        seen["shapes"].add((tuple(x.shape), tuple(labels.shape),
                            tuple(target.shape)))
        seen["labels"].append(labels)
        seen["row_err"].append((target.sum(-1) - 1).abs().max())
        return out, target

    engine.mixup_cutmix = mixing
    try:
        yield seen
    finally:
        engine.mixup_cutmix = original


def check_mixed_batches(seen, steps: int, shard_labels) -> dict:
    """Each step's batch has the config's shapes, its labels come from
    the shards, and its mixed targets' rows sum to 1."""
    b, classes = DEIT_R["batch_size"], DEIT_R["classes"]
    want = {((b, *DEIT_R["input"]), (b,), (b, classes))}
    if len(seen["labels"]) != steps or seen["shapes"] != want:
        raise AssertionError(f"{len(seen['labels'])} mixed batches of "
                             f"{seen['shapes']}, expected {steps} of {want}")
    labels = set(torch.cat(seen["labels"]).unique().tolist())
    if not labels <= shard_labels:
        raise AssertionError(f"labels {sorted(labels - shard_labels)[:5]} "
                             "are not in the shards")
    row_err = torch.stack(seen["row_err"]).max().item()
    if not row_err < MIX_ROW_TOL:
        raise AssertionError(f"a mixed target row sums to 1 +- {row_err}")
    return {"distinct_labels": len(labels), "max_row_sum_err": row_err}


def phase_deit_recipe(seed: int, card: str, launches_per_z_step: int,
                      workdir: str):
    """DeiT-tiny TT@2x through the CLI as `run.sh`'s recipe: shards
    written by the port, ADMM streamed through the native loader with
    `--profile-dir` and `--save-model`, then `--decompose` of that msgpack
    and a fine-tune from the shards read whole, eval on the val shards,
    and `--flops`."""
    from dnn_compression_tensor_admm_tpu_torch.data.records import (
        read_shard, write_shards)
    from dnn_compression_tensor_admm_tpu_torch.utils.profiling import (
        trace_summary)
    path = DEIT_R
    t_start = t0 = time.perf_counter()
    shards = os.path.join(workdir, "deit_shards")
    sets = {}
    for train, prefix, n in ((True, "train", path["train_images"]),
                             (False, "val", path["val_images"])):
        x, y, _ = load_dataset(path["dataset"], train, n)
        sets[prefix] = write_shards(x, y, shards, path["images_per_shard"],
                                    prefix)
        del x
    shard_labels = set(np.concatenate(
        [read_shard(p)[1] for p in sets["train"]]).tolist())
    shards_s = time.perf_counter() - t0
    shard_bytes = {k: sum(os.path.getsize(p) for p in v)
                   for k, v in sets.items()}
    def probe(cache, model=path["dense"], **extra) -> dict:
        """One untraced epoch of the X-step, streamed (`cache` None) or
        from the shards read whole, with the recipe's Mixup/CutMix and
        `extra` settings: ms a step and the streamed route's loader
        times."""
        cfg = TrainConfig(model=model, dataset=path["dataset"],
                          shard_dir=shards, shard_cache=cache, epochs=1,
                          steps_per_epoch=path["steps_per_epoch"],
                          batch_size=path["batch_size"], opt="adamw",
                          lr=path["lr"], mixup=0.8, cutmix=1.0,
                          smoothing=0.1, loader_workers=path["loader_workers"],
                          fmt="tt", ratio=path["ratio_arg"],
                          compute_dtype="bfloat16", seed=seed,
                          device="cuda", print_fn=log, **extra)
        row = train_model(cfg)[1][-1]
        return {"ms_per_step": 1000 * row["x_step_s"] / cfg.steps_per_epoch,
                **{k: row[k] for k in ("loader_host_ms_per_batch",
                                       "loader_wait_ms_per_step")
                   if k in row}}

    # before any profiler runs in this process (a trace leaves the later
    # steps of its process slower, PERF.md section 6): the dense model's
    # X-step streamed and read whole, an ADMM epoch streamed (the traced
    # epoch's workload) and the fine-tune's step (its model and
    # augmentations, random weights); one dense probe again after the trace
    probes = {"dense_streamed": probe(None), "dense_cached": probe("hbm"),
              "admm_streamed": probe(None, admm=True),
              "finetune_cached": probe(
                  "hbm", model=path["model"], randaug_magnitude=9,
                  randaug_std=0.5, erase_prob=0.25, repeated_aug=3,
                  sampling="shuffle")}
    out_dir = os.path.join(workdir, "deit_recipe_models")
    profile_dir = os.path.join(workdir, "deit_recipe_profile")
    common = ["--dataset", path["dataset"], "--shard-dir", shards,
              "--batch-size", str(path["batch_size"]), "--opt", "adamw",
              "--lr", str(path["lr"]), "--sched", "cosine",
              "--mixup", "0.8", "--cutmix", "1.0", "--smoothing", "0.1",
              "--seed", str(seed), "--output-dir", out_dir]
    admm_argv = ["--model", path["dense"], "--admm", "--format", "tt",
                 "--ratio", path["ratio_arg"], "--warmup-epochs",
                 str(path["warmup_epochs"]), "--epochs", str(path["epochs"]),
                 "--steps-per-epoch", str(path["steps_per_epoch"]),
                 "--loader-workers", str(path["loader_workers"]),
                 "--profile-dir", profile_dir, "--save-model", *common]
    tk.tucker2_factors_batched.launches = 0
    sk.dominant_left_subspace_batched.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr), observed_mixing() as seen:
        dense, hist = cli_main(admm_argv)
    torch.cuda.synchronize()
    admm_s = time.perf_counter() - t0
    launches = sk.dominant_left_subspace_batched.launches
    other = tk.tucker2_factors_batched.launches
    z_steps = 1 + path["epochs"]
    if launches != z_steps * launches_per_z_step or other != 0:
        raise AssertionError(
            f"deit_tt2_recipe: subspace kernel launched {launches} times "
            f"(expected {z_steps} Z-steps x {launches_per_z_step}), the "
            f"Tucker-2 kernel {other}")
    streamed = check_mixed_batches(
        seen, path["epochs"] * path["steps_per_epoch"], shard_labels)
    trace_path = hist[0].get("profile_trace")
    if not trace_path or not os.path.getsize(trace_path):
        raise AssertionError("no Chrome trace of the first epoch")
    profile = trace_summary(trace_path, top=10)
    if not profile["device_events"]:
        raise AssertionError("the trace holds no device op")
    busy_ms = profile["device_busy_ms"] / path["steps_per_epoch"]
    (ckpt,) = [os.path.join(out_dir, f) for f in os.listdir(out_dir)
               if f.endswith("_model.msgpack")]

    ft_argv = ["--model", path["model"], "--ratio", path["ratio_arg"],
               "--decompose", "--model-path", ckpt, "--shard-cache", "hbm",
               "--aa", "rand-m9-mstd0.5", "--reprob", "0.25",
               "--repeated-aug", "3", "--sampling", "shuffle",
               "--epochs", "1", "--steps-per-epoch", str(path["ft_steps"]),
               *common]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr), \
            observed_mixing() as seen_ft:
        ft, ft_hist = cli_main(ft_argv)
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t0
    cached = check_mixed_batches(seen_ft, path["ft_steps"], shard_labels)
    ratio = compression_ratio(dense, ft)
    if round(ratio, 2) != path["ratio"]:
        raise AssertionError(f"compression {ratio}, expected {path['ratio']}")
    with contextlib.redirect_stdout(sys.stderr):
        flops = cli_main(["--model", path["model"], "--ratio",
                          path["ratio_arg"], "--flops", "--dataset",
                          path["dataset"]])
    probes["dense_cached_after_trace"] = probe("hbm")
    losses = ([h["train_loss"] for h in hist + ft_hist]
              + [h["test_loss"] for h in hist + ft_hist])
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss in {losses}")
    proj = check_projection_quality(dense, path["dense"], "tt",
                                    path["ratio_arg"])
    last, steps = hist[-1], path["steps_per_epoch"]
    emit({"phase": "main", "card": card, "model": path["name"],
          "batch": path["batch_size"], "optimizer": "adamw",
          "lr": path["lr"], "warmup_epochs": path["warmup_epochs"],
          "depth_cut": CUT["deit_tt2_recipe"],
          "shards": {"train_images": path["train_images"],
                     "val_images": path["val_images"],
                     "bytes": shard_bytes, "write_s": shards_s},
          "admm_epochs": path["epochs"], "steps_per_epoch": steps,
          "z_steps": z_steps, "kernel_launches": launches,
          "other_kernel_launches": other,
          "launches_per_z_step": launches_per_z_step,
          "probes": probes,
          "admm_ms_per_step_streamed_profiled_epoch": (
              1000 * hist[0]["x_step_s"] / steps),
          "admm_ms_per_step_streamed_after_profile": (
              1000 * last["x_step_s"] / steps),
          "finetune_ms_per_step_cached_after_trace": (
              1000 * ft_hist[-1]["x_step_s"] / path["ft_steps"]),
          "loader_host_ms_per_batch": [h["loader_host_ms_per_batch"]
                                       for h in hist],
          "loader_wait_ms_per_step": [h["loader_wait_ms_per_step"]
                                      for h in hist],
          "z_step_ms": 1000 * last["z_step_s"],
          "admm_wall_s": admm_s, "finetune_cli_s": ft_s,
          "admm_train_loss": [h["train_loss"] for h in hist],
          "admm_residual_total": [h["admm_residual_total"] for h in hist],
          "streamed_batches": streamed, "cached_batches": cached,
          "profile": {"trace": os.path.basename(trace_path),
                      **{k: profile[k] for k in ("span_ms",
                                                 "device_busy_ms",
                                                 "idle_share",
                                                 "device_events")},
                      # the traced epoch's device time a step against an
                      # untraced step of the same workload
                      "device_busy_ms_per_step": busy_ms,
                      "idle_share_of_untraced_step": 1 - busy_ms / (
                          probes["admm_streamed"]["ms_per_step"]),
                      "top_ops": profile["top_ops"]},
          "compression_ratio": ratio,
          "finetune_train_loss": ft_hist[-1]["train_loss"],
          "eval_val_shards": {k: ft_hist[-1][f"test_{k}"]
                              for k in ("acc1", "acc5", "loss")},
          "flops": flops["flops"], "dense_flops": flops["dense_flops"],
          "flop_ratio": flops["flop_ratio"], "params": flops["params"],
          "projection_rel_err": proj,
          "wall_s": time.perf_counter() - t_start})
    return launches


# --------------------------------------------------------------------------
# The export phase: the fine-tuned models of three main paths written out
# by the CLI as ONNX and as a torch.export program, and read back.

EXPORT_PATHS = ("tk", "r50_tt3", "deit")
EXPORT_BATCH = 2           # the torch.export program's fixed batch
ONNX_TOL = 2e-3            # rtol = atol, the JAX package's ONNX test's
EXPORT_REL_TOL = 1e-5      # max |program - eager| / max |eager|
EXPORT_WALL_LIMIT_S = 60.0
EXPORT_EVAL_IMAGES = 32    # the .pth round trip's ImageNet-geometry evals


def ft_checkpoint(workdir: str, key: str) -> str:
    """Where `phase_main` writes path `key`'s fine-tuned model."""
    return os.path.join(workdir, f"{key}_ft_model.msgpack")


def _onnx_conv(ins, a):
    p = a.get("pads", [0, 0, 0, 0])
    if p[:2] != p[2:]:
        raise ValueError(f"asymmetric Conv pads {p}")
    return torch.nn.functional.conv2d(
        ins[0], ins[1], ins[2] if len(ins) > 2 else None,
        stride=tuple(a.get("strides", [1, 1])), padding=tuple(p[:2]))


def _onnx_maxpool(ins, a):
    p = a.get("pads", [0, 0, 0, 0])
    if p[:2] != p[2:]:
        raise ValueError(f"asymmetric MaxPool pads {p}")
    return torch.nn.functional.max_pool2d(
        ins[0], tuple(a["kernel_shape"]), tuple(a["strides"]), tuple(p[:2]))


def _onnx_slice(x, starts, ends, axes, steps):
    index = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        index[int(ax)] = slice(int(st), int(min(en, x.shape[int(ax)])),
                               int(sp))
    return x[tuple(index)]


def _onnx_pad(x, pads):
    r = x.ndim
    width = []
    for d in reversed(range(r)):  # torch pads the last dim first
        width += [int(pads[d]), int(pads[d + r])]
    return torch.nn.functional.pad(x, width)


def _onnx_gather(x, idx, axis):
    if np.ndim(idx) == 0:
        return x.select(axis, int(idx))
    return x.index_select(axis, torch.as_tensor(idx, device=x.device))


# opset-13 semantics of every op the port's exporter writes, as torch ops
ONNX_OPS = {
    "Conv": _onnx_conv,
    "Relu": lambda ins, a: torch.relu(ins[0]),
    "Add": lambda ins, a: ins[0] + ins[1],
    "Sub": lambda ins, a: ins[0] - ins[1],
    "Mul": lambda ins, a: ins[0] * ins[1],
    "Div": lambda ins, a: ins[0] / ins[1],
    "Sqrt": lambda ins, a: torch.sqrt(ins[0]),
    "Erf": lambda ins, a: torch.erf(ins[0]),
    "MatMul": lambda ins, a: torch.matmul(ins[0], ins[1]),
    "ReduceMean": lambda ins, a: ins[0].mean(
        dim=tuple(a["axes"]), keepdim=bool(a.get("keepdims", 1))),
    "Softmax": lambda ins, a: torch.softmax(ins[0], dim=a.get("axis", -1)),
    "Transpose": lambda ins, a: ins[0].permute(*a["perm"]),
    "Reshape": lambda ins, a: ins[0].reshape([int(v) for v in ins[1]]),
    "Concat": lambda ins, a: torch.cat(ins, dim=a["axis"]),
    "Gather": lambda ins, a: _onnx_gather(ins[0], ins[1], a.get("axis", 0)),
    "BatchNormalization": lambda ins, a: torch.nn.functional.batch_norm(
        ins[0], ins[3], ins[4], ins[1], ins[2], False, 0.0,
        a.get("epsilon", 1e-5)),
    "MaxPool": _onnx_maxpool,
    "GlobalAveragePool": lambda ins, a: ins[0].mean(dim=(2, 3), keepdim=True),
    "Flatten": lambda ins, a: ins[0].reshape(
        int(np.prod(ins[0].shape[:a.get("axis", 1)])), -1),
    "Gemm": lambda ins, a: torch.addmm(
        ins[2], ins[0], ins[1].t() if a.get("transB") else ins[1]),
    "Slice": lambda ins, a: _onnx_slice(*ins),
    "Pad": lambda ins, a: _onnx_pad(ins[0], ins[1]),
}


def run_onnx(data: bytes, x: torch.Tensor):
    """Run an ONNX model of the port's exporter on x's device: float
    initializers as tensors there, int64 ones (shapes, indices, pads) on
    the host. Returns (output, number of nodes); raises on an op it does
    not know. Run it inside `full_f32()` for float32 without TF32."""
    graph = pb_fields(pb_fields(data)[7][0])
    env = {}
    for tb in graph.get(5, []):
        f = pb_fields(tb)
        dtype = {1: np.float32, 7: np.int64}[f[2][0]]
        a = np.frombuffer(f[9][0], dtype=dtype).reshape(tuple(f.get(1, [])))
        env[f[8][0].decode()] = (torch.from_numpy(a.copy()).to(x.device)
                                 if dtype == np.float32 else a)
    env[pb_fields(graph[11][0])[1][0].decode()] = x
    nodes = graph.get(1, [])
    for nb in nodes:
        node = pb_fields(nb)
        op = node[4][0].decode()
        if op not in ONNX_OPS:
            raise ValueError(f"ONNX op {op} is not one the exporter writes")
        ins = [env[b.decode()] for b in node.get(1, [])]
        env[node[2][0].decode()] = ONNX_OPS[op](ins, onnx_attrs(node))
    return env[pb_fields(graph[12][0])[1][0].decode()], len(nodes)


def _cli_quiet(argv):
    """`cli_main(argv)` with its printed lines sent to stderr."""
    with contextlib.redirect_stdout(sys.stderr):
        return cli_main(argv)


def export_one(seed: int, key: str, workdir: str) -> dict:
    """Path `key`'s fine-tuned model through the CLI's --export-onnx and
    --export, each file run again on the card against the eager model,
    and the .pth round trip through --pretrained --eval."""
    path = PATHS[key]
    ckpt = ft_checkpoint(workdir, key)
    stem = os.path.join(workdir, f"export_{key}")
    onnx_path, program_path, pth_path = (stem + ".onnx", stem + ".pt2",
                                         stem + ".pth")
    common = ["--model", path["model"], "--ratio", path["ratio_arg"],
              "--dataset", path["dataset"], "--device", "cuda",
              "--seed", str(seed)]
    if path["synthetic_size"]:  # CIFAR evaluates the shared 10,000 images
        common += ["--synthetic-size", str(EXPORT_EVAL_IMAGES)]
    t0 = time.perf_counter()
    done = _cli_quiet([*common, "--pretrained", "--model-path", ckpt,
                       "--export-onnx", onnx_path, "--export", program_path,
                       "--batch-size", str(EXPORT_BATCH)])
    cli_s = time.perf_counter() - t0

    model = create_model(path["model"], ratio=path["ratio_arg"],
                         num_classes=path["classes"])
    model.load_state_dict(load_any_variables(ckpt, model.state_dict))
    model = model.cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x1 = torch.rand(1, *path["input"], generator=gen, device="cuda")
    x2 = torch.rand(EXPORT_BATCH, *path["input"], generator=gen,
                    device="cuda")
    with open(onnx_path, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    program = load_exported(program_path)
    load_s = time.perf_counter() - t0
    with torch.no_grad(), full_f32():
        t0 = time.perf_counter()
        y_onnx, n_nodes = run_onnx(data, x1)
        torch.cuda.synchronize()
        onnx_run_s = time.perf_counter() - t0
        y1 = model(x1)
        y_program = program.module()(x2)
        y2 = model(x2)
    onnx_err = float((y_onnx - y1).abs().max())
    onnx_ok = bool(torch.allclose(y_onnx, y1, rtol=ONNX_TOL, atol=ONNX_TOL))
    program_rel = float((y_program - y2).abs().max() / y2.abs().max())
    if tuple(y_onnx.shape) != (1, path["classes"]) or not onnx_ok:
        raise AssertionError(f"{key}: the ONNX model gives "
                             f"{tuple(y_onnx.shape)}, {onnx_err} from the "
                             f"model (rtol = atol = {ONNX_TOL})")
    if (tuple(y_program.shape) != (EXPORT_BATCH, path["classes"])
            or not program_rel <= EXPORT_REL_TOL):
        raise AssertionError(f"{key}: the torch.export program is "
                             f"{program_rel} from the model")

    t0 = time.perf_counter()
    save_torch_state_dict(pth_path, state_dict_to_torch(model))
    eval_pth = _cli_quiet([*common, "--pretrained", "--model-path", pth_path,
                           "--eval"])
    eval_msgpack = _cli_quiet([*common, "--pretrained", "--model-path", ckpt,
                               "--eval"])
    pth_s = time.perf_counter() - t0
    if eval_pth != eval_msgpack:
        raise AssertionError(f"{key}: the .pth evaluates to {eval_pth}, the "
                             f"msgpack to {eval_msgpack}")
    return {"model": path["name"],
            "bytes": {"msgpack": os.path.getsize(ckpt),
                      "onnx": os.path.getsize(onnx_path),
                      "torch_export": os.path.getsize(program_path),
                      "pth": os.path.getsize(pth_path)},
            "onnx_nodes": n_nodes,
            "export_onnx_s": done["export_onnx_s"],
            "torch_export_s": done["export_s"],
            "cli_s": cli_s, "load_exported_s": load_s,
            "onnx_run_s": onnx_run_s,
            "onnx_max_abs_diff": onnx_err,
            "onnx_logit_scale": float(y1.abs().max()),
            "torch_export_rel_diff": program_rel,
            "pth_eval": eval_pth, "pth_roundtrip_s": pth_s}


def phase_export(seed: int, card: str, workdir: str) -> None:
    """The fine-tuned ResNet32 TK@3x, ResNet-50 TT@3x and DeiT-tiny TT@2x
    written out and run again (see EXPORT_PATHS), an ONNX export the
    exporter must refuse, and the TT-LSTM latency demo."""
    t_start = time.perf_counter()
    rows = [export_one(seed, key, workdir) for key in EXPORT_PATHS]
    try:
        export_onnx(create_model("mobilenetv2"),
                    os.path.join(workdir, "mobilenetv2.onnx"),
                    num_classes=1000, input_size=224)
    except ValueError as e:
        if "ResNet and ViT/DeiT families only" not in str(e):
            raise
        refused = str(e)
    else:
        raise AssertionError("the ONNX exporter wrote a MobileNetV2 graph")
    lstm = tt_lstm_inference_demo(device="cuda", seed=seed)
    wall_s = time.perf_counter() - t_start
    emit({"phase": "export", "card": card, "models": rows,
          "onnx_rtol_atol": ONNX_TOL, "torch_export_rel_tol": EXPORT_REL_TOL,
          "torch_export_batch": EXPORT_BATCH, "onnx_batch": 1,
          "mobilenetv2_refused": refused,
          "tt_lstm": {**lstm, "card": card}, "wall_s": wall_s})
    if wall_s >= EXPORT_WALL_LIMIT_S:
        raise AssertionError(f"the export phase took {wall_s:.1f} s, the "
                             f"limit is {EXPORT_WALL_LIMIT_S} s")


RECORDED_MS = {
    "first_version_ms_per_z_step": {"tucker2_factors_batched": 7.85,
                                    "dominant_left_subspace_batched": 15.13},
    "tucker2_before_its_redesign_ms_per_z_step": 3.97,
    # DeiT-tiny TK@2x's Z-step in the one-block-per-layer workspace plan
    "tucker2_workspace_plan_before_its_redesign_ms_per_z_step": 262.75,
    # DeiT-tiny TT@2x's subspace kernel per Z-step with its 13 workspace
    # launches on one block per layer
    "subspace_workspace_plan_before_its_redesign_ms_per_z_step": 66.29,
}


def kernel_summary(name, path, source, replaces, launches, rows,
                   library_key):
    """One entry of the kernels line: a kernel on one main path, with sums
    over `rows`, that path's launches of one Z-step."""
    return {
        "name": name, "path": path, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["kernel_ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound_us"] for r in rows) / 1000,
        "bound_by": ("operations" if sum(r["ops_us"] for r in rows)
                     >= sum(r["bytes_us"] for r in rows) else "bytes"),
        "library_ms": sum(r[library_key] for r in rows),
        "bound_share": (sum(r["bound_us"] for r in rows) / 1000
                        / sum(r["kernel_ms"] for r in rows))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this check needs the card")
        return 1
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdin=subprocess.DEVNULL, capture_output=True, text=True, timeout=60,
        check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "name": kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libraries = ("tucker2_factors", "tucker2_factors_ws", "subspace",
                 "subspace_ws")
    with concurrent.futures.ThreadPoolExecutor(4) as pool:  # nvcc x 4 at once
        infos = dict(zip(libraries, pool.map(build.build, libraries)))
    build_wall_s = time.perf_counter() - t0
    tk_lib, tk_ws_lib = tk._library(), tk._ws_library()
    sk_lib, sk_ws_lib = sk._library(), sk._ws_library()
    buckets = main_path_buckets()
    buckets_deit_tk = main_path_buckets(deit_program("tk"))
    if len(buckets_deit_tk) != 4:
        raise AssertionError(f"{len(buckets_deit_tk)} DeiT TK buckets, not 4")
    buckets_mbv2 = main_path_buckets(mbv2_program())
    mbv2_plans = sorted(tk.plan_name(*b[0][1:], *b[1:]) for b in buckets_mbv2)
    if mbv2_plans != ["resident"] * 4 + ["streamed"] + ["workspace"] * 11:
        raise AssertionError(f"MobileNetV2 SVD buckets' plans: {mbv2_plans}")
    buckets_r50 = main_path_buckets(r50_program("tk"))
    r50_plans = sorted(tk.plan_name(*b[0][1:], *b[1:]) for b in buckets_r50)
    if r50_plans != ["resident", "streamed"] + ["workspace"] * 13:
        raise AssertionError(f"ResNet-50 TK buckets' plans: {r50_plans}")
    buckets_r56 = main_path_buckets(_program("tk", "resnet56", "3"))
    r56_plans = [tk.plan_name(*b[0][1:], *b[1:]) for b in buckets_r56]
    if r56_plans != ["resident"] * 10:
        raise AssertionError(f"ResNet56 TK buckets' plans: {r56_plans}")
    # the zoo's plans: ImageNet MobileNetV2 SVD (the path) and TK, VGG16
    # TK (`pre_logits.fc1` among them), DenseNet121 and DenseNet40 TK, and
    # DeiT-tiny's automatic SVD plan (the svd_linear kind): (buckets, the
    # count of each Tucker-2 plan)
    zoo_tk = {}
    for key, model, fmt, want in (
            ("mbv2_inet_svd", "mobilenetv2", "svd",
             {"resident": 4, "workspace": 11}),
            ("mbv2_inet_tk", "mobilenetv2", "tk",
             {"resident": 8, "streamed": 1, "workspace": 12}),
            ("vgg16_tk", "vgg16", "tk", {"streamed": 1, "workspace": 8}),
            ("densenet121_tk", "densenet121", "tk", {"workspace": 4}),
            ("densenet40_tk", "densenet40", "tk",
             {"resident": 10, "streamed": 6, "workspace": 22}),
            ("deit_svd_auto", "deit_tiny_patch16_224", "svd",
             {"workspace": 4})):
        zoo_tk[key] = main_path_buckets(_program(fmt, model, "2"))
        plans = [tk.plan_name(*b[0][1:], *b[1:]) for b in zoo_tk[key]]
        if {p: plans.count(p) for p in set(plans)} != want:
            raise AssertionError(f"{key} buckets' plans: {plans}")
    if ((1, 49, 4096, 512), 256, 288) not in zoo_tk["vgg16_tk"]:
        raise AssertionError("VGG16 TK@2x has no pre_logits.fc1 bucket")
    tk_shapes = [*buckets, *NEAR_CAP_BUCKETS, *buckets_deit_tk,
                 *WS_EXTRA_BUCKETS, *buckets_mbv2, *buckets_r50, *buckets_r56,
                 *[b for bs in zoo_tk.values() for b in bs]]
    for shape, r0, r1 in tk_shapes:
        dims = (*shape[1:], r0, r1)
        if tk.block_plan_fits(*dims):
            planned = (tk_lib.tucker2_factors_smem_bytes(*dims), 0)
            want = (tk.smem_bytes(*dims), 0)
        else:  # the workspace plan, one cluster per layer
            planned = (tk_ws_lib.tucker2_factors_ws_smem_bytes(*dims),
                       tk_ws_lib.tucker2_factors_ws_floats(*dims),
                       tk_ws_lib.tucker2_factors_ws_cluster(*dims))
            ws = tk.ws_plan(*dims)
            want = (4 * ws.smem_floats, ws.ws_floats, ws.cluster)
        if planned != want:
            raise AssertionError(f"Tucker-2 plans differ at {shape} "
                                 f"{r0}/{r1}: {planned} != {want}")
        if not tk.kernel_supported(shape, r0, r1):
            raise AssertionError(f"Tucker-2 bucket {shape} fails the gate")
    for shape, r0, r1 in buckets:
        if not tk.resident_plan(*shape[1:], r0, r1):
            raise AssertionError(f"main-path bucket {shape} does not hold X")
    for shape, r0, r1 in [*buckets_deit_tk, *WS_EXTRA_BUCKETS]:
        if tk.block_plan_fits(*shape[1:], r0, r1):
            raise AssertionError(f"{shape} {r0}/{r1} fits a block")
    launches_tt = tt_launches()
    program_deit = deit_program()
    launches_deit = tt_launches(program_deit)
    if len(launches_deit) != 33:
        raise AssertionError(f"{len(launches_deit)} DeiT launches, not 33")
    program_r50 = r50_program()
    launches_r50 = tt_launches(program_r50)
    if len(launches_r50) != 27:  # 36 sweep steps, 9 of them full rank
        raise AssertionError(f"{len(launches_r50)} ResNet-50 launches, not 27")
    program_deit_s = deit_small_program()
    launches_deit_s = tt_launches(program_deit_s)
    deit_s_plans = [sk.plan_name(*shape[1:], r) for shape, r in launches_deit_s]
    if (len(launches_deit_s) != 24
            or deit_s_plans.count("workspace") != 16):
        raise AssertionError(f"DeiT-small launches' plans: {deit_s_plans}")
    program_r56_tt = _program("tt", "resnet56", "3")
    launches_r56_tt = tt_launches(program_r56_tt)
    if len(launches_r56_tt) != 18:  # 20 sweep steps, 2 of them full rank
        raise AssertionError(f"{len(launches_r56_tt)} ResNet56 TT launches, "
                             "not 18")
    program_mbv2_tt = _program("tt", "mobilenetv2", "2")
    launches_mbv2_tt = tt_launches(program_mbv2_tt)
    if len(program_mbv2_tt.groups) != 21 or len(launches_mbv2_tt) != 21:
        raise AssertionError(f"MobileNetV2 TT: {len(program_mbv2_tt.groups)}"
                             f" buckets, {len(launches_mbv2_tt)} launches")
    for (l, rows, cols), r in [*launches_tt, *launches_deit, *launches_r50,
                               *launches_deit_s, *launches_r56_tt,
                               *launches_mbv2_tt]:
        if sk.block_plan_fits(rows, cols, r):
            planned = (sk_lib.subspace_smem_bytes(rows, cols, r), 0)
            want = (sk.smem_bytes(rows, cols, r), 0)
        else:  # the workspace plan, one cluster per layer
            planned = (sk_ws_lib.subspace_ws_smem_bytes(rows, cols, r),
                       sk_ws_lib.subspace_ws_floats(rows, cols, r),
                       sk_ws_lib.subspace_ws_cluster())
            ws = sk.ws_plan(rows, cols, r)
            want = (4 * ws.smem_floats, ws.ws_floats, ws.cluster)
            # every layer's cluster at once, where the launch fits the card
            held = sk_ws_lib.subspace_ws_max_clusters(rows, cols, r)
            if held < 1 or (l * ws.cluster <= 132 and held < l):
                raise AssertionError(f"{[l, rows, cols]} r={r}: the card "
                                     f"holds {held} clusters of "
                                     f"{ws.cluster}, not {l}")
        if planned != want:
            raise AssertionError(f"plans differ at {[l, rows, cols]} r={r}: "
                                 f"{planned} != {want}")
        if not sk.subspace_supported((l, rows, cols), r):
            raise AssertionError(f"TT launch {[l, rows, cols]} fails the gate")

    def tk_plan_row(shape, r0, r1):
        dims = (*shape[1:], r0, r1)
        if tk.block_plan_fits(*dims):
            return [list(shape), r0, r1, tk.plan_name(*dims),
                    tk.smem_bytes(*dims)]
        ws = tk.ws_plan(*dims)
        return [list(shape), r0, r1, "workspace", 4 * ws.smem_floats,
                4 * ws.ws_floats * shape[0], list(ws.in_ws), ws.cluster]

    def plan_row(shape, r):
        _, rows, cols = shape
        if sk.block_plan_fits(rows, cols, r):
            return [list(shape), r, sk.plan_name(rows, cols, r),
                    sk.smem_bytes(rows, cols, r)]
        ws = sk.ws_plan(rows, cols, r)
        return [list(shape), r, "workspace", 4 * ws.smem_floats,
                4 * ws.ws_floats * shape[0], list(ws.in_ws), ws.cluster,
                sk_ws_lib.subspace_ws_max_clusters(rows, cols, r)]

    emit({"phase": "build", "wall_s": build_wall_s,
          "kernels": {name: {"build_seconds": i["seconds"],
                             "compiler_output": i["compiler_output"].splitlines()}
                      for name, i in infos.items()},
          "tk_buckets_shape_r0_r1_plan_smem_bytes_ws_bytes_cluster": [
              tk_plan_row(*b) for b in tk_shapes],
          "tt_launches": [plan_row(s, r) for s, r in launches_tt],
          "deit_launches_shape_r_plan_smem_bytes_ws_bytes_regions_"
          "cluster_max_active_clusters": [
              plan_row(s, r) for s, r in launches_deit],
          "r50_launches_shape_r_plan_smem_bytes_ws_bytes_regions_"
          "cluster_max_active_clusters": [
              plan_row(s, r) for s, r in launches_r50],
          "deit_s_launches_shape_r_plan_smem_bytes_ws_bytes_regions_"
          "cluster_max_active_clusters": [
              plan_row(s, r) for s, r in launches_deit_s],
          "r56_tt_launches_shape_r_plan_smem_bytes": [
              plan_row(s, r) for s, r in launches_r56_tt],
          "mbv2_inet_tt_launches_shape_r_plan_smem_bytes_ws_bytes_regions_"
          "cluster_max_active_clusters": [
              plan_row(s, r) for s, r in launches_mbv2_tt]})

    rows_tk = phase_kernel(args.seed, buckets, "resnet32 tk@3x")
    rows_deit_tk = phase_kernel(args.seed, buckets_deit_tk,
                                "deit_tiny_patch16_224 tk@2x",
                                extra=WS_EXTRA_BUCKETS,
                                extra_plan="workspace")
    rows_tt = phase_kernel_tt(args.seed, launches_tt, _program("tt"),
                              "resnet32 tt@3x")
    rows_deit = phase_kernel_tt(args.seed, launches_deit, program_deit,
                                "deit_tiny_patch16_224 tt@2x", near_cap=())
    rows_mbv2 = phase_kernel(args.seed, buckets_mbv2,
                             PATHS["mbv2_svd"]["name"], extra=(),
                             svd=True)
    rows_r50 = phase_kernel_tt(args.seed, launches_r50, program_r50,
                               PATHS["r50_tt3"]["name"], near_cap=())
    rows_r50_tk = phase_kernel(args.seed, buckets_r50, "resnet50 tk@3x",
                               extra=(), svd=True)
    launches_r50_tk = phase_zstep(args.seed, "resnet50", "tk", "3",
                                  len(buckets_r50))
    rows_deit_s = phase_kernel_tt(args.seed, launches_deit_s, program_deit_s,
                                  DEIT_S["name"], near_cap=())
    rows_r56 = phase_kernel(args.seed, buckets_r56, R56["name"], extra=())
    rows_r56_tt = phase_kernel_tt(args.seed, launches_r56_tt, program_r56_tt,
                                  "resnet56 tt@3x", near_cap=())
    phase_exact_rank(args.seed, "resnet56", "tk", "3", R56["name"],
                     len(buckets_r56))
    launches_r56_tt_main = phase_exact_rank(args.seed, "resnet56", "tt", "3",
                                            "resnet56 tt@3x",
                                            len(launches_r56_tt))
    # the zoo's kernel phases: every launch of each plan's Z-step against
    # its plain version, then one whole Z/U step of the plan from a seeded
    # dense init (its launches counted)
    zoo_names = {"mbv2_inet_tk": "mobilenetv2 tk@2x",
                 "vgg16_tk": "vgg16 tk@2x",
                 "densenet121_tk": "densenet121 tk@2x",
                 "densenet40_tk": "densenet40 tk@2x",
                 "deit_svd_auto": "deit_tiny_patch16_224 svd@2x (auto)"}
    rows_zoo, launches_zoo = {}, {}
    rows_zoo["mbv2_inet_svd"] = phase_kernel(
        args.seed, zoo_tk["mbv2_inet_svd"], PATHS["mbv2_inet_svd"]["name"],
        extra=(), svd=True)
    for key, (model, fmt) in (
            ("mbv2_inet_tk", ("mobilenetv2", "tk")),
            ("vgg16_tk", ("vgg16", "tk")),
            ("densenet121_tk", ("densenet121", "tk")),
            ("densenet40_tk", ("densenet40", "tk")),
            ("deit_svd_auto", ("deit_tiny_patch16_224", "svd"))):
        rows_zoo[key] = phase_kernel(args.seed, zoo_tk[key], zoo_names[key],
                                     extra=(), svd=True)
        launches_zoo[key] = phase_zstep(args.seed, model, fmt, "2",
                                        len(zoo_tk[key]))
    rows_mbv2_tt = phase_kernel_tt(args.seed, launches_mbv2_tt,
                                   program_mbv2_tt, "mobilenetv2 tt@2x",
                                   near_cap=())
    launches_mbv2_tt_z = phase_zstep(args.seed, "mobilenetv2", "tt", "2",
                                     len(launches_mbv2_tt))
    # each synthetic CIFAR set made once for all the phases that read it
    with shared_cifar_sets() as cifar_sets, \
            tempfile.TemporaryDirectory() as workdir:
        phase_stiefel(args.seed, smi)
        launches_tk_main = phase_main(args.seed, smi, "tk", len(buckets),
                                      workdir)
        launches_tt_main = phase_main(args.seed, smi, "tt", len(launches_tt),
                                      workdir)
        launches_deit_main = phase_main(args.seed, smi, "deit",
                                        len(launches_deit), workdir)
        launches_deit_tk_main = phase_main(args.seed, smi, "deit_tk",
                                           len(buckets_deit_tk), workdir)
        launches_mbv2_main = phase_main(args.seed, smi, "mbv2_svd",
                                        len(buckets_mbv2), workdir)
        launches_r50_main = phase_main(args.seed, smi, "r50_tt3",
                                       len(launches_r50), workdir)
        launches_deit_s_main = phase_deit_small(args.seed, smi,
                                                len(launches_deit_s), workdir)
        launches_r56_main = phase_r56(args.seed, smi, len(buckets_r56),
                                      workdir)
        launches_mbv2_inet_main = phase_main(
            args.seed, smi, "mbv2_inet_svd", len(zoo_tk["mbv2_inet_svd"]),
            workdir)
        launches_deit_recipe = phase_deit_recipe(args.seed, smi,
                                                 len(launches_deit), workdir)
        phase_nlp(args.seed, smi, workdir)
        phase_export(args.seed, smi, workdir)
        emit({"phase": "shared_sets", "made": [list(k) for k in cifar_sets]})

    emit({"phase": "total", "wall_s": time.perf_counter() - t_start})
    emit({"phase": "recorded", "source": "PERF.md, not this run",
          **RECORDED_MS})
    src = "dnn_compression_tensor_admm_tpu_torch/csrc/"
    ref = "dnn_compression_tensor_admm_tpu/ops/pallas/"
    # one entry per kernel and main path, each with that path's launches
    # and its times per Z-step; the ResNet32 entries keep the kernel's name
    entries = []
    # (every DeiT-TK bucket takes the workspace plan, its own source;
    # MobileNetV2 SVD's take both, against one batched SVD of each stack;
    # ResNet-50 TK's both, its K = 1 buckets against one batched SVD of
    # each stack and its K = 9 ones against the HOSVD yardstick; its
    # launches are those of the one Z/U step of `phase_zstep`)
    hosvd_key = "library_ms_hosvd_only_svd_of_both_unfoldings"
    for name, path, n, rows, source, library_key in (
            ("tucker2_factors_batched", "resnet32 tk@3x", launches_tk_main,
             rows_tk, src + "tucker2_factors.cu", hosvd_key),
            ("tucker2_factors_batched@deit_tk2", "deit_tiny_patch16_224 tk@2x",
             launches_deit_tk_main, rows_deit_tk,
             src + "tucker2_factors_ws.cu", hosvd_key),
            ("tucker2_factors_batched@mbv2_svd2", PATHS["mbv2_svd"]["name"],
             launches_mbv2_main, rows_mbv2,
             f"{src}tucker2_factors.cu, {src}tucker2_factors_ws.cu",
             "library_ms_batched_svd"),
            ("tucker2_factors_batched@r50_tk3", "resnet50 tk@3x",
             launches_r50_tk, rows_r50_tk,
             f"{src}tucker2_factors.cu, {src}tucker2_factors_ws.cu",
             "library_ms"),
            ("tucker2_factors_batched@r56_tk3", R56["name"],
             launches_r56_main, rows_r56, src + "tucker2_factors.cu",
             hosvd_key),
            ("tucker2_factors_batched@mbv2_inet_svd2",
             PATHS["mbv2_inet_svd"]["name"], launches_mbv2_inet_main,
             rows_zoo["mbv2_inet_svd"],
             f"{src}tucker2_factors.cu, {src}tucker2_factors_ws.cu",
             "library_ms_batched_svd"),
            *[(f"tucker2_factors_batched@{key}", zoo_names[key],
               launches_zoo[key], rows_zoo[key],
               f"{src}tucker2_factors.cu, {src}tucker2_factors_ws.cu",
               "library_ms") for key in zoo_names]):
        one = kernel_summary(name, path, source,
                             ref + "tucker_kernel.py:142", n, rows,
                             library_key)
        one["hosvd_ms"] = sum(r["hosvd_ms"] for r in rows)
        entries.append(one)
    # (13 DeiT-TT launches take the workspace plan, its own source)
    for name, path, n, rows, source in (
            ("dominant_left_subspace_batched", "resnet32 tt@3x",
             launches_tt_main, rows_tt, src + "subspace.cu"),
            ("dominant_left_subspace_batched@deit_tt2",
             "deit_tiny_patch16_224 tt@2x", launches_deit_main, rows_deit,
             f"{src}subspace.cu, {src}subspace_ws.cu"),
            # the run.sh recipe's path: the same 33 launches a Z-step
            ("dominant_left_subspace_batched@deit_tt2_recipe", DEIT_R["name"],
             launches_deit_recipe, rows_deit,
             f"{src}subspace.cu, {src}subspace_ws.cu"),
            ("dominant_left_subspace_batched@r50_tt3",
             PATHS["r50_tt3"]["name"], launches_r50_main, rows_r50,
             f"{src}subspace.cu, {src}subspace_ws.cu"),
            ("dominant_left_subspace_batched@deit_s_tt2", DEIT_S["name"],
             launches_deit_s_main, rows_deit_s,
             f"{src}subspace.cu, {src}subspace_ws.cu"),
            ("dominant_left_subspace_batched@r56_tt3", "resnet56 tt@3x",
             launches_r56_tt_main, rows_r56_tt, src + "subspace.cu"),
            ("dominant_left_subspace_batched@mbv2_inet_tt2",
             "mobilenetv2 tt@2x", launches_mbv2_tt_z, rows_mbv2_tt,
             f"{src}subspace.cu, {src}subspace_ws.cu")):
        one = kernel_summary(name, path, source,
                             ref + "subspace_kernel.py:85", n, rows,
                             "library_ms_batched_svd")
        one["gram_ms"] = sum(r["gram_ms"] for r in rows)
        entries.append(one)
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": count}})
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
