"""Analytic FLOPs/params cost models for factorized layers (counterpart of
the JAX package's `analysis/flops.py`: integer arithmetic on the same
specs, `configs/hp.py`).

Mirrors the reference's per-layer accounting (`forward_flops`:
TTConv.py:155-195, TKConv.py:111-134, SVDConv.py:199-219; analytic
scripts ablation/compare_tt_fc.py, xcompression/compute_flops_params.py).
FLOPs are multiply-accumulate counts per single input sample (spatial
dims of the *output* feature map, like the reference).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

from ..configs.hp import SVDSpec, TKSpec, TTConvSpec, TTLinearSpec


def dense_conv_cost(out_hw: Tuple[int, int], in_ch, out_ch, kh, kw):
    params = in_ch * out_ch * kh * kw
    flops = out_hw[0] * out_hw[1] * params
    return params, flops


def dense_linear_cost(in_f, out_f):
    return in_f * out_f, in_f * out_f


def tt_conv_cost(spec: TTConvSpec, out_hw: Tuple[int, int],
                 in_hw: Tuple[int, int] = None):
    """Factorized-forward cost (TTConv.py:155-195): in-core chain applied
    at input resolution, core conv + out-core chain at output resolution."""
    in_hw = in_hw or out_hw
    params = 0
    flops = 0
    # in cores contract at input resolution
    for i in range(len(spec.in_shapes)):
        r0, n, r1 = spec.in_ranks[i], spec.in_shapes[i], spec.in_ranks[i + 1]
        params += r0 * n * r1
        flops += in_hw[0] * in_hw[1] * r0 * n * r1 * (
            math.prod(spec.in_shapes[:i]) if i > 0 else 1)
    # core conv
    kh_kw = spec.filter_dim
    core = spec.out_ranks[-1] * spec.in_ranks[0] * kh_kw
    params += core
    flops += out_hw[0] * out_hw[1] * core
    # out cores at output resolution
    for i in range(len(spec.out_shapes)):
        r0, n, r1 = spec.out_ranks[i], spec.out_shapes[i], spec.out_ranks[i + 1]
        params += r0 * n * r1
        flops += out_hw[0] * out_hw[1] * r0 * n * r1 * (
            math.prod(spec.out_shapes[i + 1:]))
    return params, flops


def tk_conv_cost(spec: TKSpec, out_hw: Tuple[int, int], in_ch: int,
                 out_ch: int, kh: int, kw: int,
                 in_hw: Tuple[int, int] = None):
    """Chain-of-convs cost (TKConv.py:111-134)."""
    in_hw = in_hw or out_hw
    sp = spec.clamped((out_ch, in_ch, kh, kw))
    p1 = sp.in_rank * in_ch
    p2 = sp.out_rank * sp.in_rank * kh * kw
    p3 = out_ch * sp.out_rank
    flops = in_hw[0] * in_hw[1] * p1 + out_hw[0] * out_hw[1] * (p2 + p3)
    return p1 + p2 + p3, flops


def svd_conv_cost(spec: SVDSpec, out_hw: Tuple[int, int], in_ch: int,
                  out_ch: int):
    p = spec.rank * (in_ch + out_ch)
    return p, out_hw[0] * out_hw[1] * p


def tt_linear_cost(spec: TTLinearSpec):
    """Merged-matmul schedule cost (layers/tt_linear.py): core params plus
    the two activation matmuls through the mid rank."""
    params = sum(spec.tt_ranks[i] * spec.tt_shapes[i] * spec.tt_ranks[i + 1]
                 for i in range(len(spec.tt_shapes)))
    m = spec.mid_rank
    flops = m * (spec.in_features + spec.out_features)
    return params, flops


def ttm_linear_cost(input_tt_shape: Sequence[int],
                    output_tt_shape: Sequence[int],
                    tt_ranks: Sequence[int]):
    params = sum(tt_ranks[i] * input_tt_shape[i] * output_tt_shape[i] *
                 tt_ranks[i + 1] for i in range(len(input_tt_shape)))
    # reconstruct-then-matmul schedule
    flops = math.prod(input_tt_shape) * math.prod(output_tt_shape)
    return params, flops


_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _parameters(model_or_state_dict) -> Dict[str, torch.Tensor]:
    """The trainable tensors by name: a module's parameters, or a state
    dict without BatchNorm's statistics (the JAX 'params' collection)."""
    if isinstance(model_or_state_dict, torch.nn.Module):
        return dict(model_or_state_dict.named_parameters())
    return {k: v for k, v in model_or_state_dict.items()
            if not k.endswith(_BUFFERS)}


def model_compression_report(dense, compressed, plan) -> dict:
    """Whole-model parameter accounting: total dense vs compressed, and
    the targeted-layers-only ratio (the number the hp dicts are tuned to).
    `dense` and `compressed` are port models or their state dicts."""
    modules = {n.rsplit(".", 1)[0] for n in plan.names()}

    def targeted(params):
        return sum(a.numel() for name, a in params.items()
                   if name.rsplit(".", 1)[0] in modules)

    dp, cp = _parameters(dense), _parameters(compressed)
    d_total = sum(a.numel() for a in dp.values())
    c_total = sum(a.numel() for a in cp.values())
    d_t, c_t = targeted(dp), targeted(cp)
    return {
        "dense_params": d_total,
        "compressed_params": c_total,
        "overall_ratio": d_total / c_total,
        "targeted_dense_params": d_t,
        "targeted_compressed_params": c_t,
        "targeted_ratio": d_t / max(1, c_t),
    }
