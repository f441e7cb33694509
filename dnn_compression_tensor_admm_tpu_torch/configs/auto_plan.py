"""Automatic rank planning for vision models (counterpart of the JAX
package's `configs/auto_plan.py`).

Hand-tuned tables exist for a subset of the (model, format, ratio) grid;
for any other numeric ratio above 1 the resolver falls back to this
planner. It walks the dense model's weight shapes, built on the meta
device (the shapes without memory or compute), and solves per-layer ranks
that hit the target parameter ratio.

Policy (the JAX package's):
* convs on RGB input (stems) and classifier heads stay dense;
* depthwise convs (one input channel per group) stay dense;
* 1x1 convs under TK or TT fall back to plain SVD;
* layers under `_MIN_PARAMS` stay dense;
* residual projection branches ('downsample') are never compressed.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import torch

from .hp import RankPlan, SVDSpec, TKSpec, TTConvSpec, TTLinearSpec

_HEAD_NAMES = frozenset({"fc.weight", "head.weight", "classifier.weight",
                         "classifier.1.weight", "head.fc.weight",
                         "linear.weight"})
# the JAX package's `auto_rank_plan` defaults (JAX `configs/auto_plan.py`
# :140-141), the only values its resolver calls it with: TT splits each
# channel count into two factors (`dim=2`), and a layer under 4096
# weights stays dense (`min_params`)
_TT_DIM = 2
_MIN_PARAMS = 4096


@functools.lru_cache(maxsize=32)
def layer_inventory(model: str) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """(state-dict name, logical weight shape) of each compressible layer:
    convs as [O, I, kh, kw], linears as [out, in]. A conv weight on the
    meta device is OIHW with I the channels per group, so a stem (I = 3)
    and a depthwise conv (I = 1) both fall under I <= 3."""
    from ..models.registry import create_model

    with torch.device("meta"):
        net = create_model(model)
    out: List[Tuple[str, Tuple[int, ...]]] = []
    for name, w in sorted(net.named_parameters()):
        if not name.endswith(".weight") or "downsample" in name:
            continue
        if w.dim() == 4:
            if w.shape[1] <= 3:
                continue
            out.append((name, tuple(w.shape)))
        elif w.dim() == 2:
            if name in _HEAD_NAMES or name.split(".")[-2:] == ["head",
                                                               "weight"]:
                continue
            out.append((name, tuple(w.shape)))
    return tuple(out)


def _get_factors(n: int) -> List[int]:
    """Prime factorization of n, ascending ([1] for n = 1)."""
    factors = []
    k, m = 2, n
    while k * k <= m:
        while m % k == 0:
            factors.append(k)
            m //= k
        k += 1
    if m > 1:
        factors.append(m)
    return factors if factors else [1]


def split_to_factors(feature_size: int, dim: int) -> List[int]:
    """`feature_size` as `dim` balanced integer factors, descending: the
    largest remaining prime where it reaches the running geometric-mean
    target, else small primes merged up toward it (the JAX package's
    `nlp/factorization.py::split_to_factors`)."""
    if dim == 1:
        return [feature_size]
    primes = _get_factors(feature_size)
    out = [1] * dim
    lo, hi = 0, len(primes) - 1
    i = 0
    avg = int(feature_size ** (1.0 / dim))
    while hi >= lo and i < dim:
        if primes[hi] >= avg:
            out[i] = primes[hi]
            hi -= 1
        else:
            cur = primes[hi] * primes[lo]
            lo += 1
            while cur < avg and hi > lo:
                t = cur * primes[lo]
                if (t - avg) > (avg - cur):
                    break
                cur = t
                lo += 1
            out[i] = cur
            hi -= 1
        i += 1
        rem = feature_size / math.prod(out)
        if i < dim:
            avg = int(rem ** (1.0 / (dim - i)))
    prod = math.prod(out)
    if prod != feature_size:  # leftover primes go into the last slot
        out[min(i, dim - 1)] *= feature_size // prod
    return sorted(out, reverse=True)


def _tk_ranks(o: int, i: int, k: int, ratio: float) -> TKSpec:
    """alpha from alpha*(O^2 + I^2) + alpha^2*O*I*k = O*I*k/ratio, then
    (out_rank, in_rank) = alpha*(O, I): a Tucker-2 conv holds
    O*ro + I*ri + ro*ri*k parameters."""
    a = float(o * i * k)
    b = float(o * o + i * i)
    c = float(o * i * k) / ratio
    alpha = (-b + math.sqrt(b * b + 4.0 * a * c)) / (2.0 * a)
    ro = max(1, round(alpha * o))
    ri = max(1, round(alpha * i))
    return TKSpec(min(ro, o), min(ri, i))


def _tt_ranks(shapes: Tuple[int, ...], ratio: float) -> Tuple[int, ...]:
    """The largest uniform TT rank, clamped to the prefix and suffix
    products, whose parameters stay within prod(shapes) / ratio."""
    d = len(shapes)
    caps = [min(math.prod(shapes[:j]), math.prod(shapes[j:]))
            for j in range(d + 1)]
    target = math.prod(shapes) / ratio

    def params(r: int) -> int:
        rv = [min(c, r) for c in caps]
        return sum(shapes[j] * rv[j] * rv[j + 1] for j in range(d))

    lo, hi = 1, max(caps)
    while lo < hi:  # the largest r with params(r) <= target
        mid = (lo + hi + 1) // 2
        if params(mid) <= target:
            lo = mid
        else:
            hi = mid - 1
    return tuple(min(c, lo) for c in caps)


def _svd_rank(in_f: int, out_f: int, ratio: float) -> SVDSpec:
    """rank = in * out / (ratio * (in + out)), at least 1, at most
    min(in, out)."""
    r = max(1, int(in_f * out_f / (ratio * (in_f + out_f))))
    return SVDSpec(min(r, in_f, out_f))


def auto_rank_plan(model: str, fmt: str, ratio: float, *,
                   tt_type: str = "general") -> RankPlan:
    """A RankPlan for any registered dense model at a numeric ratio > 1."""
    ratio = float(ratio)
    if ratio <= 1.0:
        raise ValueError(f"auto plan needs ratio > 1, got {ratio}")
    layers: Dict[str, object] = {}
    for name, shape in layer_inventory(model):
        if math.prod(shape) < _MIN_PARAMS:
            continue
        if len(shape) == 4:
            o, i, kh, kw = shape
            k = kh * kw
            if fmt == "svd" or (k == 1 and fmt in ("tk", "tt")):
                layers[name] = _svd_rank(i * k, o, ratio)
            elif fmt == "tk":
                layers[name] = _tk_ranks(o, i, k, ratio)
            elif fmt == "tt":
                shapes = ((o, k, i) if tt_type == "special" else
                          tuple(split_to_factors(o, _TT_DIM) + [k]
                                + split_to_factors(i, _TT_DIM)))
                layers[name] = TTConvSpec.create(
                    shapes, _tt_ranks(shapes, ratio), o)
            else:
                raise ValueError(f"unknown format {fmt!r}")
        else:
            o, i = shape
            if fmt == "svd":
                layers[name] = _svd_rank(i, o, ratio)
            elif fmt == "tk":
                layers[name] = _tk_ranks(o, i, 1, ratio)
            elif fmt == "tt":
                shapes = tuple(split_to_factors(o, _TT_DIM)
                               + split_to_factors(i, _TT_DIM))
                layers[name] = TTLinearSpec.create(
                    shapes, _tt_ranks(shapes, ratio), o)
            else:
                raise ValueError(f"unknown format {fmt!r}")
    if not layers:
        raise ValueError(f"auto plan found no compressible layers in {model}")
    return RankPlan(fmt, layers)
