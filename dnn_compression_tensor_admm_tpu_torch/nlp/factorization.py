"""Automatic tensorization: shape factorization + rank-from-ratio solvers
(a copy of the JAX package's `nlp/factorization.py` returning the port's
own `configs/hp.py` specs).

Semantics match the reference (xcompression/transformer/TTLinear.py):

* `get_factors` — prime factorization (TTLinear.py:17-28).
* `split_to_factors` — greedy balanced split of a feature size into `dim`
  factors, descending (TTLinear.py:31-63).
* `compute_ranks_tt` — uniform TT rank from a target compression ratio by
  solving a*r^2 + b*r = params/ratio (quadratic formula,
  TTLinear.py:106-135).
* `compute_rank_svd` — rank = in*out / (ratio * (in+out))
  (SVDLinear.py:27).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np

from ..configs.hp import SVDSpec, TTLinearSpec


def get_factors(n: int) -> List[int]:
    """Prime factorization of n, ascending (last repeated factor folded)."""
    factors = []
    k = 2
    m = n
    while k * k <= m:
        while m % k == 0:
            factors.append(k)
            m //= k
        k += 1
    if m > 1:
        factors.append(m)
    return factors if factors else [1]


def split_to_factors(feature_size: int, dim: int) -> List[int]:
    """Split `feature_size` into `dim` balanced integer factors, descending.

    Greedy over the prime factorization: repeatedly take the largest
    remaining prime if it already exceeds the running geometric-mean
    target, else merge small primes up toward the target (the reference's
    two-pointer merge, TTLinear.py:31-63).
    """
    if dim == 1:
        return [feature_size]
    primes = get_factors(feature_size)
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
        rem = feature_size / int(np.prod(out))
        if i < dim:
            avg = int(rem ** (1.0 / (dim - i)))
    # distribute any leftover primes into the last slot
    prod = int(np.prod(out))
    if prod != feature_size:
        out[min(i, dim - 1)] *= feature_size // prod
    return sorted((int(v) for v in out), reverse=True)


def compute_ranks_tt(tt_shapes: Sequence[int], ratio: float) -> List[int]:
    """Uniform internal TT rank achieving ~`ratio` parameter compression.

    params(r) = sum_i n_i * r_{i} * r_{i+1} with boundary ranks 1; with a
    uniform internal rank r this is a*r^2 + b*r where a = sum of interior
    shapes and b = n_0 + n_{d-1}; solve for params(r) = prod(n)/ratio
    (reference TTLinear.py:106-135).
    """
    shapes = list(tt_shapes)
    param = float(np.prod(shapes))
    d = len(shapes)
    c = param / ratio
    if d == 2:
        r = int(param / (ratio * sum(shapes)))
        return [1, max(1, r), 1]
    b = shapes[0] + shapes[-1]
    a = sum(shapes[1:-1])
    r = int((math.sqrt(b * b + 4 * a * c) - b) / (2 * a))
    return [1] + [max(1, r)] * (d - 1) + [1]


def compute_rank_svd(in_features: int, out_features: int, ratio: float) -> int:
    return max(1, int(in_features * out_features /
                      (ratio * (in_features + out_features))))


def tt_linear_spec_from_ratio(in_features: int, out_features: int,
                              ratio: float, dim: int = 2) -> TTLinearSpec:
    """Build a TTLinearSpec with auto shapes + ratio-solved ranks (the
    reference's `TTLinear(compression_ratio=...)` path, TTLinear.py:140-165)."""
    out_shapes = split_to_factors(out_features, dim)
    in_shapes = split_to_factors(in_features, dim)
    shapes = tuple(out_shapes + in_shapes)
    ranks = tuple(compute_ranks_tt(shapes, ratio))
    return TTLinearSpec.create(shapes, ranks, out_features)


def svd_spec_from_ratio(in_features: int, out_features: int,
                        ratio: float) -> SVDSpec:
    return SVDSpec(compute_rank_svd(in_features, out_features, ratio))
