"""Rank-plan registry: (model, format, ratio, tt_type) -> RankPlan."""

from __future__ import annotations

import re
from typing import Callable, Dict, Tuple

from .hp import RankPlan

_REGISTRY: Dict[Tuple[str, str, str, str], Callable[[], RankPlan]] = {}


def register_plan(model: str, fmt: str, ratio: str, tt_type: str = "general"):
    """Decorator: register a zero-argument plan builder."""
    def deco(fn):
        _REGISTRY[(model, fmt, str(ratio), tt_type)] = fn
        return fn
    return deco


def strip_format_prefix(model: str) -> str:
    """'tkc_resnet32' -> 'resnet32'."""
    return re.sub(r"^(tt|tk|svd|stftk)(r|m|c)?_", "", model)


def get_rank_plan(model: str, fmt: str, ratio: str,
                  tt_type: str = "general") -> RankPlan:
    """Resolve the plan for a model name, with or without format prefix.

    A reference table wins; any other numeric ratio above 1 (a ratio
    registered without a table in the JSON too) falls back to the
    automatic planner, as the JAX package's resolver does. The Stiefel
    format 'stftk' takes the Tucker-2 plan."""
    from .. import models  # noqa: F401  (model modules register their plans)
    base = strip_format_prefix(model)
    if fmt == "stftk":
        fmt = "tk"
    key = (base, fmt, str(ratio), tt_type)
    if key in _REGISTRY:
        try:
            return _REGISTRY[key]()
        except KeyError:
            pass  # a registered ratio with no table: the automatic plan
    try:
        numeric = float(ratio)
    except (TypeError, ValueError):
        numeric = None
    if numeric is not None and numeric > 1.0:
        from .auto_plan import auto_rank_plan
        try:
            return auto_rank_plan(base, fmt, numeric, tt_type=tt_type)
        except KeyError:
            pass  # an unknown model: the catalog's error below
    avail = sorted(k for k in _REGISTRY if k[0] == base)
    raise KeyError(f"no rank plan for {key}; available for {base}: {avail}")
