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
    """Resolve the plan for a model name, with or without format prefix."""
    from .. import models  # noqa: F401  (model modules register their plans)
    base = strip_format_prefix(model)
    key = (base, fmt, str(ratio), tt_type)
    if key not in _REGISTRY:
        avail = sorted(k for k in _REGISTRY if k[0] == base)
        raise KeyError(f"no rank plan for {key}; available for {base}: {avail}")
    return _REGISTRY[key]()
