"""Model registry: builders by name, compressed names by prefix."""

from __future__ import annotations

import re
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}

# name prefix -> (format, execution mode)
_PREFIX = {
    "ttm": ("tt", "factorized"), "ttr": ("tt", "reconstruct"),
    "ttc": ("tt", "factorized"),
    "tkm": ("tk", "chain"), "tkc": ("tk", "chain"), "tkr": ("tk", "reconstruct"),
    "svdm": ("svd", "chain"), "svdc": ("svd", "chain"), "svdr": ("svd", "reconstruct"),
    "stftkc": ("stftk", "chain"),
}


def register_model(fn: Callable) -> Callable:
    _REGISTRY[fn.__name__] = fn
    return fn


def list_models():
    return sorted(_REGISTRY)


def parse_compressed_name(name: str):
    """'tkc_resnet32' -> ('resnet32', 'tk', 'chain'); dense names -> None."""
    m = re.match(r"^(ttm|ttr|ttc|tkm|tkc|tkr|svdm|svdc|svdr|stftkc)_(.+)$", name)
    if not m:
        return None
    fmt, mode = _PREFIX[m.group(1)]
    return m.group(2), fmt, mode


def create_model(name: str, **kwargs):
    """Build a model (on the CPU) by registered or compressed name."""
    if name in _REGISTRY:
        return _REGISTRY[name](**kwargs)
    parsed = parse_compressed_name(name)
    if parsed is not None:
        base, fmt, mode = parsed
        if base in _REGISTRY:
            return _REGISTRY[base](fmt=fmt, mode=mode, **kwargs)
    raise KeyError(f"unknown model {name!r}; known: {list_models()}")
