"""Shared naming and layout helpers for the layer library."""

from __future__ import annotations

from typing import Sequence, Tuple, Union

IntOrPair = Union[int, Tuple[int, int]]


def pair(v: IntOrPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def canonical_param_name(path: Sequence[str]) -> str:
    """Map a JAX (flax) parameter path to the state-dict name.

    ('layer1.0', 'conv1', 'kernel') -> 'layer1.0.conv1.weight'; the
    port's own modules already carry these names, so rank plans key
    both packages alike."""
    parts = [str(p) for p in path]
    if parts and parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def hwio_to_oihw(k):
    """Conv kernel layout HWIO -> OIHW (numpy array or torch tensor)."""
    return k.permute(3, 2, 0, 1) if hasattr(k, "permute") else k.transpose(3, 2, 0, 1)


def oihw_to_hwio(k):
    """Conv kernel layout OIHW -> HWIO (numpy array or torch tensor)."""
    return k.permute(2, 3, 1, 0) if hasattr(k, "permute") else k.transpose(2, 3, 1, 0)
