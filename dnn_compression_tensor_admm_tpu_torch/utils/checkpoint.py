"""Model checkpoints: the JAX package's single-file msgpack (flax
`msgpack_serialize` of the variables dict; its `utils/checkpoint.py`) and
torch state dicts: the port's own, and the reference's and the JAX
package's `.pth` files (`utils/torch_import.py`).

`load_variables` and `save_variables` read and write the JAX layout
(nested dicts of arrays under 'params' and, for BatchNorm, 'batch_stats')
through the port's own codec (`utils/msgpack.py`), so a checkpoint that
a user trained with the JAX package loads here, and one written here loads
there. `utils/jax_weights.py` carries the variables to and from the
port's state dict.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import msgpack
from .jax_weights import jax_to_state_dict
from .torch_import import load_torch_state_dict, torch_to_state_dict

MSGPACK_SUFFIX = ".msgpack"
TORCH_SUFFIXES = (".pt", ".pth")


def load_variables(path: str):
    """The variables of a flax msgpack checkpoint: nested dicts of numpy
    arrays (bfloat16 leaves as torch tensors)."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def _as_arrays(tree):
    """numpy scalars as 0-d arrays, as the JAX package's `jax.device_get`
    of the tree before it serialises makes them."""
    if isinstance(tree, dict):
        return {k: _as_arrays(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_arrays(v) for v in tree]
    return np.asarray(tree) if isinstance(tree, np.generic) else tree


def save_variables(path: str, variables) -> None:
    """Write `variables` (nested dicts of numpy arrays or torch tensors) as
    the JAX package's `save_variables` would, byte for byte."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = msgpack.packb(_as_arrays(variables))
    with open(path, "wb") as f:
        f.write(data)


def load_any_variables(path: str,
                       template_fn: Optional[Callable[[], Dict[str, torch.Tensor]]]
                       = None) -> Dict[str, torch.Tensor]:
    """A state dict of the port from a `.msgpack` (JAX layout) or a
    `.pt`/`.pth` (a torch state dict: the port's own, or the reference's
    and the JAX package's naming, `utils/torch_import.py`) file. With
    `template_fn` (the model's own `state_dict`), the names and shapes
    must be the model's. A torch file is mapped onto them, so it needs
    `template_fn`."""
    if path.endswith(TORCH_SUFFIXES):
        if template_fn is None:
            raise ValueError("torch checkpoints need a model template")
        return torch_to_state_dict(load_torch_state_dict(path), template_fn())
    if not path.endswith(MSGPACK_SUFFIX):
        raise ValueError(f"{path}: a checkpoint is a {MSGPACK_SUFFIX} or "
                         f"{'/'.join(TORCH_SUFFIXES)} file")
    sd = jax_to_state_dict(load_variables(path))
    if template_fn is not None:
        want = {k: tuple(v.shape) for k, v in template_fn().items()}
        got = {k: tuple(v.shape) for k, v in sd.items()}
        if want != got:
            diff = sorted(set(want.items()) ^ set(got.items()))
            raise ValueError(f"{path} does not hold the model's tensors: "
                             f"{diff[:6]}")
    return sd
