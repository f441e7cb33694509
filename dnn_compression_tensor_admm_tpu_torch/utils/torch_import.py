"""PyTorch `.pth` checkpoints under the reference's naming (counterpart of
the JAX package's `utils/torch_import.py`).

The reference's decompose phase reads torch state dicts, and the JAX
package reads and writes them under the reference's names
(`variables_to_torch`): the port's own parameter names, with two
differences of layout that this module takes away:

* a factorized conv's ``core_kernel`` is HWIO there (the JAX package
  transposes only leaves named ``kernel``) and OIHW in the port;
* BatchNorm's ``num_batches_tracked`` is absent there (0 here, as
  `utils/jax_weights.py` makes it).

- :func:`load_torch_state_dict` reads a ``.pth``/``.pt`` file into a
  flat ``{name: tensor}`` dict (``{'state_dict': ...}``, ``{'model':
  ...}`` and ``{'model_state': ...}`` unwrapped; bfloat16 widened).
- :func:`torch_to_state_dict` maps it onto the port's state dict (a
  template: names, shapes, dtypes), strictly or keeping the template's
  tensor where the file has none (a new head).
- :func:`state_dict_to_torch` is the inverse: the names, shapes and
  values the JAX package's ``variables_to_torch`` gives for the same
  weights. :func:`save_torch_state_dict` writes it.

Unlike the JAX package there is no torch-free reader: the port always
has torch.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from ..layers.common import hwio_to_oihw, oihw_to_hwio

_NBT = "num_batches_tracked"
_CORE = "core_kernel"


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a torch checkpoint into ``{name: tensor}`` (weights only)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "model_state"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    out = {}
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            out[str(k)] = v.float() if v.dtype == torch.bfloat16 else v
    return out


def _core_layout(state_dict: Mapping[str, torch.Tensor],
                 template: Mapping[str, torch.Tensor]) -> str:
    """'hwio' (the reference's naming) or 'oihw' (the port's own state
    dict): the layout in which every core kernel of the file fits the
    template. Where both fit (every core square in all four dims), a file
    with BatchNorm counters is the port's own."""
    cores = [k for k in template if k.endswith(_CORE) and k in state_dict
             and state_dict[k].ndim == 4]
    oihw = all(tuple(state_dict[k].shape) == tuple(template[k].shape)
               for k in cores)
    hwio = all(tuple(hwio_to_oihw(state_dict[k]).shape)
               == tuple(template[k].shape) for k in cores)
    if oihw and hwio:
        return "oihw" if any(k.endswith(_NBT) for k in state_dict) else "hwio"
    return "hwio" if hwio else "oihw"


def torch_to_state_dict(state_dict: Mapping[str, torch.Tensor],
                        template: Mapping[str, torch.Tensor],
                        strict: bool = True) -> Dict[str, torch.Tensor]:
    """The port's state dict (the template's names, shapes and dtypes)
    from a torch state dict under the reference's or the port's naming.

    ``strict`` raises `KeyError` for a template tensor the file lacks and
    for a file tensor the template lacks (BatchNorm counters aside); not
    strict keeps the template's tensor where the file has none, as
    ``load_state_dict(strict=False)`` does."""
    layout = _core_layout(state_dict, template)
    out, missing = {}, []
    for name, leaf in template.items():
        if name not in state_dict:
            if name.endswith(_NBT):
                out[name] = torch.zeros_like(leaf, device="cpu")
            else:
                missing.append(name)
                out[name] = leaf.detach().cpu().clone()
            continue
        a = state_dict[name]
        if layout == "hwio" and name.endswith(_CORE) and a.ndim == 4:
            a = hwio_to_oihw(a)
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: torch shape "
                             f"{tuple(state_dict[name].shape)} maps to "
                             f"{tuple(a.shape)}, the model has "
                             f"{tuple(leaf.shape)}")
        out[name] = a.to(leaf.dtype).contiguous().clone()
    if strict and missing:
        raise KeyError(f"torch checkpoint is missing {len(missing)} "
                       f"parameters, e.g. {missing[:5]}")
    unused = [k for k in state_dict if k not in template
              and not k.endswith(_NBT)]
    if strict and unused:
        raise KeyError(f"torch checkpoint has {len(unused)} unmapped "
                       f"tensors, e.g. {unused[:5]}")
    return out


def state_dict_to_torch(model_or_state_dict: Union[torch.nn.Module,
                                                   Mapping[str, torch.Tensor]]
                        ) -> Dict[str, np.ndarray]:
    """The weights under the reference's torch naming, as the JAX
    package's ``variables_to_torch`` gives them: core kernels HWIO, no
    BatchNorm counters."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    out = {}
    for name, t in sd.items():
        if name.endswith(_NBT):
            continue
        a = np.array(t.detach().cpu().numpy())
        if name.endswith(_CORE) and a.ndim == 4:
            a = np.ascontiguousarray(oihw_to_hwio(a))
        out[name] = a
    return out


def save_torch_state_dict(path: str,
                          state_dict: Mapping[str, np.ndarray]) -> None:
    """Write ``state_dict`` (arrays, e.g. `state_dict_to_torch`'s) as a
    torch-loadable ``.pth``."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in state_dict.items()}, path)
