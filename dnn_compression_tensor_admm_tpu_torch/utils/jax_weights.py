"""Weights across packages: JAX (flax) variables <-> the port's state dict.

The JAX variables are given as nested dicts of numpy arrays
({'params': ..., 'batch_stats': ...}). Layouts:

* conv ``kernel`` HWIO <-> ``weight`` OIHW (a depthwise [3, 3, 1, C]
  kernel is [C, 1, 3, 3]); Dense ``kernel`` [in, out] <-> Linear
  ``weight`` [out, in];
* BN ``scale``/``bias`` <-> ``weight``/``bias`` and ``mean``/``var`` <->
  ``running_mean``/``running_var`` (``num_batches_tracked`` is added as 0
  and dropped on the way back);
* TK ``core_kernel`` HWIO <-> OIHW; ``first_factor`` and ``last_factor``
  keep their layout, as a TK linear's ``core`` [r_out, r_in] does (its
  bias is a Dense-style ``bias``);
* SVD ``first_factor`` [r, I] and ``last_factor`` [O, r] keep their
  layout;
* TT ``core_kernel`` (the middle core as a conv kernel, [r_outL, r_in0]
  as O and I) HWIO <-> OIHW by the same rule; ``out_core_i`` and
  ``in_core_i`` ([r_i, n_i, r_{i+1}]) keep their layout;
* ViT: LayerNorm ``scale`` <-> ``weight``; the patch embedding's conv
  kernel HWIO <-> OIHW with its bias; ``cls_token``, ``pos_embed`` and a
  TT linear's ``core_i`` keep their layout.
* BERT (`nlp/`): Dense kernels transposed, LayerNorm ``scale`` <->
  ``weight``; the embedding tables, whose flax leaves hold a dot
  (``word_embeddings.weight``, ``position_embeddings.weight``,
  ``token_type_embeddings.weight``), TT and TTM cores, SVD factors, ket
  leaves (``weight_leafs``) and the shared-Tucker factors (``core``,
  ``factor_*``, ``bias``) keep their layout.

Flax module names may hold a dot ('layer1.0', 'bottlenecks.16',
'patch_embed.proj', 'mlp.fc1', inside an ImageNet ResNet block
'downsample.0' (its conv) and 'downsample.1' (its BN), MobileNetV2's
'features.3' and 'conv.6', VGG's 'features.28' and 'pre_logits.fc1', the
DenseNets' 'block2.layer.7', 'trans1.bn1' and
'features.denseblock3.denselayer12', BERT's 'encoder.layer.0',
'attention.self.query', 'attention.output.LayerNorm', 'intermediate.dense'
and 'pooler.dense'); on the way back a purely numeric name part is joined
to the part before it, and the other dotted module names (and BERT's
dotted embedding leaves) are joined whole.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..layers.common import canonical_param_name, hwio_to_oihw, oihw_to_hwio

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_BACK = {v: k for k, v in _STATS.items()}


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (str(k),))
        elif isinstance(v, torch.Tensor):  # a bfloat16 msgpack leaf
            yield path + (str(k),), v
        else:
            yield path + (str(k),), np.asarray(v)


def _tensor(a) -> torch.Tensor:
    """A tensor of its own (never a view of a checkpoint's buffer)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().clone()
    return torch.from_numpy(np.array(a))


def jax_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """JAX variables -> the port's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, a in _walk(variables.get("params", {})):
        leaf = path[-1]
        if leaf == "kernel" and a.ndim == 2:
            a = a.T
        elif leaf in ("kernel", "core_kernel") and a.ndim == 4:
            a = hwio_to_oihw(a)
        out[canonical_param_name(path)] = _tensor(a)
    for path, a in _walk(variables.get("batch_stats", {})):
        prefix = ".".join(path[:-1])
        out[f"{prefix}.{_STATS[path[-1]]}"] = _tensor(a)
        out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return out


# flax module names with dots that joining numeric parts alone does not
# rebuild: the ViT's, VGG's `pre_logits` and head, the CIFAR DenseNet's
# layers and transitions, the ImageNet DenseNet's `features.*` modules,
# BERT's layers and their linears and LayerNorms
_DOTTED = re.compile(
    r"patch_embed\.proj|mlp\.fc[12]|pre_logits\.fc[12]|head\.fc"
    r"|block\d+\.layer\.\d+|trans\d+\.(?:bn1|conv1)"
    r"|features\.(?:conv0|norm0|norm5|denseblock\d+\.denselayer\d+"
    r"|transition\d+\.(?:norm|conv))"
    r"|encoder\.layer\.\d+|attention\.self\.(?:query|key|value)"
    r"|(?:attention\.)?output\.(?:dense|LayerNorm)|intermediate\.dense"
    r"|pooler\.dense")
# flax parameter leaves with a dot: BERT's dense embedding tables
_DOTTED_LEAF = re.compile(r"(?:word|position|token_type)_embeddings\.weight")


def _jax_path(name: str):
    parts = []
    rest = name.split(".")
    leaf = None
    if len(rest) > 1 and _DOTTED_LEAF.fullmatch(".".join(rest[-2:])):
        leaf = ".".join(rest[-2:])
        rest = rest[:-2]
    while rest:
        # the longest dotted flax module name that starts here
        for j in range(len(rest) - 1, 1, -1):
            if _DOTTED.fullmatch(".".join(rest[:j])):
                parts.append(".".join(rest[:j]))
                rest = rest[j:]
                break
        else:
            p = rest.pop(0)
            if parts and p.isdigit():
                parts[-1] = f"{parts[-1]}.{p}"
            else:
                parts.append(p)
    return parts if leaf is None else parts + [leaf]


def _put(tree, path, value):
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def state_dict_to_jax(state_dict: Dict[str, torch.Tensor]):
    """The port's state dict -> JAX variables (nested numpy dicts)."""
    params: dict = {}
    stats: dict = {}
    for name, t in state_dict.items():
        path = _jax_path(name)
        leaf = path[-1]
        if leaf == "num_batches_tracked":
            continue
        a = np.array(t.detach().cpu().numpy())  # a copy, never a view
        if leaf in _STATS_BACK:
            _put(stats, path[:-1] + [_STATS_BACK[leaf]], a)
            continue
        if leaf == "weight":
            if a.ndim == 1:
                leaf = "scale"
            else:
                leaf = "kernel"
                a = a.T if a.ndim == 2 else oihw_to_hwio(a)
        elif leaf == "core_kernel":
            a = oihw_to_hwio(a)
        _put(params, path[:-1] + [leaf], np.ascontiguousarray(a))
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out
