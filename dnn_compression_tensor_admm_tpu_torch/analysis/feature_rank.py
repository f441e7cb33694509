"""Feature-rank analysis: singular-value spectra of intermediate
activations, compressed vs dense (counterpart of the JAX package's
`analysis/feature_rank.py`; reference ablation/compare_features.py).

The JAX package sows the raw conv outputs, before BatchNorm, of each
CIFAR `BasicBlock` (JAX `models/resnet_cifar.py:50`, :55); here forward
hooks on the same `conv1` and `conv2` modules capture the same tensors,
under the same keys (the flattened 'intermediates' path, e.g.
'layer1.0.layer1.0.conv1').
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.resnet_cifar import BasicBlock


def _captured(model: torch.nn.Module, x) -> Dict[str, torch.Tensor]:
    """The eval-mode forward's conv outputs on x (NCHW), by the JAX
    package's keys."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    x = x.to(next(model.parameters()).device, torch.float32)
    out: Dict[str, torch.Tensor] = {}
    hooks = []
    for name, block in model.named_modules():
        if isinstance(block, BasicBlock):
            for conv in ("conv1", "conv2"):
                key = f"{name}.{name}.{conv}"
                hooks.append(getattr(block, conv).register_forward_hook(
                    lambda _m, _i, y, key=key: out.__setitem__(key, y)))
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        model.train(training)
        for h in hooks:
            h.remove()
    return out


def activation_spectra(model: torch.nn.Module, x,
                       top_k: int = 32) -> Dict[str, np.ndarray]:
    """For each captured activation [B, C, H, W] the top-k singular values
    of its [B*H*W, C] unfolding (the per-layer 'feature rank' signature),
    computed on the model's device in float32."""
    out = {}
    for key, y in _captured(model, x).items():
        a = y.float().permute(0, 2, 3, 1).reshape(-1, y.shape[1])
        out[key] = torch.linalg.svdvals(a)[:top_k].cpu().numpy()
    return out


def compare_feature_ranks(dense_model: torch.nn.Module,
                          comp_model: torch.nn.Module, x,
                          energy: float = 0.99) -> Dict[str, dict]:
    """Effective rank (count of singular values covering `energy` of the
    spectrum) per captured layer, dense vs compressed."""
    def eff_rank(s):
        e = np.cumsum(s ** 2) / np.sum(s ** 2)
        return int(np.searchsorted(e, energy) + 1)

    d = activation_spectra(dense_model, x)
    c = activation_spectra(comp_model, x)
    return {k: {"dense_rank": eff_rank(d[k]), "compressed_rank": eff_rank(c[k])}
            for k in d if k in c}
