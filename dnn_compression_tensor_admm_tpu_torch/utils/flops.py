"""FLOPs and parameters of a model's forward (the JAX package's
`utils/flops.py`): `torch.utils.flop_counter.FlopCounterMode` counts the
products of every matmul, convolution and attention in one eval forward at
batch 1 (2 a multiply-add; elementwise ops and reductions are not
counted, where XLA's cost analysis counts them), and the parameters are
counted exactly."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


@torch.no_grad()
def model_flops_params(model: torch.nn.Module, input_shape) -> dict:
    """{'flops', 'params'} of `model`'s eval forward on zeros of
    `input_shape` (NCHW), on the model's device."""
    dev = next(model.parameters()).device
    was_training = model.training
    model.eval()
    counter = FlopCounterMode(display=False)
    with counter:
        model(torch.zeros(input_shape, device=dev))
    model.train(was_training)
    return {"flops": float(counter.get_total_flops()),
            "params": sum(p.numel() for p in model.parameters())}
