"""Full-float32 products for the decomposition and ADMM math.

The JAX package runs this math at f32-HIGHEST precision
(`ops/_precision.py::mm`, the Pallas `_dot`). On the card a float32
matmul or convolution may run in TF32 when the process allows it;
`full_f32()` turns TF32 off for the code inside it and restores the
caller's setting after, so the X-step and the fine-tune keep whatever
precision the process chose. It is a context manager and a decorator.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Disallow TF32 in matmuls and cuDNN convolutions inside the block."""
    matmul = torch.backends.cuda.matmul
    cudnn = torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved
