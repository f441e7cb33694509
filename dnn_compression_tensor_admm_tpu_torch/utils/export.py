"""Deployable artifacts (counterpart of the JAX package's `utils/export.py`,
the role of the reference's ONNX converters, convert_onnx_resnet.py:66-78
and convert_onnx_vit.py:73-85).

* `torch.export` (`export_model`) where the JAX package writes StableHLO:
  the eval-mode forward at a fixed input shape as one program with the
  weights inside, saved with `torch.export.save` and run again from the
  file without the model's Python code (`load_exported`). The input is
  NCHW, the port's layout (the JAX artifact takes NHWC).
* A TF SavedModel (`export_savedmodel`) needs TensorFlow and jax2tf,
  which have no torch counterpart: it raises, naming `--export-onnx`
  (`utils/onnx_export.py`) as the route to the same ONNX.
"""

from __future__ import annotations

import io
import os
from typing import Optional, Sequence, Union

import torch


def export_model(model: torch.nn.Module, input_shape: Sequence[int],
                 path: Optional[str] = None) -> bytes:
    """Serialize the eval-mode forward of `model` at the fixed NCHW float32
    `input_shape`, on the model's device. Returns the bytes (and writes
    them to `path`)."""
    x = torch.zeros(tuple(input_shape),
                    device=next(model.parameters()).device)
    training = model.training
    model.eval()
    try:
        program = torch.export.export(model, (x,), strict=False)
    finally:
        model.train(training)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_exported(path_or_bytes: Union[str, bytes]):
    """The exported program of a file or its bytes; `.module()(x)` runs
    the model."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return torch.export.load(io.BytesIO(path_or_bytes))
    return torch.export.load(path_or_bytes)


def export_savedmodel(model, input_shape: Sequence[int], path: str) -> str:
    """A TF SavedModel needs TensorFlow and jax2tf; the port has neither."""
    raise RuntimeError(
        "SavedModel export needs tensorflow and jax2tf, which the port does "
        "not use; --export-onnx writes the ONNX model that a SavedModel was "
        "converted to, and --export a torch.export program")
