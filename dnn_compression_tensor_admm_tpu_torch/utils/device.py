"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device: str = "cuda") -> torch.device:
    """The device to run on; CUDA unless the caller asks for the CPU.
    Raises when CUDA is asked for and absent: nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev
