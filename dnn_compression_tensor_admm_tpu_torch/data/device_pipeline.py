"""Device-resident dataset sampling and augmentation.

The uint8 dataset lives on the device whole; a step slices the epoch
permutation, gathers its rows, and pad-crops, flips and normalises them
there. Crop and flip are one gather (the JAX package's one-hot matmuls
are a TPU idiom). Output is NCHW float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def batch_at(x: torch.Tensor, step: int, batch_size: int) -> torch.Tensor:
    """Contiguous batch `step` of `x` (dim 0): start (step*B) % (n-B+1).

    With the default steps_per_epoch = n // B the tail rows are dropped;
    more steps wrap and re-read mid-dataset rows."""
    n = x.shape[0]
    start = (step * batch_size) % max(n - batch_size + 1, 1)
    return x[start:start + batch_size]


def random_crop_flip(batch_size: int, generator: torch.Generator,
                     pad: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop offsets [B, 2] in [0, 2*pad] and flip bits [B], drawn on the
    generator's device."""
    dev = generator.device
    offsets = torch.randint(0, 2 * pad + 1, (batch_size, 2), device=dev,
                            generator=generator)
    flips = torch.rand(batch_size, device=dev, generator=generator) < 0.5
    return offsets, flips


def normalize(x: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    """uint8 NHWC -> normalised float32 NCHW."""
    m = torch.tensor(mean, dtype=torch.float32, device=x.device) * 255.0
    s = torch.tensor(std, dtype=torch.float32, device=x.device) * 255.0
    return ((x.float() - m) / s).permute(0, 3, 1, 2).contiguous()


def augment_batch(x_u8: torch.Tensor, offsets: torch.Tensor,
                  flips: torch.Tensor, *, mean: Sequence[float],
                  std: Sequence[float], pad: int = 4) -> torch.Tensor:
    """Zero-pad `pad` pixels, crop back at `offsets` (rows, cols), flip
    the samples whose bit is set, normalise: torchvision's
    RandomCrop(32, 4) + RandomHorizontalFlip + ToTensor + Normalize."""
    b, h, w, _ = x_u8.shape
    xp = torch.nn.functional.pad(x_u8, (0, 0, pad, pad, pad, pad))
    ar_h = torch.arange(h, device=x_u8.device)
    ar_w = torch.arange(w, device=x_u8.device)
    rows = offsets[:, 0:1] + ar_h                       # [B, H]
    cols = torch.where(flips[:, None], offsets[:, 1:2] + (w - 1) - ar_w,
                       offsets[:, 1:2] + ar_w)          # [B, W]
    bidx = torch.arange(b, device=x_u8.device)[:, None, None]
    return normalize(xp[bidx, rows[:, :, None], cols[:, None, :]], mean, std)
