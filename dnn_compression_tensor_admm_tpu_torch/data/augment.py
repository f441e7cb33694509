"""Batch augmentations on the device: Mixup/CutMix, RandAugment and
RandomErasing (counterpart of the JAX package's `data/augment.py`, timm's
recipe for DeiT: `--mixup 0.8 --cutmix 1.0 --aa rand-m9-mstd0.5-inc1
--reprob 0.25`).

Each augmentation is split in two: a `draw_*` function takes every random
number it needs from an explicit `torch.Generator`, and the apply function
is deterministic in those draws. So the same draws can be fed to this
module and to the JAX package's functions. Images are NCHW float32.

Every draw is made on the device of its generator, Mixup/CutMix's too
(one lambda a batch, timm's batch mode): a step that augments reads
nothing to the host, so it can be captured in a CUDA graph and replayed.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, device: torch.device) -> torch.Tensor:
    """float32 `values` on `device`, copied there once: a step captured in
    a CUDA graph may not copy from the host, so the eager step before the
    capture makes every constant the step uses."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _one_hot_smoothed(labels: torch.Tensor, num_classes: int,
                      smoothing: float) -> torch.Tensor:
    """1 - s + s/C on the label, s/C elsewhere (float32 [B, C])."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


# ---------------------------------------------------------------------------
# Mixup / CutMix


@dataclasses.dataclass(frozen=True)
class MixDraws:
    """One batch's Mixup/CutMix draws: which of the two (a bool where only
    one is on, else a 0-d bool tensor), each one's lambda, the box centre
    (row, column) of CutMix, and `failed`, the count of its Beta draws in
    which no candidate was accepted (`sample_beta`). The numbers are 0-d
    tensors on the device, or Python numbers (the tests feed the JAX
    package's draws)."""
    use_cutmix: Union[bool, torch.Tensor]
    lam_mix: Union[float, torch.Tensor]
    lam_cut: Union[float, torch.Tensor]
    cy: Union[int, torch.Tensor]
    cx: Union[int, torch.Tensor]
    failed: Optional[torch.Tensor] = None


BETA_CANDIDATES = 256  # Johnk candidate pairs a Beta draw


def sample_beta(alpha: float, generator: torch.Generator, shape=(),
                candidates: int = BETA_CANDIDATES):
    """Beta(alpha, alpha) numbers of `shape` on `generator`'s device, by
    Johnk's method in log space over a fixed number of candidate pairs of
    float64 uniforms each: x = u^(1/a), y = v^(1/a), accepted where
    x + y <= 1, the value x / (x + y) of the first accepted pair. No host
    read, no loop. -> (float32 values, int64 count of the numbers with no
    accepted candidate, which take their first pair's ratio).

    A pair is accepted with probability G(a + 1)^2 / G(2a + 1), so a
    number has no accepted pair of 256 with probability 1e-333 at
    a = 0.2, 1.7e-104 at 0.8, 8.6e-78 at 1.0 and 5.4e-21 at 2.0 (run.sh
    passes 0.8 and 1.0; a zero alpha is 1e-6, accepted at once): the
    count is 0 in law at the alphas users pass, and reports a draw that
    failed all the same."""
    uv = torch.rand((*shape, candidates, 2), dtype=torch.float64,
                    device=generator.device, generator=generator)
    logs = uv.log() / alpha
    m = logs.amax(-1, keepdim=True)
    e = (logs - m).exp()
    s = e.sum(-1)
    ok = (m.squeeze(-1) + s.log() <= 0.0) & (uv > 0).all(-1)
    first = ok.int().argmax(-1, keepdim=True)  # the first accepted, or 0
    value = (e[..., 0] / s).gather(-1, first).squeeze(-1)
    return value.float(), (~ok.any(-1)).sum()


SWITCH_PROB = 0.5  # CutMix's share of the batches where both are on


def draw_mix(generator: torch.Generator, h: int, w: int, *,
             mixup_alpha: float, cutmix_alpha: float) -> MixDraws:
    """The draws of `mixup_cutmix`, on `generator`'s device: CutMix with
    SWITCH_PROB where both are on, else the one that is on; lambda ~
    Beta(alpha, alpha) (a zero alpha is 1e-6, as the JAX package's); the
    box centre uniform."""
    dev = generator.device
    if cutmix_alpha > 0.0 and mixup_alpha > 0.0:
        use_cutmix = torch.rand((), device=dev,
                                generator=generator) < SWITCH_PROB
    else:
        use_cutmix = cutmix_alpha > 0.0
    lam_mix, failed_mix = sample_beta(max(mixup_alpha, 1e-6), generator)
    lam_cut, failed_cut = sample_beta(max(cutmix_alpha, 1e-6), generator)
    cy = torch.randint(0, h, (), device=dev, generator=generator)
    cx = torch.randint(0, w, (), device=dev, generator=generator)
    return MixDraws(use_cutmix, lam_mix, lam_cut, cy, cx,
                    failed_mix + failed_cut)


def cutmix_box(lam_cut: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor,
               h: int, w: int):
    """Rows [y0, y1) and columns [x0, x1) of the CutMix box as int64
    tensors: sides sqrt(1 - lambda) of the image's (float32, truncated),
    about the drawn centre, clipped to the image."""
    ratio = torch.sqrt(1.0 - lam_cut)
    half_h = (h * ratio).long() // 2
    half_w = (w * ratio).long() // 2
    return ((cy - half_h).clamp(0, h), (cy + half_h).clamp(0, h),
            (cx - half_w).clamp(0, w), (cx + half_w).clamp(0, w))


def mixup_cutmix(x: torch.Tensor, labels: torch.Tensor,
                 draws: Optional[MixDraws], *, num_classes: int,
                 smoothing: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """timm's batch-mode Mixup/CutMix of NCHW `x` with the flipped batch
    as partner -> (x_mixed, soft targets [B, C]), as the JAX package
    computes it: CutMix pastes the partner's box through a mask of
    `arange` comparisons and recomputes lambda from the clipped box's
    area; the branch is chosen by `torch.where` (or statically where
    `use_cutmix` is a bool); the targets are smoothed one-hots mixed by
    lambda. `draws` None: `x` and the smoothed targets unchanged."""
    y = _one_hot_smoothed(labels, num_classes, smoothing)
    if draws is None:
        return x, y

    def tensor(v, dtype):
        return (v if isinstance(v, torch.Tensor)
                else torch.tensor(v, dtype=dtype, device=x.device))

    x_flip, y_flip = x.flip(0), y.flip(0)
    use = draws.use_cutmix
    if use is not True:
        lam_mix = tensor(draws.lam_mix, torch.float32)
        x_mix = lam_mix * x + (1 - lam_mix) * x_flip
    if use is not False:
        h, w = x.shape[-2:]
        y0, y1, x0, x1 = cutmix_box(tensor(draws.lam_cut, torch.float32),
                                    tensor(draws.cy, torch.long),
                                    tensor(draws.cx, torch.long), h, w)
        rows = torch.arange(h, device=x.device)[:, None]
        cols = torch.arange(w, device=x.device)[None, :]
        in_box = (rows >= y0) & (rows < y1) & (cols >= x0) & (cols < x1)
        x_cut = torch.where(in_box, x_flip, x)
        lam_cut = 1.0 - ((y1 - y0) * (x1 - x0)) / (h * w)
    if use is True:
        out, lam = x_cut, lam_cut
    elif use is False:
        out, lam = x_mix, lam_mix
    else:
        out = torch.where(use, x_cut, x_mix)
        lam = torch.where(use, lam_cut, lam_mix)
    return out, lam * y + (1 - lam) * y_flip


# ---------------------------------------------------------------------------
# RandAugment (timm's 'rand-mN-mstdS-inc1': 2 rounds an image, 13 ops)

MAX_LEVEL = 10.0
FILL = 0.5  # grey where a warp samples outside the image (timm fill 128)
OPS = ("autocontrast", "posterize", "solarize", "solarize_add", "color",
       "contrast", "brightness", "sharpness", "rotate", "shear_x", "shear_y",
       "translate_x", "translate_y")
N_COLOUR = 8  # OPS[:8] act on colour, OPS[8:] through the affine warp
ROUNDS = 2  # ops an image (timm's rand-m9-n2)


@dataclasses.dataclass(frozen=True)
class RandAugmentDraws:
    """Per image and round [B, rounds]: the op's index into OPS, its
    level clip(m + mstd N(0, 1), 0, 10), and the sign (+1 or -1) a
    geometric op applies to it."""
    op: torch.Tensor
    level: torch.Tensor
    sign: torch.Tensor


def parse_randaugment(aa: Optional[str]) -> Tuple[float, float]:
    """A timm policy string ('rand-m9-mstd0.5') -> (magnitude, its std);
    None or '' -> magnitude 0 (off)."""
    if not aa:
        return 0.0, 0.5
    m, mstd = 9.0, 0.5
    for part in aa.split("-"):
        if part.startswith("mstd"):
            mstd = float(part[4:])
        elif part.startswith("m") and part[1:].replace(".", "").isdigit():
            m = float(part[1:])
    return m, mstd


def draw_rand_augment(batch: int, generator: torch.Generator, *,
                      magnitude: float = 9.0,
                      mag_std: float = 0.5) -> RandAugmentDraws:
    dev = generator.device
    op = torch.randint(0, len(OPS), (batch, ROUNDS), device=dev,
                       generator=generator)
    noise = torch.randn((batch, ROUNDS), device=dev, generator=generator)
    level = (magnitude + mag_std * noise).clamp(0.0, MAX_LEVEL)
    flip = torch.rand((batch, ROUNDS), device=dev, generator=generator) < 0.5
    sign = torch.where(flip, 1.0, -1.0)
    return RandAugmentDraws(op, level, sign)


def _affine(op: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """The inverse affine map [B, 2, 3] (output pixel -> source pixel,
    about the image centre) of each image's op at its signed level;
    the identity for a colour op."""
    b = op.shape[0]
    f = level / MAX_LEVEL
    th = -(f * 30.0) * math.pi / 180.0
    shear, shift = f * 0.3, f * 0.45
    zero, one = torch.zeros_like(f), torch.ones_like(f)
    mats = {  # each [B, 6] row-major
        "rotate": (th.cos(), -th.sin(), zero, th.sin(), th.cos(), zero),
        "shear_x": (one, -shear, zero, zero, one, zero),
        "shear_y": (one, zero, zero, -shear, one, zero),
        "translate_x": (one, zero, -shift, zero, one, zero),
        "translate_y": (one, zero, zero, zero, one, -shift)}
    out = device_constant((1.0, 0.0, 0.0, 0.0, 1.0, 0.0),
                          op.device).repeat(b, 1)
    for k, name in enumerate(OPS[N_COLOUR:], start=N_COLOUR):
        out = torch.where((op == k)[:, None], torch.stack(mats[name], 1), out)
    return out.view(b, 2, 3)


def affine_warp(img: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of NCHW `img` through each image's inverse affine
    `mat` [B, 2, 3], about the centre ((H-1)/2, (W-1)/2), with FILL
    outside: the four taps written out (grid_sample's border and centre
    rules are not these)."""
    b, c, h, w = img.shape
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device),
        indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    m = mat[:, :, :, None, None]  # [B, 2, 3, 1, 1]
    sx = m[:, 0, 0] * (xx - cx) + m[:, 0, 1] * (yy - cy) + m[:, 0, 2] + cx
    sy = m[:, 1, 0] * (xx - cx) + m[:, 1, 1] * (yy - cy) + m[:, 1, 2] + cy
    x0, y0 = sx.floor(), sy.floor()
    fx, fy = sx - x0, sy - y0
    x0i, y0i = x0.long(), y0.long()
    flat = img.reshape(b, c, h * w)

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).view(b, 1, -1)
        v = flat.gather(2, idx.expand(b, c, -1)).view(b, c, h, w)
        return torch.where(inside[:, None], v, FILL)

    return (((1 - fx) * (1 - fy))[:, None] * tap(y0i, x0i)
            + (fx * (1 - fy))[:, None] * tap(y0i, x0i + 1)
            + ((1 - fx) * fy)[:, None] * tap(y0i + 1, x0i)
            + (fx * fy)[:, None] * tap(y0i + 1, x0i + 1))


def _blend(a, b, factor):
    return (b + factor * (a - b)).clamp(0.0, 1.0)


def _enhance(level):
    return 1.0 + (level / MAX_LEVEL) * 0.9  # inc1: 1.0 -> 1.9


def autocontrast(img, level):
    lo = img.amin(dim=(2, 3), keepdim=True)
    hi = img.amax(dim=(2, 3), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / torch.clamp(hi - lo, min=1e-6), 1.0)
    return ((img - lo) * scale).clamp(0.0, 1.0)


def posterize(img, level):
    # inc1: more magnitude keeps fewer of the 8 bits (8 down to 4)
    bits = 8 - (level / MAX_LEVEL) * 4.0
    q = 2.0 ** (8.0 - bits.floor())  # the step, in 1/255
    return (img * 255.0 / q).floor() * q / 255.0


def solarize(img, level):
    thr = 1.0 - level / MAX_LEVEL
    return torch.where(img >= thr, 1.0 - img, img)


def solarize_add(img, level):
    add = (level / MAX_LEVEL) * (110.0 / 255.0)
    return torch.where(img < 0.5, (img + add).clamp(0.0, 1.0), img)


def color(img, level):
    grey = img.mean(dim=1, keepdim=True).expand_as(img)
    return _blend(img, grey, _enhance(level))


def contrast(img, level):
    mean = img.mean(dim=(1, 2, 3), keepdim=True).expand_as(img)
    return _blend(img, mean, _enhance(level))


def brightness(img, level):
    return _blend(img, torch.zeros_like(img), _enhance(level))


def sharpness(img, level):
    c = img.shape[1]
    k = device_constant((1.0, 1.0, 1.0, 1.0, 5.0, 1.0, 1.0, 1.0, 1.0),
                        img.device).view(3, 3) / 13.0
    blur = F.conv2d(img, k.expand(c, 1, 3, 3), padding=1, groups=c)
    return _blend(img, blur, _enhance(level))


COLOUR_OPS = (autocontrast, posterize, solarize, solarize_add, color,
              contrast, brightness, sharpness)


def rand_augment(x: torch.Tensor, draws: RandAugmentDraws) -> torch.Tensor:
    """RandAugment of NCHW `x` in [0, 1]: each round warps every image
    through its op's matrix (the identity for a colour op), then applies
    its colour op at the unsigned level (none for a geometric op). Every
    colour op runs on the whole batch and each image keeps its own, so
    nothing leaves the device."""
    for i in range(draws.op.shape[1]):
        op, level = draws.op[:, i], draws.level[:, i]
        x = affine_warp(x, _affine(op, draws.sign[:, i] * level))
        lv = level[:, None, None, None]
        out = x
        for k, fn in enumerate(COLOUR_OPS):
            out = torch.where((op == k)[:, None, None, None], fn(x, lv), out)
        x = out
    return x


# ---------------------------------------------------------------------------
# RandomErasing (timm's pixel mode, after normalisation)


@dataclasses.dataclass(frozen=True)
class EraseDraws:
    """Per image [B]: whether to erase, the box's area as a share of the
    image, its log aspect ratio, uniforms in [0, 1) that place it; and the
    noise [B, C, H, W] it is filled with."""
    apply: torch.Tensor
    area: torch.Tensor
    log_ratio: torch.Tensor
    uy: torch.Tensor
    ux: torch.Tensor
    noise: torch.Tensor


ERASE_AREA = (0.02, 1 / 3)  # the box's share of the image
ERASE_ASPECT = (0.3, 10 / 3)  # its height / width


def draw_random_erasing(shape, generator: torch.Generator, *,
                        prob: float = 0.25) -> EraseDraws:
    b = shape[0]
    dev = generator.device

    def uniform(lo=0.0, hi=1.0):
        u = torch.rand(b, device=dev, generator=generator)
        return lo + u * (hi - lo)

    apply = torch.rand(b, device=dev, generator=generator) < prob
    area = uniform(*ERASE_AREA)
    log_ratio = uniform(math.log(ERASE_ASPECT[0]), math.log(ERASE_ASPECT[1]))
    uy, ux = uniform(), uniform()
    noise = torch.randn(tuple(shape), device=dev, generator=generator)
    return EraseDraws(apply, area, log_ratio, uy, ux, noise)


def random_erasing(x: torch.Tensor, draws: EraseDraws) -> torch.Tensor:
    """Fill one box an image of NCHW `x` with the drawn noise where
    `apply`: area share x H W, sides sqrt(area x ratio) by sqrt(area /
    ratio) (rounded, clipped to [1, H] and [1, W]), placed uniformly."""
    b, _, h, w = x.shape
    area = draws.area * (h * w)
    ratio = draws.log_ratio.exp()
    eh = torch.round(torch.sqrt(area * ratio)).clamp(1, h).long()
    ew = torch.round(torch.sqrt(area / ratio)).clamp(1, w).long()
    y0 = (draws.uy * (h - eh + 1)).long()
    x0 = (draws.ux * (w - ew + 1)).long()
    rows = torch.arange(h, device=x.device)[None, :, None]
    cols = torch.arange(w, device=x.device)[None, None, :]
    box = ((rows >= y0[:, None, None]) & (rows < (y0 + eh)[:, None, None])
           & (cols >= x0[:, None, None]) & (cols < (x0 + ew)[:, None, None]))
    mask = (box & draws.apply[:, None, None])[:, None]
    return torch.where(mask, draws.noise.to(x.dtype), x)
