"""ViT / DeiT, dense and Tensor-Train or Tucker-2 compressed (counterpart
of the JAX package's `models/vit.py`).

Patch embedding (a strided conv with a bias), a class token and learned
position embeddings, `depth` pre-norm blocks (multi-head attention and a
GELU MLP, each with a residual and drop path), a final LayerNorm and a
linear head on the class token. Each block's qkv, proj, fc1 and fc2 are TT
or Tucker-2 linears iff their canonical name ('blocks.0.attn.qkv.weight',
...) is in the plan; everything else stays dense. Numerics follow the JAX
package: LayerNorm eps 1e-6, exact GELU, attention written out with its
softmax in float32, and the head in float32 whatever the autocast type.
Drop path draws from a generator the caller passes to `forward`, never
from the global one; a data-parallel step passes a `BatchRows` instead,
and drop path draws the masks of the whole global batch and keeps this
rank's rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..configs.hp import RankPlan
from ..configs.plans import build_tk_plan, build_tt_linear_plan
from ..configs.resolver import get_rank_plan, register_plan
from .registry import register_model
from .substitute import make_linear


def _trunc_normal_(w: torch.Tensor,
                   generator: Optional[torch.Generator]) -> None:
    nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=generator)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-6)


class BatchRows(NamedTuple):
    """The `generator` of a data-parallel step: x holds rows
    [lo, lo + len(x)) of a batch of `total`, and drop path draws all
    `total` masks from `generator`, as one process running the whole
    batch would, and keeps x's."""
    generator: torch.Generator
    total: int
    lo: int


Draws = Union[torch.Generator, BatchRows, None]


def drop_path(x: torch.Tensor, rate: float, generator: Draws) -> torch.Tensor:
    """Zero whole samples with probability `rate`, scale the rest by
    1/(1 - rate); `generator` draws the mask on x's device (a `BatchRows`:
    the global batch's masks, of which x's rows are kept)."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("drop path in training needs a generator")
    keep = 1.0 - rate
    total, lo = x.shape[0], 0
    if isinstance(generator, BatchRows):
        generator, total, lo = generator
    mask = torch.rand((total,) + (1,) * (x.dim() - 1), device=x.device,
                      generator=generator)[lo:lo + x.shape[0]] < keep
    return x * mask.to(x.dtype) / keep


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, prefix: str,
                 plan: Optional[RankPlan], mode: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = make_linear(dim, 3 * dim, plan=plan, mode=mode,
                               key=f"{prefix}.qkv.weight", generator=generator)
        self.proj = make_linear(dim, dim, plan=plan, mode=mode,
                                key=f"{prefix}.proj.weight",
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        hd = d // h
        qkv = self.qkv(x).reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                    # [B, h, N, hd]
        attn = (q @ k.transpose(-2, -1)) * (hd ** -0.5)
        attn = attn.float().softmax(dim=-1).to(q.dtype)
        y = (attn @ v).transpose(1, 2).reshape(b, n, d)
        return self.proj(y)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, prefix: str,
                 plan: Optional[RankPlan], mode: str,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.fc1 = make_linear(dim, hidden, plan=plan, mode=mode,
                               key=f"{prefix}.fc1.weight", generator=generator)
        self.fc2 = make_linear(hidden, dim, plan=plan, mode=mode,
                               key=f"{prefix}.fc2.weight", generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 prefix: str, drop_path: float, plan: Optional[RankPlan],
                 mode: str, generator: Optional[torch.Generator]):
        super().__init__()
        self.drop_path = drop_path
        self.norm1 = _layer_norm(dim)
        self.attn = Attention(dim, num_heads, f"{prefix}.attn", plan, mode,
                              generator)
        self.norm2 = _layer_norm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), f"{prefix}.mlp", plan, mode,
                       generator)

    def forward(self, x: torch.Tensor, generator: Draws) -> torch.Tensor:
        rate = self.drop_path if self.training else 0.0
        x = x + drop_path(self.attn(self.norm1(x)), rate, generator)
        return x + drop_path(self.mlp(self.norm2(x)), rate, generator)


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        # LeCun-normal kernel and zero bias, flax's Conv defaults
        nn.init.kaiming_normal_(self.proj.weight, mode="fan_in",
                                nonlinearity="linear", generator=generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).flatten(2).transpose(1, 2)      # [B, N, D]


class VisionTransformer(nn.Module):
    """NCHW input [B, 3, img_size, img_size] -> logits [B, num_classes]
    (float32)."""

    def __init__(self, *, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 192, depth: int = 12, num_heads: int = 3,
                 mlp_ratio: float = 4.0, num_classes: int = 1000,
                 drop_path_rate: float = 0.0,
                 plan: Optional[RankPlan] = None, mode: str = "factorized",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        n_patch = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(patch_size, embed_dim, generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(1, n_patch + 1, embed_dim))
        _trunc_normal_(self.cls_token, generator)
        _trunc_normal_(self.pos_embed, generator)
        rates = [float(r) for r in np.linspace(0, drop_path_rate, depth)]
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, f"blocks.{i}", rates[i],
                  plan, mode, generator) for i in range(depth))
        self.norm = _layer_norm(embed_dim)
        self.head = nn.Linear(embed_dim, num_classes)
        _trunc_normal_(self.head.weight, generator)
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor, generator: Draws = None
                ) -> torch.Tensor:
        """`generator` draws the drop-path masks in training (a
        `BatchRows` in a data-parallel step)."""
        y = self.patch_embed(x)
        cls = self.cls_token.expand(y.shape[0], -1, -1).to(y.dtype)
        y = torch.cat([cls, y], dim=1) + self.pos_embed.to(y.dtype)
        for block in self.blocks:
            y = block(y, generator)
        y = self.norm(y)
        # the head runs in float32 whatever the compute type
        with torch.autocast(y.device.type, enabled=False):
            return self.head(y[:, 0].float())


# name: (embed_dim, depth, heads)
_VIT_CFGS = {"deit_tiny_patch16_224": (192, 12, 3),
             "deit_small_patch16_224": (384, 12, 6),
             "vit_small_patch16_224": (384, 12, 6)}


def _vit_out_features(embed_dim: int):
    def fn(name: str) -> int:
        if name.endswith("qkv.weight"):
            return 3 * embed_dim
        if name.endswith("fc1.weight"):
            return 4 * embed_dim
        return embed_dim  # proj, fc2
    return fn


def _register_vit_plans() -> None:
    """The JAX package registers tt and tk at ratios 2 and 3 for every ViT,
    but its JSON holds only TT 2 for all three and TK 2 for DeiT-tiny: the
    port registers those alone, so that every registered plan resolves."""
    for model, (dim, _, _) in _VIT_CFGS.items():
        register_plan(model, "tt", "2")(
            lambda m=model, d=dim: build_tt_linear_plan(
                m, "2", "general", _vit_out_features(d)))
    register_plan("deit_tiny_patch16_224", "tk", "2")(
        lambda: build_tk_plan("deit_tiny_patch16_224", "2"))


_register_vit_plans()


def _build_vit(name: str, *, num_classes: int = 1000,
               fmt: Optional[str] = None, mode: str = "factorized",
               ratio: str = "2", tt_type: str = "general",
               plan: Optional[RankPlan] = None, img_size: int = 224,
               drop_path_rate: float = 0.1,
               generator: Optional[torch.Generator] = None
               ) -> VisionTransformer:
    dim, depth, heads = _VIT_CFGS[name]
    if fmt is not None and plan is None:
        plan = get_rank_plan(name, fmt, ratio, tt_type)
    return VisionTransformer(img_size=img_size, embed_dim=dim, depth=depth,
                             num_heads=heads, num_classes=num_classes,
                             drop_path_rate=drop_path_rate, plan=plan,
                             mode=mode, generator=generator)


@register_model
def deit_tiny_patch16_224(**kw) -> VisionTransformer:
    return _build_vit("deit_tiny_patch16_224", **kw)


@register_model
def deit_small_patch16_224(**kw) -> VisionTransformer:
    return _build_vit("deit_small_patch16_224", **kw)


@register_model
def vit_small_patch16_224(**kw) -> VisionTransformer:
    return _build_vit("vit_small_patch16_224", **kw)
