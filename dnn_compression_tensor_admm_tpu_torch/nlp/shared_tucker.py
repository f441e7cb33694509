"""Cross-layer shared Tucker factorization of a BERT encoder (counterpart
of the JAX package's `nlp/shared_tucker.py`; the reference's
TuckerWeights / TuckerWeights_Plus, xcompression/transformer/
modeling.py:781-1258).

The 12 [D, D] weight blocks of each of the L layers (query, key, value,
attention output, the FFN-in weight as 4 blocks and the FFN-out weight as
4 blocks, each block in the flax layout: in-dim first) are factorized
jointly:

    block[b] ~= left @ core_b @ right,   core_b = sum_i factor_layer[b, i] * core[i]

with shared `factor_left` [D, r_c] and `factor_right` [r_d, D], a mixing
vector a block over a bank `core` [r_layer, r_c, r_d], and biases
[L, 9, D]. Every projection of the encoder runs through the shared
bottleneck. `factorize_encoder` fits the factors to a dense encoder by
HOOI; `rank_regularizer` and `shrink_rank` drive the ranks down.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.precision import full_f32
from ..ops.svd import truncated_left_sv
from .bert import BertConfig, layer_norm
from .initializers import normal_


@dataclasses.dataclass(frozen=True)
class SharedTuckerConfig:
    rank_layer: int = 60       # core-bank size over L * 12 blocks
    rank_condim: int = 384     # r_c (left)
    rank_dim: int = 384        # r_d (right)


class SharedTuckerEncoderLayer(nn.Module):
    """One encoder layer whose projections read the shared factors, which
    the encoder owns and passes in."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = nn.ModuleDict({"output": nn.ModuleDict(
            {"LayerNorm": layer_norm(cfg)})})
        self.output = nn.ModuleDict({"LayerNorm": layer_norm(cfg)})

    def forward(self, x, mask, cores, left, right, bias):
        c = self.cfg
        h = c.num_heads
        b, n, d = x.shape
        hd = d // h

        def proj(t, j):
            return ((t @ left) @ cores[j]) @ right + bias[j]

        def heads(t):
            return t.reshape(b, n, h, hd).transpose(1, 2)

        q, k, v = (heads(proj(x, j)) for j in range(3))
        scores = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
        scores = scores.float() + mask
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = (probs @ v).transpose(1, 2).reshape(b, n, d)
        x = self.attention["output"]["LayerNorm"](x + proj(ctx, 3))
        # FFN-in: 4 column blocks of the [D, 4D] kernel
        xl = x @ left
        inner = torch.einsum("bnk,akr,rE->bnaE", xl, cores[4:8], right)
        inner = inner.reshape(b, n, 4 * d) + bias[4:8].reshape(-1)
        inner = F.gelu(inner, approximate="none")
        # FFN-out: the [4D, D] kernel as 4 row blocks, summed
        hl = torch.einsum("bnaD,Dk->bnak", inner.reshape(b, n, 4, d), left)
        out = torch.einsum("bnak,akr,rE->bnE", hl, cores[8:12], right)
        y = self.output["LayerNorm"](x + out + bias[8])
        return y, scores


class SharedTuckerBertEncoder(nn.Module):
    """The L-layer encoder over one shared factor set."""

    def __init__(self, cfg: BertConfig, tucker: SharedTuckerConfig, *,
                 generator=None):
        super().__init__()
        self.cfg, self.tucker = cfg, tucker
        d, nl = cfg.hidden_size, cfg.num_layers
        t = tucker

        def param(*shape):
            return nn.Parameter(normal_(torch.empty(shape), 0.02, generator))

        self.factor_left = param(d, t.rank_condim)
        self.factor_right = param(t.rank_dim, d)
        self.factor_layer = param(nl * 12, t.rank_layer)
        self.core = param(t.rank_layer, t.rank_condim, t.rank_dim)
        self.bias = nn.Parameter(torch.zeros(nl, 9, d))
        self.layer = nn.ModuleList(SharedTuckerEncoderLayer(cfg)
                                   for _ in range(nl))

    def forward(self, x, mask):
        t, nl = self.tucker, self.cfg.num_layers
        cores = torch.einsum("ikl,bi->bkl", self.core, self.factor_layer
                             ).reshape(nl, 12, t.rank_condim, t.rank_dim)
        hidden_states, attentions = [x], []
        for i, layer in enumerate(self.layer):
            x, att = layer(x, mask, cores[i], self.factor_left,
                           self.factor_right, self.bias[i])
            hidden_states.append(x)
            attentions.append(att)
        return x, hidden_states, attentions

    def rank_regularizer(self, lam: float = 1.0) -> torch.Tensor:
        """l2 of the trailing rank slices: pushing them to zero makes the
        next `shrink_rank` lossless (modeling.py:838-841)."""
        return lam * (torch.sum(self.core[:, -1, :] ** 2)
                      + torch.sum(self.core[:, :, -1] ** 2)
                      + torch.sum(self.factor_left[:, -1] ** 2)
                      + torch.sum(self.factor_right[-1, :] ** 2))

    @torch.no_grad()
    def shrink_rank(self) -> None:
        """Drop the last r_c / r_d slice (reference `step()`,
        modeling.py:843-852)."""
        self.core = nn.Parameter(self.core[:, :-1, :-1].clone())
        self.factor_left = nn.Parameter(self.factor_left[:, :-1].clone())
        self.factor_right = nn.Parameter(self.factor_right[:-1, :].clone())
        t = self.tucker
        self.tucker = SharedTuckerConfig(t.rank_layer, t.rank_condim - 1,
                                         t.rank_dim - 1)


def stack_encoder_blocks(state: Dict[str, torch.Tensor], num_layers: int,
                         prefix: str = "encoder.layer") -> torch.Tensor:
    """The [L * 12, D, D] block stack of a dense BERT's state dict (torch
    weights [out, in]), each block in the JAX package's flax layout
    [in, out]: q, k, v, attention output, then the FFN-in kernel [D, 4D]'s
    4 column blocks, then the FFN-out kernel [4D, D]'s 4 row blocks."""
    blocks = []
    for i in range(num_layers):
        def w(name):
            return state[f"{prefix}.{i}.{name}.weight"]
        d = w("attention.self.query").shape[0]
        blocks += [w(n).T for n in ("attention.self.query",
                                    "attention.self.key",
                                    "attention.self.value",
                                    "attention.output.dense")]
        w1 = w("intermediate.dense")              # [4D, D]: kernel.T
        blocks += [w1[j * d:(j + 1) * d, :].T for j in range(4)]
        w2 = w("output.dense")                    # [D, 4D]: kernel.T
        blocks += [w2[:, j * d:(j + 1) * d].T for j in range(4)]
    return torch.stack(blocks)


@full_f32()
def factorize_encoder(block_stack: torch.Tensor, tucker: SharedTuckerConfig,
                      n_iter: int = 5) -> Dict[str, torch.Tensor]:
    """HOOI of the block stack onto (rank_layer, rank_condim, rank_dim)
    -> the shared factors (the biases stay the caller's)."""
    t = block_stack                                   # [B, D, D]
    nb, dx, dy = t.shape
    r0, r1, r2 = tucker.rank_layer, tucker.rank_condim, tucker.rank_dim
    f0 = truncated_left_sv(t.reshape(nb, -1), r0)
    f1 = truncated_left_sv(t.permute(1, 0, 2).reshape(dx, -1), r1)
    f2 = truncated_left_sv(t.permute(2, 0, 1).reshape(dy, -1), r2)
    for _ in range(n_iter):
        y = torch.einsum("bxy,xk,yl->bkl", t, f1, f2)
        f0 = truncated_left_sv(y.reshape(nb, -1), r0)
        y = torch.einsum("bxy,bi,yl->xil", t, f0, f2)
        f1 = truncated_left_sv(y.reshape(dx, -1), r1)
        y = torch.einsum("bxy,bi,xk->yik", t, f0, f1)
        f2 = truncated_left_sv(y.reshape(dy, -1), r2)
    core = torch.einsum("bxy,bi,xk,yl->ikl", t, f0, f1, f2)
    return {"core": core, "factor_layer": f0, "factor_left": f1,
            "factor_right": f2.T.contiguous()}


def reconstruct_blocks(factors: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The [B, D, D] stack the factors stand for."""
    cores = torch.einsum("ikl,bi->bkl", factors["core"], factors["factor_layer"])
    return factors["factor_left"] @ cores @ factors["factor_right"]
