"""TT-LSTM: an LSTM cell whose input-to-hidden weight is TT-factorized
(counterpart of the JAX package's `analysis/tt_lstm.py`; reference
ablation/tt_lstm_inference.py), and its latency demo."""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch
from torch import nn

from ..configs.hp import TTLinearSpec
from ..layers.tt_linear import TTLinear
from ..nlp.factorization import tt_linear_spec_from_ratio
from ..utils.device import resolve_device


class TTLSTMCell(nn.Module):
    """LSTM cell with the [4H, I] input projection in TT format (`wx`);
    the recurrent [4H, H] projection `wh` stays dense and bias-free (it
    is the smaller of the two for the large inputs TT-LSTM targets). Gates
    in the order i, f, g, o."""

    def __init__(self, input_size: int, hidden_size: int,
                 spec: Optional[TTLinearSpec] = None,
                 compression_ratio: float = 4.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        spec = spec or tt_linear_spec_from_ratio(
            input_size, 4 * hidden_size, compression_ratio, dim=3)
        self.wx = TTLinear(input_size, 4 * hidden_size, spec, bias=True,
                           generator=generator)
        self.wh = nn.Linear(hidden_size, 4 * hidden_size, bias=False)
        # flax Dense's lecun_normal: a normal of variance 1/fan_in cut at
        # two of its standard deviations, drawn from `generator`
        std = (1.0 / hidden_size) ** 0.5 / .87962566103423978
        nn.init.trunc_normal_(self.wh.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor],
                x: torch.Tensor):
        h, c = carry
        gates = self.wx(x) + self.wh(h)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), h

    def init_carry(self, batch: int):
        w = self.wh.weight
        z = torch.zeros(batch, self.hidden_size, dtype=w.dtype, device=w.device)
        return (z, z)


def run_sequence(cell: TTLSTMCell, xs: torch.Tensor) -> torch.Tensor:
    """The cell over xs [B, T, I] from a zero carry: outputs [T, B, H]."""
    carry = cell.init_carry(xs.shape[0])
    ys = []
    for t in range(xs.shape[1]):
        carry, y = cell(carry, xs[:, t])
        ys.append(y)
    return torch.stack(ys)


def tt_lstm_inference_demo(input_size=1024, hidden_size=256, seq_len=32,
                           batch=8, ratio=8.0, iters=20, device=None,
                           seed: int = 0) -> dict:
    """Latency demo (ablation/tt_lstm_inference.py's): the cell over a
    sequence, on the card unless `device` says otherwise; ms a sequence
    (after one warm-up run, synchronised) and the parameter counts."""
    device = resolve_device(device or "cuda")
    gen = torch.Generator().manual_seed(seed)
    cell = TTLSTMCell(input_size, hidden_size, compression_ratio=ratio,
                      generator=gen).to(device).eval()
    xs = torch.zeros(batch, seq_len, input_size, device=device)
    with torch.no_grad():
        run_sequence(cell, xs)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(iters):
            run_sequence(cell, xs)
        _sync(device)
    ms = 1000 * (time.perf_counter() - t0) / iters
    n_params = sum(p.numel() for p in cell.parameters())
    return {"ms_per_sequence": ms, "params": int(n_params),
            "dense_wx_params": input_size * 4 * hidden_size}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
