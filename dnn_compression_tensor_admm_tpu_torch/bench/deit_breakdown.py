"""Per-component breakdown of the DeiT-tiny TT@2x ADMM X-step (the JAX
package's `bench/deit_breakdown.py`).

The JAX harness times each component inside a `lax.scan` at two lengths
and takes the slope. Here each component's body is a
`train/capture.py::CapturedStep`: primed once (an eager call, then the
capture) and replayed n1 times untimed, then replayed n1 and n2 times
between CUDA events under the sync debug mode "error"; its ms a replay
is (t2 - t1) / (n2 - n1), so the events' constant costs cancel. The
counts are JAX's: 4/12 for the model rows, 8/24 for the penalty and the
input pipeline, 2/6 for the proxies. Each row is the median of `REPEATS`
such slopes, and `spread_ms` holds their range. On the CPU the same
bodies run eagerly under `time.perf_counter`, after the same n1 untimed
calls (a check of the code, not a device time).

The model is the port's `deit_tiny_patch16_224` with 1,000 classes under
the bf16 autocast the port's X-step runs (JAX: `dtype=bfloat16`). A
CUDA graph replays every kernel it captured, so the gradients need no
consumer (JAX folds every leaf into its carry, `grad_scalar`, or XLA
drops the weight-gradient products); each gradient row takes
`torch.autograd.grad` over every parameter.

Components (ms a step):
  fwd            the forward, eval mode (the ADMM X-step's forward)
  fwd_bwd        + loss and every parameter's gradient
  fwd_bwd_train  the same in train mode: drop path from the device
                 generator, registered with the graph
  fwd_bwd_opt    fwd_bwd's body + the engine's AdamW step on those
                 gradients (lr 5e-4, state inside the graph)
  fwd_bwd_pen    + the ADMM penalty over the TT@2 plan's 48 linears
  penalty_grad   the penalty's gradient alone (`admm_penalty`'s loop)
  input_pipe     a batch sampled from `synthetic-imagenet` at 512 and
                 augmented on the card (`data/device_pipeline.py`)
  matmul_proxy   the encoder's matmul chain at the step's tokens, bf16:
                 the matmul-only ceiling
  ln_softmax     LayerNorm + softmax proxy at encoder shapes, float32

`derived` holds JAX's ratios; `shares_of_step` (the port's) splits a
train step composed of the rows into forward, backward, drop path,
penalty, optimizer and input pipeline, beside the matmul ceiling. A part
is a difference of two rows: it is `resolved` only where it exceeds the
sum of their spreads.

Run: python -m dnn_compression_tensor_admm_tpu_torch.bench.deit_breakdown
[--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Callable, Dict, List, Sequence

import torch

from ..admm import admm_init, admm_penalty, build_program
from ..configs import get_rank_plan
from ..configs.hp import RankPlan
from ..data import datasets
from ..data.device_pipeline import augment_batch, random_crop_flip, sample_batch
from ..models.vit import VisionTransformer
from ..train import capture
from ..train.optim import make_train_optimizer
from ..utils.card import card_info
from ..utils.device import resolve_device

B = 128
IMG = 224
DIM = 192
HEADS = 3
DEPTH = 12
TOKENS = 197
RHO = 0.001
LR = 5e-4
# each row's two replay counts (JAX's scan lengths)
COUNTS = {"fwd": (4, 12), "fwd_bwd": (4, 12), "fwd_bwd_train": (4, 12),
          "fwd_bwd_opt": (4, 12), "fwd_bwd_pen": (4, 12),
          "penalty_grad": (8, 24), "input_pipe": (8, 24),
          "matmul_proxy": (2, 6), "ln_softmax": (2, 6)}
REPEATS = 3  # slopes a row: the row is their median
# the replays `breakdown` makes on the card: n1 untimed, then REPEATS
# times n1 and n2 timed, a row
REPLAYS = sum(n1 + REPEATS * (n1 + n2) for n1, n2 in COUNTS.values())
# each part of a step composed of the rows: (row, row it is taken from)
PARTS = {"forward": ("fwd", None), "backward": ("fwd_bwd", "fwd"),
         "drop_path": ("fwd_bwd_train", "fwd_bwd"),
         "penalty": ("fwd_bwd_pen", "fwd_bwd"),
         "optimizer": ("fwd_bwd_opt", "fwd_bwd"),
         "input_pipeline": ("input_pipe", None)}


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The breakdown's shapes (JAX's module constants by default; the
    width is always DIM, with HEADS heads); `pipe_images` is the input
    pipeline's set."""
    batch: int = B
    img: int = IMG
    depth: int = DEPTH
    pipe_images: int = 512

    @property
    def tokens(self) -> int:
        return (self.img // 16) ** 2 + 1


def flops_encoder_fwd(b=B, n=TOKENS, d=DIM, depth=DEPTH, h=HEADS) -> float:
    """Matmul FLOPs of one dense forward (encoder only)."""
    hd = d // h
    per_block = (
        2 * b * n * d * 3 * d          # qkv
        + 2 * b * h * n * n * hd * 2   # q@kT and attn@v
        + 2 * b * n * d * d            # proj
        + 2 * b * n * d * 4 * d * 2    # fc1, fc2
    )
    return depth * per_block


def replay_ms(step, n: int, device: torch.device) -> float:
    """ms of n calls of a primed `step`: CUDA events around n replays in
    the sync debug mode "error" on the card, the host clock on the
    CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        return 1000 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with capture._no_host_reads(True):
        start.record()
        for _ in range(n):
            step()
        end.record()
    end.synchronize()
    return start.elapsed_time(end)


def slope_ms(body: Callable[[], None], device: torch.device, n1: int = 8,
             n2: int = 24, generators: Sequence[torch.Generator] = ()
             ) -> List[float]:
    """`REPEATS` readings of the ms a step of `body`, each the slope over
    n1 and n2 replays of its captured graph; the graph is primed and
    replayed n1 times untimed first (on the CPU: eager calls, after n1
    untimed calls)."""
    step = capture.CapturedStep(body, generators,
                                capture=device.type == "cuda")
    if step.capture:
        step.prime()
    replay_ms(step, n1, device)
    slopes = []
    for _ in range(REPEATS):
        t1 = replay_ms(step, n1, device)
        t2 = replay_ms(step, n2, device)
        slopes.append((t2 - t1) / (n2 - n1))
    return slopes


def make_model(sizes: Sizes, device: torch.device) -> torch.nn.Module:
    """`deit_tiny_patch16_224` (DeiT-tiny's width, 1,000 classes) at
    `sizes`' depth and image, from seed 0."""
    return VisionTransformer(
        img_size=sizes.img, embed_dim=DIM, depth=sizes.depth,
        num_heads=HEADS, num_classes=1000, drop_path_rate=0.1,
        generator=torch.Generator().manual_seed(0)).to(device)


def penalty_program(params: Dict[str, torch.Tensor]):
    """The DeiT-tiny TT@2 plan's program and ADMM state (U = 0, Z = W)
    over the layers `params` holds (all 48 at full depth)."""
    plan = get_rank_plan("deit_tiny_patch16_224", "tt", "2")
    plan = RankPlan(plan.fmt, {n: s for n, s in plan.layers.items()
                               if n in params})
    program = build_program(params, plan)
    return program, admm_init(params, program)


def step_shares(ms: Dict[str, float],
                spread: Dict[str, float]) -> Dict[str, float]:
    """A train step composed of the rows (fwd_bwd_train + the optimizer +
    the penalty + the input pipeline) and each part's share of it
    (`PARTS`: the forward, the backward, drop path, the penalty, the
    optimizer, the input pipeline), each with the sum of its rows'
    `spread` and whether it exceeds that (`resolved`); and the matmul
    ceiling (3 x matmul_proxy: a train step's matmuls at the proxy's
    rate)."""
    parts = {k: (ms[a] - (ms[b] if b else 0.0),
                 spread[a] + (spread[b] if b else 0.0))
             for k, (a, b) in PARTS.items()}
    step = sum(v for v, _ in parts.values())
    out = {"step_ms": step}
    for k, (v, err) in parts.items():
        out[f"{k}_ms"] = v
        out[f"{k}_share"] = v / step
        out[f"{k}_spread_ms"] = err
        out[f"{k}_resolved"] = v > err
    out["matmul_ceiling_ms"] = 3 * ms["matmul_proxy"]
    out["matmul_ceiling_share"] = out["matmul_ceiling_ms"] / step
    return out


def breakdown(device: str = "cuda", sizes: Sizes = Sizes()) -> dict:
    """The nine rows (each the median of its slopes, their range in
    `spread_ms`), `derived` and `shares_of_step` at `sizes`."""

    dev = resolve_device(device)
    b, t, d, h = sizes.batch, sizes.tokens, DIM, HEADS
    slopes: Dict[str, List[float]] = {}
    model = make_model(sizes, dev)
    named = dict(model.named_parameters())
    params = list(named.values())
    n_params = sum(p.numel() for p in params)
    gen = torch.Generator(device=dev).manual_seed(0)

    def autocast():
        return torch.autocast(dev.type, dtype=torch.bfloat16,
                              cache_enabled=False)

    x0 = torch.zeros((b, 3, sizes.img, sizes.img), device=dev)
    labels = torch.zeros((b,), dtype=torch.long, device=dev)
    s = torch.zeros((), device=dev)  # the carry

    def loss_of(x, generator=None):
        with autocast():
            logits = model(x, generator=generator)
        logits = logits.float()
        lse = torch.logsumexp(logits, -1)
        return torch.mean(lse - logits.gather(1, labels[:, None])[:, 0])

    # --- forward ---------------------------------------------------------
    def fwd_body():
        with torch.no_grad(), autocast():
            y = model(x0 + s * 1e-6)
        s.copy_(y.float().mean())

    model.eval()
    slopes["fwd"] = slope_ms(fwd_body, dev, *COUNTS["fwd"])

    # --- forward+backward (no penalty) ------------------------------------
    def fwd_bwd_body():
        loss = loss_of(x0 + s * 1e-6)
        torch.autograd.grad(loss, params)
        s.copy_(loss.detach())

    slopes["fwd_bwd"] = slope_ms(fwd_bwd_body, dev, *COUNTS["fwd_bwd"])

    # --- forward+backward in train mode (drop path) ------------------------
    def fwd_bwd_train_body():
        loss = loss_of(x0 + s * 1e-6, generator=gen)
        torch.autograd.grad(loss, params)
        s.copy_(loss.detach())

    model.train()
    slopes["fwd_bwd_train"] = slope_ms(fwd_bwd_train_body, dev,
                                     *COUNTS["fwd_bwd_train"],
                                     generators=(gen,))
    model.eval()

    # --- fwd+bwd+AdamW update (the weights and state change each step) ----
    lr = torch.tensor(LR, device=dev)
    opt, _ = make_train_optimizer(model.named_parameters(), lr, opt="adamw",
                                  weight_decay=1e-4)

    def fwd_bwd_opt_body():  # fwd_bwd_body, then the step on its gradients
        loss = loss_of(x0 + s * 1e-6)
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        opt.step()
        s.copy_(loss.detach())

    slopes["fwd_bwd_opt"] = slope_ms(fwd_bwd_opt_body, dev,
                                   *COUNTS["fwd_bwd_opt"])
    model.zero_grad(set_to_none=True)
    del opt

    # --- + the penalty -----------------------------------------------------
    program, state = penalty_program(named)

    def fwd_bwd_pen_body():
        loss = loss_of(x0 + s * 1e-6) + admm_penalty(named, state, program,
                                                      RHO)
        torch.autograd.grad(loss, params)
        s.copy_(loss.detach())

    slopes["fwd_bwd_pen"] = slope_ms(fwd_bwd_pen_body, dev,
                                   *COUNTS["fwd_bwd_pen"])

    # --- the penalty's gradient alone --------------------------------------
    targets = [named[n] for n in program.names]

    def pen_body():
        pen = admm_penalty(named, state, program, RHO + s * 0)
        torch.autograd.grad(pen, targets)
        s.copy_(pen.detach())

    slopes["penalty_grad"] = slope_ms(pen_body, dev, *COUNTS["penalty_grad"])

    # --- input pipeline ----------------------------------------------------
    x_np, _, info = datasets.load_dataset("synthetic-imagenet", True,
                                          sizes.pipe_images)
    images = torch.from_numpy(x_np).to(dev)
    n = images.shape[0]
    acc = torch.zeros((), device=dev)

    def pipe_body():
        xb = images[sample_batch(n, gen, b)]
        offsets, flips = random_crop_flip(b, gen)
        x = augment_batch(xb, offsets, flips, mean=info.mean, std=info.std)
        acc.add_(x.mean())

    slopes["input_pipe"] = slope_ms(pipe_body, dev, *COUNTS["input_pipe"],
                                  generators=(gen,))

    # --- matmul proxy (the matmul-only ceiling at encoder shapes) ----------
    bf = dict(dtype=torch.bfloat16, device=dev)
    w_qkv = torch.zeros((d, 3 * d), **bf)
    w_proj = torch.zeros((d, d), **bf)
    w_fc1 = torch.zeros((d, 4 * d), **bf)
    w_fc2 = torch.zeros((4 * d, d), **bf)
    q0 = torch.zeros((b * h, t, d // h), **bf)
    xm = torch.ones((b * t, d), **bf)

    def mm_body():
        x = xm
        for _ in range(sizes.depth):
            qkv = x @ w_qkv
            q = qkv[:, :d].reshape(b, t, h, -1).permute(0, 2, 1, 3)
            q = q.reshape(b * h, t, -1)
            a = q @ (q0 + q).transpose(-2, -1)
            y = (a @ (q0 + q)).reshape(b, h, t, -1).permute(0, 2, 1, 3)
            y = y.reshape(b * t, d)
            x = ((y @ w_proj) @ w_fc1) @ w_fc2 + x
        xm.copy_(x)

    slopes["matmul_proxy"] = slope_ms(mm_body, dev, *COUNTS["matmul_proxy"])

    # --- LayerNorm + softmax proxy ------------------------------------------
    sc = torch.ones((d,), device=dev)
    xl = torch.ones((b, t, d), device=dev)

    def ln_body():
        x = xl
        for _ in range(sizes.depth):
            mu = torch.mean(x, -1, keepdim=True)
            v = torch.mean((x - mu) ** 2, -1, keepdim=True)
            x = (x - mu) / torch.sqrt(v + 1e-6) * sc
            a = torch.einsum("bnd,bmd->bnm", x[..., :64], x[..., :64])
            a = torch.softmax(a, -1)
            x = x + torch.einsum("bnm,bmd->bnd", a, x) * 1e-3
            x = x * (1 + 1e-6)
        xl.copy_(x)

    slopes["ln_softmax"] = slope_ms(ln_body, dev, *COUNTS["ln_softmax"])

    rows = {k: statistics.median(v) for k, v in slopes.items()}
    spread = {k: max(v) - min(v) for k, v in slopes.items()}
    fwd_fl = flops_encoder_fwd(b, t, d, sizes.depth, h)
    shares = step_shares(rows, spread)
    return {
        "backend": dev.type, "device": str(dev), "card": card_info(dev),
        "route": ("captured graphs, CUDA events" if dev.type == "cuda"
                  else "eager, host clock"),
        "sizes": {**dataclasses.asdict(sizes), "tokens": t},
        "batch": b, "params": n_params, "repeats": REPEATS,
        "ms": {k: round(v, 3) for k, v in rows.items()},
        "spread_ms": {k: round(v, 3) for k, v in spread.items()},
        "derived": {
            "bwd_only_ms": round(rows["fwd_bwd"] - rows["fwd"], 3),
            "penalty_in_step_ms": round(rows["fwd_bwd_pen"] - rows["fwd_bwd"], 3),
            "fwd_matmul_tflops": round(fwd_fl / 1e12, 3),
            "fwd_eff_tflops_per_s": round(fwd_fl / rows["fwd"] / 1e9, 1),
            "train_eff_tflops_per_s": round(3 * fwd_fl / rows["fwd_bwd"] / 1e9, 1),
            "matmul_proxy_tflops_per_s": round(
                fwd_fl / rows["matmul_proxy"] / 1e9, 1),
        },
        "shares_of_step": {k: v if isinstance(v, bool) else round(v, 4)
                           for k, v in shares.items()},
    }

def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = breakdown(args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
