"""Runnable worked examples of factorized-forward math and cost accounting
(counterpart of the repo's `examples/numeric_examples.py`).

The reference ships three educational scripts that hand-compute TT conv/FC
forward passes and parameter/FLOP counts (numeric_example1.py:31-52,
numeric_example2.py:30-82, numeric_example3.py:22-61). Each example here
reproduces one against the port's layers and cost models, prints the
numbers the JAX script prints, and returns them.

Run:  python -m dnn_compression_tensor_admm_tpu_torch.examples.numeric_examples
      [--device cpu]   (the card by default)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..analysis import (dense_conv_cost, dense_linear_cost, tt_conv_cost,
                        tt_linear_cost)
from ..configs.hp import TTConvSpec, TTLinearSpec
from ..layers.tt_conv import TTConv2d
from ..ops.precision import full_f32
from ..utils.device import resolve_device


def example1_order1_tt_conv(seed: int = 0, device="cuda") -> dict:
    """Order-1 TT conv as three explicit computations
    (reference numeric_example1.py): contract the input-channel core into
    the activations, run the small r1->r2 conv, contract the
    output-channel core back. Returns the inputs (NCHW, the core OIHW),
    the layer's output and its largest distance from the manual one."""
    print("== example 1: order-1 TT conv = 3 computations ==")
    device = resolve_device(device)
    B, I, H, W, O = 4, 16, 10, 10, 32
    r1, r2 = 10, 24
    spec = TTConvSpec.create((O, 9, I), (1, r2, r1, 1), out_channels=O)
    rng = np.random.RandomState(seed)
    arrays = {"x": rng.standard_normal((B, I, H, W)),
              "in_core": rng.standard_normal((r1, I, 1)) * 0.2,
              "core": rng.standard_normal((r2, r1, 3, 3)) * 0.2,
              "out_core": rng.standard_normal((1, O, r2)) * 0.2}
    t = {k: torch.from_numpy(v.astype(np.float32)).to(device)
         for k, v in arrays.items()}

    layer = TTConv2d(I, O, 3, spec, stride=1, padding=1).to(device)
    layer.load_state_dict({"in_core_0": t["in_core"],
                           "core_kernel": t["core"],
                           "out_core_0": t["out_core"],
                           "bias": torch.zeros(O, device=device)})
    with full_f32(), torch.no_grad():
        # computation 1: y1[b,r1,h,w] = sum_i x[b,i,h,w] * G_in[r1,i]
        h1 = torch.einsum("bihw,ri->brhw", t["x"], t["in_core"][:, :, 0])
        # computation 2: y2 = conv3x3(y1; core[r1 -> r2])
        h2 = F.conv2d(h1, t["core"], padding=1)
        # computation 3: y[b,o,h,w] = sum_r2 y2[b,r2,h,w] * G_out[o,r2]
        y_manual = torch.einsum("brhw,or->bohw", h2,
                                t["out_core"][0].reshape(O, r2))
        y_layer = layer(t["x"])
    err = float((y_layer - y_manual).abs().max())
    print(f"  layer-vs-manual max abs err: {err:.2e}  (identical math)")
    return {"max_abs_err": err, "y": y_layer.cpu().numpy(),
            **{k: v.cpu().numpy() for k, v in t.items()}}


def example2_general_tt_conv_costs() -> dict:
    """General-order TT conv params/FLOPs vs dense
    (reference numeric_example2.py)."""
    print("== example 2: general-order TT conv cost accounting ==")
    spec = TTConvSpec.create((8, 4, 9, 4, 8), (1, 8, 16, 16, 8, 1), 32)
    p, f = tt_conv_cost(spec, (8, 8))
    dp, df = dense_conv_cost((8, 8), 32, 32, 3, 3)
    print(f"  TT   : params {p:6d}  flops/px {f}")
    print(f"  dense: params {dp:6d}  flops/px {df}")
    print(f"  compression {dp / p:.2f}x params, speedup {df / f:.2f}x flops")
    return {"params": p, "flops": f, "dense_params": dp, "dense_flops": df}


def example3_tt_fc_costs() -> dict:
    """General TT fully-connected layer accounting
    (reference numeric_example3.py)."""
    print("== example 3: TT fully-connected layer cost accounting ==")
    spec = TTLinearSpec.create((8, 8, 8, 8), (1, 8, 10, 8, 1), 64)
    p, f = tt_linear_cost(spec)
    dp, df = dense_linear_cost(64, 64)
    print(f"  TT   : params {p:6d}  flops {f}")
    print(f"  dense: params {dp:6d}  flops {df}")
    print(f"  compression {dp / p:.2f}x params")
    return {"params": p, "flops": f, "dense_params": dp, "dense_flops": df}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", default=0, type=int)
    args = ap.parse_args(argv)
    example1_order1_tt_conv(args.seed, args.device)
    example2_general_tt_conv_costs()
    example3_tt_fc_costs()


if __name__ == "__main__":
    main()
