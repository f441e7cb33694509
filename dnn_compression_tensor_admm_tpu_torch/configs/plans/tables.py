"""Build RankPlans from the reference rank tables.

`reference_hp.json` here is a copy of every table of the JAX package's
`configs/plans/reference_hp.json`, value for value (TK, TT and SVD, for
the CIFAR and ImageNet ResNets, MobileNetV2 and MobileNetV2-CIFAR, VGG16,
the DenseNets and the ViTs). TK entries are ``[out_rank, in_rank]``, TT
entries a TT rank list beside their ``tt_shapes``, SVD entries one rank;
a rank list of length 1 means plain SVD. A model whose table is missing
at a numeric ratio takes the automatic plan (`configs/auto_plan.py`,
through the resolver).
"""

from __future__ import annotations

import functools
import json
import os
from typing import Callable

from ..hp import RankPlan, SVDSpec, TKSpec, TTConvSpec, TTLinearSpec

_JSON = os.path.join(os.path.dirname(__file__), "reference_hp.json")


@functools.cache
def reference_tables() -> dict:
    with open(_JSON) as f:
        return json.load(f)


def table_entry(fmt: str, model: str, ratio: str,
                tt_type: str = "general") -> dict:
    t = reference_tables()
    try:
        return t[fmt][model][f"{ratio}|{tt_type}"]
    except KeyError:
        avail = sorted(t.get(fmt, {}).get(model, {}))
        raise KeyError(f"no reference table for {fmt}/{model}/{ratio}/"
                       f"{tt_type}; have {avail}") from None


def build_tk_plan(model: str, ratio: str) -> RankPlan:
    layers = {}
    for name, r in table_entry("tk", model, ratio)["ranks"].items():
        if isinstance(r, int) or len(r) == 1:
            layers[name] = SVDSpec(r if isinstance(r, int) else r[0])
        else:
            layers[name] = TKSpec(int(r[0]), int(r[1]))
    return RankPlan("tk", layers)


def build_svd_plan(model: str, ratio: str) -> RankPlan:
    """Plain low-rank plan: one SVD rank per layer."""
    return RankPlan("svd", {
        name: SVDSpec(r if isinstance(r, int) else r[0])
        for name, r in table_entry("svd", model, ratio)["ranks"].items()})


def _build_tt_plan(spec_cls, model: str, ratio: str, tt_type: str,
                   out_fn: Callable[[str], int]) -> RankPlan:
    e = table_entry("tt", model, ratio, tt_type)
    layers = {}
    for name, r in e["ranks"].items():
        if isinstance(r, int) or len(r) == 1:
            layers[name] = SVDSpec(r if isinstance(r, int) else r[0])
        else:
            layers[name] = spec_cls.create(tuple(e["tt_shapes"][name]),
                                           tuple(r), out_fn(name))
    return RankPlan("tt", layers)


def build_tt_conv_plan(model: str, ratio: str, tt_type: str,
                       out_channels_fn: Callable[[str], int]) -> RankPlan:
    """TT plan of a conv network; `out_channels_fn(name)` gives a layer's
    output channels, which fix where its shapes split."""
    return _build_tt_plan(TTConvSpec, model, ratio, tt_type, out_channels_fn)


def build_tt_linear_plan(model: str, ratio: str, tt_type: str,
                         out_features_fn: Callable[[str], int]) -> RankPlan:
    """TT plan of a transformer's linears; `out_features_fn(name)` gives a
    layer's output features, which fix where its shapes split."""
    return _build_tt_plan(TTLinearSpec, model, ratio, tt_type,
                          out_features_fn)
