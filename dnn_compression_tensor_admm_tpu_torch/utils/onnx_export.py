"""ONNX export with no `onnx` package: a real ``.onnx`` file (counterpart
of the JAX package's `utils/onnx_export.py`, whose graphs it writes byte
for byte).

A minimal protobuf wire-format writer (ONNX files are plain proto3
messages), its reader (`pb_fields`, `onnx_attrs`), plus graph emitters for the ResNet families (CIFAR and
ImageNet; dense, Tucker-2, TT or SVD convs) and ViT/DeiT (dense or
factorized linears). The emitters walk a JAX-layout variables tree
(nested dicts of numpy arrays under 'params' and 'batch_stats'), which
`export_onnx` makes from the port's model or state dict with
`utils/jax_weights.py::state_dict_to_jax`, so a graph is the JAX
exporter's by construction. Factorized convs export as their chain form,
Conv1x1(in-merge) -> Conv(core) -> Conv1x1(out-merge); TT chains are
merged into matrices beforehand (`ops/contractions.py::merge_tt_matrix`,
float32 with TF32 off), the reference's M-variant forward.

Field numbers follow onnx/onnx.proto3 (ModelProto: ir_version=1,
graph=7, opset_import=8; GraphProto: node=1, name=2, initializer=5,
input=11, output=12; NodeProto: input=1, output=2, name=3, op_type=4,
attribute=5; AttributeProto: name=1, f=2, i=3, s=4, ints=8, type=20;
TensorProto: dims=1, data_type=2, name=8, raw_data=9). The graphs use
opset 13 ops only (Conv, BatchNormalization, Relu, Add, MaxPool,
GlobalAveragePool, Flatten, Gemm, Slice, Pad; for the ViT MatMul,
Reshape, Transpose, Gather, Concat, Softmax, ReduceMean, Sub, Mul, Div,
Sqrt, Erf). The input is NCHW at batch 1.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..ops.contractions import merge_tt_matrix
from ..ops.precision import full_f32
from .jax_weights import state_dict_to_jax

# ---------------------------------------------------------------------------
# protobuf wire-format primitives


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def pb_int(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def pb_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def pb_str(field: int, value: str) -> bytes:
    return pb_bytes(field, value.encode())


def pb_msg(field: int, payload: bytes) -> bytes:
    return pb_bytes(field, payload)


# ---------------------------------------------------------------------------
# the reader of what the writer above writes


def _pb_varint(buf: bytes, i: int):
    shift = val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def pb_fields(buf: bytes) -> dict:
    """A protobuf message's fields: {number: [values]} (varints as ints,
    length-delimited as bytes, 32-bit as float: the wire types
    `attribute` and the builders write)."""
    out, i = {}, 0
    while i < len(buf):
        key, i = _pb_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _pb_varint(buf, i)
        elif wire == 2:
            n, i = _pb_varint(buf, i)
            val, i = buf[i:i + n], i + n
        elif wire == 5:
            val, i = struct.unpack("<f", buf[i:i + 4])[0], i + 4
        else:
            raise ValueError(f"protobuf wire type {wire}")
        out.setdefault(field, []).append(val)
    return out


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def onnx_attrs(node: dict) -> dict:
    """A NodeProto's attributes (its `pb_fields`) as {name: value}."""
    out = {}
    for ab in node.get(5, []):
        f = pb_fields(ab)
        kind = f[20][0]
        value = {1: lambda: f[2][0], 2: lambda: _signed(f[3][0]),
                 3: lambda: f[4][0].decode(),
                 7: lambda: [_signed(v) for v in f.get(8, [])]}.get(kind)
        if value is None:
            raise ValueError(f"ONNX attribute type {kind}")
        out[f[1][0].decode()] = value()
    return out


# ---------------------------------------------------------------------------
# ONNX message builders (proto3 field numbers in module docstring)

FLOAT = 1
INT64 = 7

ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_INTS = 1, 2, 3, 7


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    dtype = {np.dtype(np.float32): FLOAT, np.dtype(np.int64): INT64}[arr.dtype]
    out = b"".join(pb_int(1, d) for d in arr.shape)
    out += pb_int(2, dtype)
    out += pb_str(8, name)
    out += pb_bytes(9, arr.tobytes())
    return out


def attribute(name: str, value) -> bytes:
    out = pb_str(1, name)
    if isinstance(value, float):
        out += struct.pack("<B", (2 << 3) | 5) + struct.pack("<f", value)
        out += pb_int(20, ATTR_FLOAT)
    elif isinstance(value, int):
        out += pb_int(3, value)
        out += pb_int(20, ATTR_INT)
    elif isinstance(value, str):
        out += pb_str(4, value)
        out += pb_int(20, ATTR_STRING)
    elif isinstance(value, (list, tuple)):
        out += b"".join(pb_int(8, int(v)) for v in value)
        out += pb_int(20, ATTR_INTS)
    else:
        raise TypeError(f"attribute {name}: {type(value)}")
    return out


def node_proto(op: str, inputs: Sequence[str], outputs: Sequence[str],
               name: str = "", **attrs) -> bytes:
    out = b"".join(pb_str(1, i) for i in inputs)
    out += b"".join(pb_str(2, o) for o in outputs)
    out += pb_str(3, name or outputs[0])
    out += pb_str(4, op)
    out += b"".join(pb_msg(5, attribute(k, v)) for k, v in attrs.items())
    return out


def value_info(name: str, shape: Sequence[int]) -> bytes:
    dims = b"".join(pb_msg(1, pb_int(1, d)) for d in shape)
    ttype = pb_int(1, FLOAT) + pb_msg(2, dims)
    return pb_str(1, name) + pb_msg(2, pb_msg(1, ttype))


class OnnxGraph:
    def __init__(self, name: str):
        self.name = name
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self.inputs: List[bytes] = []
        self.outputs: List[bytes] = []
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init(self, name: str, arr: np.ndarray) -> str:
        a = np.ascontiguousarray(arr)
        if np.ndim(arr) == 0:
            a = a.reshape(())  # ascontiguousarray promotes 0-d to [1]
        self.inits.append(tensor_proto(name, a))
        return name

    def node(self, op: str, inputs: Sequence[str], out: str = None, **attrs) -> str:
        out = out or self.fresh(op.lower())
        self.nodes.append(node_proto(op, inputs, [out], **attrs))
        return out

    def serialize(self, opset: int = 13, producer: str = "dcta-tpu") -> bytes:
        g = b"".join(pb_msg(1, n) for n in self.nodes)
        g += pb_str(2, self.name)
        g += b"".join(pb_msg(5, i) for i in self.inits)
        g += b"".join(pb_msg(11, i) for i in self.inputs)
        g += b"".join(pb_msg(12, o) for o in self.outputs)
        model = pb_int(1, 8)                       # ir_version 8
        model += pb_str(2, producer)
        model += pb_msg(7, g)
        model += pb_msg(8, pb_str(1, "") + pb_int(2, opset))
        return model


# ---------------------------------------------------------------------------
# layer emitters: JAX-layout param dicts -> ONNX nodes (NCHW)


def _np(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _merge(cores) -> np.ndarray:
    """A TT chain merged into its matrix, float32 on the CPU."""
    with full_f32():
        m = merge_tt_matrix([torch.from_numpy(_np(c)) for c in cores])
    return m.numpy()


def _conv_kind(p: Dict) -> str:
    if "kernel" in p:
        return "dense"
    if "core_kernel" in p and any(k.startswith("in_core") or k.startswith("out_core")
                                  for k in p):
        return "tt"
    if "core_kernel" in p:
        return "tk"
    if "first_factor" in p and "last_factor" in p:
        return "svd"
    raise ValueError(f"unrecognized conv params: {sorted(p)}")


def _conv1x1(g: OnnxGraph, x: str, w_oi: np.ndarray, prefix: str,
             stride: int = 1) -> str:
    w = g.init(f"{prefix}.w", w_oi[:, :, None, None])
    return g.node("Conv", [x, w], out=g.fresh(prefix),
                  kernel_shape=[1, 1], strides=[stride, stride],
                  pads=[0, 0, 0, 0])


def emit_conv(g: OnnxGraph, x: str, p: Dict, prefix: str, stride: int,
              padding: int) -> str:
    """One (possibly factorized) conv layer as ONNX nodes; returns the
    output value name. Factorized layers emit their chain form."""
    kind = _conv_kind(p)
    if kind == "dense":
        w = _np(p["kernel"]).transpose(3, 2, 0, 1)     # HWIO -> OIHW
        kh, kw = w.shape[2], w.shape[3]
        wn = g.init(f"{prefix}.weight", w)
        ins = [x, wn]
        if "bias" in p:
            ins.append(g.init(f"{prefix}.bias", _np(p["bias"])))
        return g.node("Conv", ins, out=g.fresh(prefix), kernel_shape=[kh, kw],
                      strides=[stride, stride],
                      pads=[padding, padding, padding, padding])
    if kind == "svd":
        # 1x1 chain; stride folds into the first pointwise conv
        y = _conv1x1(g, x, _np(p["first_factor"]), f"{prefix}.first", stride)
        y = _conv1x1(g, y, _np(p["last_factor"]), f"{prefix}.last")
        return _maybe_bias(g, y, p, prefix)
    if kind == "tk":
        first, last = _np(p["first_factor"]), _np(p["last_factor"])
    else:  # tt: merge the in/out core chains into matrices
        in_cores = [_np(p[f"in_core_{i}"]) for i in
                    range(sum(k.startswith("in_core") for k in p))]
        out_cores = [_np(p[f"out_core_{i}"]) for i in
                     range(sum(k.startswith("out_core") for k in p))]
        first = _merge(in_cores) if in_cores else None
        last = _merge(out_cores)
    core = _np(p["core_kernel"]).transpose(3, 2, 0, 1)  # HWIO -> OIHW
    kh, kw = core.shape[2], core.shape[3]
    y = x if first is None else _conv1x1(g, x, first, f"{prefix}.first")
    cw = g.init(f"{prefix}.core", core)
    y = g.node("Conv", [y, cw], out=g.fresh(prefix + ".corec"),
               kernel_shape=[kh, kw], strides=[stride, stride],
               pads=[padding, padding, padding, padding])
    y = _conv1x1(g, y, last, f"{prefix}.last")
    return _maybe_bias(g, y, p, prefix)


def _maybe_bias(g: OnnxGraph, x: str, p: Dict, prefix: str) -> str:
    if "bias" not in p:
        return x
    b = _np(p["bias"])
    bn = g.init(f"{prefix}.biasv", b.reshape(1, -1, 1, 1))
    return g.node("Add", [x, bn], out=g.fresh(prefix + ".addb"))


def emit_bn(g: OnnxGraph, x: str, p: Dict, stats: Dict, prefix: str) -> str:
    ins = [x,
           g.init(f"{prefix}.scale", _np(p["scale"])),
           g.init(f"{prefix}.bias", _np(p["bias"])),
           g.init(f"{prefix}.mean", _np(stats["mean"])),
           g.init(f"{prefix}.var", _np(stats["var"]))]
    return g.node("BatchNormalization", ins, out=g.fresh(prefix),
                  epsilon=1e-5)


def emit_gemm(g: OnnxGraph, x: str, p: Dict, prefix: str) -> str:
    w = g.init(f"{prefix}.weight", _np(p["kernel"]).T)   # [out, in]
    b = g.init(f"{prefix}.bias", _np(p["bias"]))
    return g.node("Gemm", [x, w, b], out=g.fresh(prefix), transB=1)


# ---------------------------------------------------------------------------
# ResNet graph emitters (topology derived from the variables tree)


def _layers(params) -> List[str]:
    names = sorted(k for k in params if k.startswith("layer"))

    def key(n):
        stage, idx = n[5:].split(".")
        return int(stage), int(idx)

    return sorted(names, key=key)


def export_resnet_onnx(variables, path: str, *, num_classes: int,
                       input_size: int) -> bytes:
    """Emit a ResNet (CIFAR or ImageNet family; dense or factorized) as a
    complete ``.onnx`` model. Topology — stem kind, block kind, strides,
    shortcut style — is derived from the variables tree, so every
    resnet20/32/56/18/34/50 dense/tkc/ttm/svdc checkpoint exports through
    this one function (reference: convert_onnx_resnet.py:66-78)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    g = OnnxGraph("dcta_resnet")
    g.inputs.append(value_info("input", [1, 3, input_size, input_size]))

    stem_kernel = params["conv1"].get("kernel")
    cifar = stem_kernel is not None and stem_kernel.shape[0] == 3 \
        and stem_kernel.shape[3] <= 16
    y = emit_conv(g, "input", params["conv1"], "conv1",
                  stride=1 if cifar else 2, padding=1 if cifar else 3)
    y = emit_bn(g, y, params["bn1"], stats["bn1"], "bn1")
    y = g.node("Relu", [y])
    if not cifar:
        y = g.node("MaxPool", [y], kernel_shape=[3, 3], strides=[2, 2],
                   pads=[1, 1, 1, 1])

    for lname in _layers(params):
        stage, idx = (int(v) for v in lname[5:].split("."))
        block = params[lname]
        bstats = stats.get(lname, {})
        bottleneck = "conv3" in block
        first_of_stage = idx == 0
        stride = 2 if (first_of_stage and stage > 1) else 1
        x_in = y
        if bottleneck:
            y = emit_conv(g, y, block["conv1"], f"{lname}.conv1", 1, 0)
            y = emit_bn(g, y, block["bn1"], bstats["bn1"], f"{lname}.bn1")
            y = g.node("Relu", [y])
            y = emit_conv(g, y, block["conv2"], f"{lname}.conv2", stride, 1)
            y = emit_bn(g, y, block["bn2"], bstats["bn2"], f"{lname}.bn2")
            y = g.node("Relu", [y])
            y = emit_conv(g, y, block["conv3"], f"{lname}.conv3", 1, 0)
            y = emit_bn(g, y, block["bn3"], bstats["bn3"], f"{lname}.bn3")
        else:
            y = emit_conv(g, y, block["conv1"], f"{lname}.conv1", stride, 1)
            y = emit_bn(g, y, block["bn1"], bstats["bn1"], f"{lname}.bn1")
            y = g.node("Relu", [y])
            y = emit_conv(g, y, block["conv2"], f"{lname}.conv2", 1, 1)
            y = emit_bn(g, y, block["bn2"], bstats["bn2"], f"{lname}.bn2")

        if "downsample.0" in block:                 # ImageNet projection
            sc = emit_conv(g, x_in, block["downsample.0"],
                           f"{lname}.downsample.0", stride, 0)
            sc = emit_bn(g, sc, block["downsample.1"],
                         bstats["downsample.1"], f"{lname}.downsample.1")
        elif cifar and first_of_stage and stage > 1:  # option-A shortcut
            starts = g.init(g.fresh("sl_st"), np.array([0, 0], np.int64))
            ends = g.init(g.fresh("sl_en"),
                          np.array([2 ** 31 - 1, 2 ** 31 - 1], np.int64))
            axes = g.init(g.fresh("sl_ax"), np.array([2, 3], np.int64))
            steps = g.init(g.fresh("sl_sp"), np.array([2, 2], np.int64))
            sc = g.node("Slice", [x_in, starts, ends, axes, steps])
            planes = _block_out_channels(block)
            pad = planes // 4
            pads = g.init(g.fresh("padv"),
                          np.array([0, pad, 0, 0, 0, pad, 0, 0], np.int64))
            sc = g.node("Pad", [sc, pads], mode="constant")
        else:
            sc = x_in
        y = g.node("Add", [y, sc])
        y = g.node("Relu", [y])

    y = g.node("GlobalAveragePool", [y])
    y = g.node("Flatten", [y], axis=1)
    head = "linear" if "linear" in params else "fc"
    y = emit_gemm(g, y, params[head], head)
    g.outputs.append(value_info(y, [1, num_classes]))
    data = g.serialize()
    with open(path, "wb") as f:
        f.write(data)
    return data


# ---------------------------------------------------------------------------
# ViT / DeiT graph emitter (reference convert_onnx_vit.py:73-85)


def _linear_chain_matrices(p: Dict, out_features: int) -> List[np.ndarray]:
    """A (possibly factorized) linear as a chain of [in, out]-oriented
    matmul matrices: y = x @ M0 @ M1 ... (+ bias). TT linears pre-merge
    their out/in core chains into two matrices (ops/contractions.py::
    merge_tt_matrix) — exactly the factorized M-variant forward the
    reference exports; TK stays the 3-matmul chain, SVD the 2-matmul."""
    if "kernel" in p:
        return [_np(p["kernel"])]               # flax Dense stores [in, out]
    if any(k.startswith("core_") for k in p):   # TT chain
        d = sum(k.startswith("core_") for k in p)
        cores = [p[f"core_{i}"] for i in range(d)]
        oo, prod = 0, 1
        while prod < out_features and oo < d:
            prod *= cores[oo].shape[1]
            oo += 1
        if prod != out_features:
            raise ValueError(
                f"TT out-chain does not factor out_features={out_features}")
        a = _merge(cores[:oo])                  # [O, m]
        b = _merge(cores[oo:])                  # [m, I]
        return [b.T, a.T]
    if "core" in p:                             # TK linear
        return [_np(p["first_factor"]).T, _np(p["core"]).T,
                _np(p["last_factor"]).T]
    if "first_factor" in p:                     # SVD linear
        return [_np(p["first_factor"]).T, _np(p["last_factor"]).T]
    raise ValueError(f"unrecognized linear params: {sorted(p)}")


def _emit_linear_nd(g: OnnxGraph, x: str, p: Dict, prefix: str,
                    out_features: int) -> str:
    y = x
    for j, m in enumerate(_linear_chain_matrices(p, out_features)):
        wn = g.init(f"{prefix}.m{j}", m)
        y = g.node("MatMul", [y, wn], out=g.fresh(prefix))
    if "bias" in p:
        bn = g.init(f"{prefix}.bias", _np(p["bias"]))
        y = g.node("Add", [y, bn], out=g.fresh(prefix + ".addb"))
    return y


def _emit_layernorm(g: OnnxGraph, x: str, p: Dict, prefix: str,
                    eps: float = 1e-6) -> str:
    """LayerNorm decomposed to opset-13 ops (LayerNormalization itself is
    opset 17): (x - mean) / sqrt(var + eps) * scale + bias over axis -1."""
    mu = g.node("ReduceMean", [x], axes=[-1], keepdims=1)
    d = g.node("Sub", [x, mu])
    var = g.node("ReduceMean", [g.node("Mul", [d, d])], axes=[-1], keepdims=1)
    epsn = g.init(f"{prefix}.eps", np.array(eps, np.float32))
    y = g.node("Div", [d, g.node("Sqrt", [g.node("Add", [var, epsn])])])
    y = g.node("Mul", [y, g.init(f"{prefix}.scale", _np(p["scale"]))])
    return g.node("Add", [y, g.init(f"{prefix}.bias", _np(p["bias"]))],
                  out=g.fresh(prefix))


def _emit_gelu(g: OnnxGraph, x: str, prefix: str) -> str:
    """Exact gelu (flax nn.gelu approximate=False): x/2 * (1 + erf(x/√2)).
    Erf exists since opset 9; Gelu itself only since opset 20."""
    sqrt2 = g.init(f"{prefix}.sqrt2", np.array(np.sqrt(2.0), np.float32))
    half = g.init(f"{prefix}.half", np.array(0.5, np.float32))
    one = g.init(f"{prefix}.one", np.array(1.0, np.float32))
    e = g.node("Erf", [g.node("Div", [x, sqrt2])])
    return g.node("Mul", [g.node("Mul", [x, half]),
                          g.node("Add", [e, one])], out=g.fresh(prefix))


def _emit_attention(g: OnnxGraph, x: str, p: Dict, prefix: str,
                    dim: int, num_heads: int) -> str:
    """Multi-head self-attention matching models/vit.py::Attention."""
    hd = dim // num_heads
    qkv = _emit_linear_nd(g, x, p["qkv"], f"{prefix}.qkv", 3 * dim)
    shp = g.init(g.fresh(f"{prefix}.shp5"),
                 np.array([1, -1, 3, num_heads, hd], np.int64))
    y = g.node("Reshape", [qkv, shp])
    y = g.node("Transpose", [y], perm=[2, 0, 3, 1, 4])
    qkv_split = []
    for j in range(3):
        idx = g.init(g.fresh(f"{prefix}.i{j}"), np.array(j, np.int64))
        qkv_split.append(g.node("Gather", [y, idx], axis=0))
    q, k, v = qkv_split                          # [B, h, N, hd]
    kt = g.node("Transpose", [k], perm=[0, 1, 3, 2])
    scale = g.init(g.fresh(f"{prefix}.scale"),
                   np.array(hd ** -0.5, np.float32))
    attn = g.node("Mul", [g.node("MatMul", [q, kt]), scale])
    attn = g.node("Softmax", [attn], axis=-1)
    y = g.node("MatMul", [attn, v])
    y = g.node("Transpose", [y], perm=[0, 2, 1, 3])
    shp2 = g.init(g.fresh(f"{prefix}.shp3"), np.array([1, -1, dim], np.int64))
    y = g.node("Reshape", [y, shp2])
    return _emit_linear_nd(g, y, p["proj"], f"{prefix}.proj", dim)


def export_vit_onnx(variables, path: str, *, num_classes: int,
                    num_heads: int, input_size: int = 224,
                    patch_size: int = 16, mlp_ratio: float = 4.0) -> bytes:
    """Emit a ViT/DeiT (dense or TT/TK/SVD-factorized linears) as a
    complete ``.onnx`` model, batch 1, NCHW input (reference:
    convert_onnx_vit.py:73-85 exports the same topology via torch).
    Factorized attention/MLP linears export as their merged matmul
    chains; LayerNorm and gelu are decomposed to opset-13 primitives."""
    params = variables["params"]
    D = int(params["cls_token"].shape[-1])
    hidden = int(D * mlp_ratio)
    depth = sum(1 for k in params if k.startswith("blocks."))
    g = OnnxGraph("dcta_vit")
    g.inputs.append(value_info("input", [1, 3, input_size, input_size]))

    pe = params["patch_embed.proj"]
    w = _np(pe["kernel"]).transpose(3, 2, 0, 1)            # HWIO -> OIHW
    ins = ["input", g.init("patch_embed.w", w)]
    if "bias" in pe:
        ins.append(g.init("patch_embed.b", _np(pe["bias"])))
    y = g.node("Conv", ins, out="patch_tokens_c",
               kernel_shape=[patch_size, patch_size],
               strides=[patch_size, patch_size], pads=[0, 0, 0, 0])
    shp = g.init("patch_shape", np.array([1, D, -1], np.int64))
    y = g.node("Reshape", [y, shp])
    y = g.node("Transpose", [y], perm=[0, 2, 1])           # [1, N, D]
    cls = g.init("cls_token", _np(params["cls_token"]))    # [1, 1, D]
    y = g.node("Concat", [cls, y], axis=1)
    pos = g.init("pos_embed", _np(params["pos_embed"]))
    y = g.node("Add", [y, pos])

    for i in range(depth):
        b = params[f"blocks.{i}"]
        pre = f"blocks.{i}"
        t = _emit_layernorm(g, y, b["norm1"], f"{pre}.norm1")
        t = _emit_attention(g, t, b["attn"], f"{pre}.attn", D, num_heads)
        y = g.node("Add", [y, t], out=g.fresh(f"{pre}.res1"))
        t = _emit_layernorm(g, y, b["norm2"], f"{pre}.norm2")
        t = _emit_linear_nd(g, t, b["mlp.fc1"], f"{pre}.mlp.fc1", hidden)
        t = _emit_gelu(g, t, f"{pre}.mlp")
        t = _emit_linear_nd(g, t, b["mlp.fc2"], f"{pre}.mlp.fc2", D)
        y = g.node("Add", [y, t], out=g.fresh(f"{pre}.res2"))

    y = _emit_layernorm(g, y, params["norm"], "norm")
    idx = g.init("cls_idx", np.array(0, np.int64))
    y = g.node("Gather", [y, idx], axis=1)                 # [1, D]
    y = emit_gemm(g, y, params["head"], "head")
    g.outputs.append(value_info(y, [1, num_classes]))
    data = g.serialize()
    with open(path, "wb") as f:
        f.write(data)
    return data


def _variables(model) -> dict:
    """A JAX-layout variables tree from a model, a state dict or a tree."""
    if isinstance(model, torch.nn.Module):
        model = model.state_dict()
    if "params" in model:
        return model
    return state_dict_to_jax(model)


def export_onnx(model, path: str, *, num_classes: int, input_size: int,
                num_heads: int = None) -> bytes:
    """Write `model` (a port model, its state dict or a JAX-layout
    variables tree) as an ``.onnx`` file at batch 1 and return its bytes.
    ResNet families take the ResNet emitter, ViT/DeiT the ViT emitter;
    anything else is refused with the JAX package's error (which would
    hand a tree with a `conv1` but no residual stages, such as
    MobileNetV2-CIFAR's or a CIFAR DenseNet's, to the ResNet emitter)."""
    variables = _variables(model)
    params = variables["params"]
    if "patch_embed.proj" in params:
        if num_heads is None:
            raise ValueError("ViT ONNX export needs num_heads")
        return export_vit_onnx(variables, path, num_classes=num_classes,
                               num_heads=num_heads, input_size=input_size)
    if "conv1" in params and _layers(params):
        return export_resnet_onnx(variables, path, num_classes=num_classes,
                                  input_size=input_size)
    raise ValueError(
        "ONNX export supports the ResNet and ViT/DeiT families only; "
        f"got a variables tree with top-level keys {sorted(params)[:8]} — "
        "use --export (torch.export) for other models")


def _block_out_channels(block: Dict) -> int:
    p = block["conv2"]
    kind = _conv_kind(p)
    if kind == "dense":
        return p["kernel"].shape[3]
    if kind in ("tk", "svd"):
        return p["last_factor"].shape[0]
    from math import prod  # tt: out channels = prod of out-chain mode sizes
    n = sum(k.startswith("out_core") for k in p)
    return prod(p[f"out_core_{i}"].shape[1] for i in range(n))
