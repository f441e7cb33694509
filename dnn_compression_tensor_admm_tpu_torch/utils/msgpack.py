"""A self-contained MessagePack codec for the subset that flax's
`serialization.msgpack_serialize` writes (and `msgpack_restore` reads).

What it takes: maps with str keys, arrays (decoded as lists), str, bin,
ints, floats, nil and bool, and two extension types:

* ExtType 1, an ndarray: its payload is itself MessagePack of
  ``(shape, dtype name, the C-order bytes)``;
* ExtType 3, a numpy scalar: the same payload for a 0-d array.

A dtype name of ``bfloat16`` (which numpy lacks) decodes to a
``torch.bfloat16`` tensor through a uint16 view, and such a tensor encodes
back to it; every other array is a numpy array. On decode a numpy array's
buffer is a view of the input (read-only), never a copy. Everything else,
ExtType 2 (a complex number) and flax's ``__msgpack_chunked_array__``
form of arrays over 2**30 bytes among it, raises `MsgpackError`.

The encoder picks the same representations as the `msgpack` package
(`use_bin_type=True`, doubles for Python floats, the smallest int and
header forms) and writes map keys sorted, as flax's copy of the tree
orders them, so a tree written here is byte for byte what flax writes.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Input outside the subset of MessagePack that flax writes."""


# ---------------------------------------------------------------------------
# encoder


def _uint_header(out: List[bytes], n: int, fix: int, fix_max: int,
                 codes) -> None:
    """A length header: `fix | n` below fix_max, else the 8/16/32-bit form
    (codes may start with None where an 8-bit form does not exist)."""
    if n < fix_max:
        out.append(bytes([fix | n]))
    elif codes[0] is not None and n < 1 << 8:
        out.append(struct.pack(">BB", codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise MsgpackError(f"object of {n} entries or bytes is too large")


def _pack_int(out: List[bytes], x: int) -> None:
    if 0 <= x < 0x80:
        out.append(bytes([x]))
    elif x >= 0:
        for code, fmt, bound in ((0xcc, ">BB", 1 << 8), (0xcd, ">BH", 1 << 16),
                                 (0xce, ">BI", 1 << 32),
                                 (0xcf, ">BQ", 1 << 64)):
            if x < bound:
                out.append(struct.pack(fmt, code, x))
                return
        raise MsgpackError(f"int {x} does not fit 64 bits")
    elif x >= -32:
        out.append(struct.pack(">b", x))
    else:
        for code, fmt, bound in ((0xd0, ">Bb", 1 << 7), (0xd1, ">Bh", 1 << 15),
                                 (0xd2, ">Bi", 1 << 31),
                                 (0xd3, ">Bq", 1 << 63)):
            if x >= -bound:
                out.append(struct.pack(fmt, code, x))
                return
        raise MsgpackError(f"int {x} does not fit 64 bits")


def _pack_bin(out: List[bytes], b) -> None:
    _uint_header(out, len(b), 0, 0, (0xc4, 0xc5, 0xc6))
    out.append(bytes(b))


def _pack_ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(struct.pack(">Bb", fixed[n], code))
    elif n < 1 << 8:
        out.append(struct.pack(">BBb", 0xc7, n, code))
    elif n < 1 << 16:
        out.append(struct.pack(">BHb", 0xc8, n, code))
    elif n < 1 << 32:
        out.append(struct.pack(">BIb", 0xc9, n, code))
    else:
        raise MsgpackError(f"extension payload of {n} bytes is too large")
    out.append(data)


def _array_payload(a) -> bytes:
    """flax's `_ndarray_to_bytes`: MessagePack of (shape, dtype name, C-order
    bytes) of a numpy array or a torch tensor (bfloat16 by its bits)."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name = tuple(t.shape), "bfloat16"
            raw = t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
    if isinstance(a, np.ndarray):
        if a.dtype.hasobject or a.dtype.fields is not None:
            raise MsgpackError(f"dtype {a.dtype} is not serialisable")
        shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    out: List[bytes] = []
    _uint_header(out, 3, 0x90, 16, (None, 0xdc, 0xdd))
    _pack(out, [int(s) for s in shape])
    _pack(out, name)
    _pack_bin(out, raw)
    return b"".join(out)


def _pack(out: List[bytes], x: Any) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xcb, x))
    elif type(x) is str:
        b = x.encode("utf-8")
        _uint_header(out, len(b), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(b)
    elif type(x) is bytes:
        _pack_bin(out, x)
    elif type(x) is dict:
        if any(type(k) is not str for k in x):
            raise MsgpackError(f"a map key of {list(x)} is not a str")
        _uint_header(out, len(x), 0x80, 16, (None, 0xde, 0xdf))
        for k in sorted(x):  # flax's tree_map rebuilds every dict sorted
            _pack(out, k)
            _pack(out, x[k])
    elif type(x) is list:
        _uint_header(out, len(x), 0x90, 16, (None, 0xdc, 0xdd))
        for v in x:
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        nbytes = (x.numel() * x.element_size() if isinstance(x, torch.Tensor)
                  else x.nbytes)
        if nbytes > 1 << 30:
            raise MsgpackError("arrays over 2**30 bytes take flax's chunked "
                               "form, which is not supported")
        _pack_ext(out, EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(x)))
    else:
        raise MsgpackError(f"cannot serialise a {type(x).__name__}")


def packb(tree: Any) -> bytes:
    """MessagePack bytes of `tree`, as flax's `msgpack_serialize` writes
    them for a tree of dicts (str keys), lists, Python scalars, numpy
    arrays and scalars and torch tensors."""
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)


# ---------------------------------------------------------------------------
# decoder


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise MsgpackError("truncated input")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _array_from_payload(data: memoryview, scalar: bool):
    shape, name, buf = _unpack_all(data, raw=True)
    if not (isinstance(shape, list) and isinstance(name, (bytes, memoryview))
            and isinstance(buf, memoryview)):
        raise MsgpackError("malformed ndarray payload")
    name = bytes(name).decode("ascii")
    if name == "bfloat16":
        a = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise MsgpackError(f"unknown dtype {name!r}") from e
    a = np.frombuffer(buf, dtype=dtype).reshape(shape)
    return a[()] if scalar else a


def _decode(r: _Reader, raw: bool):
    b = r.unpack(">B")
    if b < 0x80:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f, raw)
    if 0x90 <= b <= 0x9f:
        return [_decode(r, raw) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return _str(r.take(b & 0x1f), raw)
    if b == 0xc0:
        return None
    if b == 0xc2:
        return False
    if b == 0xc3:
        return True
    if b in (0xc4, 0xc5, 0xc6):  # a view inside an ndarray payload
        v = r.take(r.unpack({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[b]))
        return v if raw else bytes(v)
    if b in (0xc7, 0xc8, 0xc9):
        n = r.unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b])
        return _ext(r.unpack(">b"), r.take(n))
    if b == 0xca:
        return r.unpack(">f")
    if b == 0xcb:
        return r.unpack(">d")
    ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if 0xd4 <= b <= 0xd8:
        code = r.unpack(">b")
        return _ext(code, r.take(1 << (b - 0xd4)))
    if b in (0xd9, 0xda, 0xdb):
        return _str(r.take(r.unpack({0xd9: ">B", 0xda: ">H",
                                     0xdb: ">I"}[b])), raw)
    if b in (0xdc, 0xdd):
        n = r.unpack(">H" if b == 0xdc else ">I")
        return [_decode(r, raw) for _ in range(n)]
    if b in (0xde, 0xdf):
        return _map(r, r.unpack(">H" if b == 0xde else ">I"), raw)
    raise MsgpackError(f"unsupported MessagePack type byte 0x{b:02x}")


def _str(v: memoryview, raw: bool):
    return bytes(v) if raw else str(v, "utf-8")


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r, raw)
        if not isinstance(k, str):
            raise MsgpackError(f"map key {k!r} is not a str")
        if k == CHUNKED_KEY:
            raise MsgpackError("flax's chunked form of arrays over 2**30 "
                               "bytes is not supported")
        out[k] = _decode(r, raw)
    return out


def _ext(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _array_from_payload(data, scalar=False)
    if code == EXT_NPSCALAR:
        return _array_from_payload(data, scalar=True)
    raise MsgpackError(f"unsupported MessagePack extension type {code}")


def _unpack_all(buf, raw: bool = False):
    r = _Reader(buf)
    out = _decode(r, raw)
    if r.pos != len(r.buf):
        raise MsgpackError(f"{len(r.buf) - r.pos} bytes after the object")
    return out


def unpackb(buf) -> Any:
    """The tree MessagePack bytes hold, as flax's `msgpack_restore` gives
    it: dicts, lists, Python scalars, numpy arrays and scalars (views of
    `buf`) and bfloat16 torch tensors."""
    return _unpack_all(buf)
