"""flax's msgpack format without flax or the msgpack package.

`msgpack_serialize` and `msgpack_restore` write and read the bytes of
`flax.serialization.msgpack_serialize` / `msgpack_restore`: a tree of
dicts with numpy leaves, its dict keys in sorted order at every level (flax
copies the tree with `jax.tree_util.tree_map`, which sorts them), each
array as msgpack ext type 1 holding the packed (shape, dtype name,
C-order bytes) triple, numpy scalars as ext type 3 and Python complex
numbers as ext type 2. An array of more than MAX_CHUNK_SIZE bytes is
written as flax chunks it: a dict `{"__msgpack_chunked_array__": True,
"shape": {"0": ...}, "chunks": {"0": flat chunk, ...}}`, and restored
whole. The checkpoints that `tools/convert_pth.py` writes and
`train/cv.py --ckpt` reads go through this module; the card's machine
has neither package.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# -- encoding (the msgpack package's Packer, use_bin_type=True) -------------


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0 <= n <= 0xFF:
        return b"\xcc" + struct.pack("B", n)
    if -0x80 <= n < 0:
        return b"\xd0" + struct.pack("b", n)
    if 0 <= n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if -0x8000 <= n < 0:
        return b"\xd1" + struct.pack(">h", n)
    if 0 <= n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    if -0x80000000 <= n < 0:
        return b"\xd2" + struct.pack(">i", n)
    if 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", n)
    if -0x8000000000000000 <= n < 0:
        return b"\xd3" + struct.pack(">q", n)
    raise OverflowError(f"integer {n} out of msgpack's range")


def _sized(n: int, fix: Tuple[int, int], formats) -> bytes:
    """The header of a str, bin, array or map of n items: the fix form
    (base, limit) where one exists and n is below its limit, else the
    first of `formats` ((code, struct format, limit)) that holds n."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for code, fmt, limit in formats:
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} items exceed msgpack's limit")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    if n in _FIXEXT:
        head = bytes([_FIXEXT[n]])
    elif n <= 0xFF:
        head = b"\xc7" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        head = b"\xc8" + struct.pack(">H", n)
    else:
        head = b"\xc9" + struct.pack(">I", n)
    return head + struct.pack("b", code) + data


def _pack(obj, out: list, strict: bool) -> None:
    """Append obj's msgpack bytes to out. `strict` is the msgpack
    package's strict_types (flax's outer call): a tuple then is not an
    array; the inner (shape, dtype, bytes) triple packs tuples as
    arrays."""
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        out.append(_int(obj))
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif t is str:
        data = obj.encode("utf-8")
        out.append(_sized(len(data), (0xA0, 32), _STR))
        out.append(data)
    elif t in (bytes, bytearray, memoryview):
        data = bytes(obj)
        out.append(_sized(len(data), None, _BIN))
        out.append(data)
    elif t is list or (t is tuple and not strict):
        out.append(_sized(len(obj), (0x90, 16), _ARRAY))
        for v in obj:
            _pack(v, out, strict)
    elif t is dict:
        out.append(_sized(len(obj), (0x80, 16), _MAP))
        for k, v in obj.items():
            _pack(k, out, strict)
            _pack(v, out, strict)
    elif isinstance(obj, np.ndarray):
        out.append(_ext(_EXT_NDARRAY, _array_bytes(obj)))
    elif isinstance(obj, np.generic):
        out.append(_ext(_EXT_NPSCALAR, _array_bytes(np.asarray(obj))))
    elif t is complex:
        out.append(_ext(_EXT_COMPLEX, _packb((obj.real, obj.imag), False)))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _packb(obj, strict: bool) -> bytes:
    out: list = []
    _pack(obj, out, strict)
    return b"".join(out)


def _array_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for "
                         "serialization of ndarrays.")
    return _packb((arr.shape, arr.dtype.name, arr.tobytes("C")), False)


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): s for i, s in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _prepare(tree):
    """flax's copy of the tree: dict keys sorted at every level, the
    arrays above MAX_CHUNK_SIZE bytes chunked."""
    if isinstance(tree, dict):
        return {k: _prepare(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_prepare(v) for v in tree)
    if isinstance(tree, np.ndarray) \
            and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def msgpack_serialize(pytree) -> bytes:
    """The bytes of `flax.serialization.msgpack_serialize(pytree)`."""
    return _packb(_prepare(pytree), True)


# -- decoding (unpackb with raw=False and flax's ext hook) ------------------


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def obj(self) -> Any:
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map_(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.str_(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            return self.unpack(ints[c])
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in sized:
            return self.str_(self.unpack(sized[c]))
        bins = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in bins:
            return self.take(self.unpack(bins[c]))
        if c in (0xDC, 0xDD):
            n = self.unpack(">H" if c == 0xDC else ">I")
            return [self.obj() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if c == 0xDE else ">I"))
        fixext = {v: k for k, v in _FIXEXT.items()}
        if c in fixext:
            return self.ext(fixext[c])
        exts = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in exts:
            return self.ext(self.unpack(exts[c]))
        raise ValueError(f"unknown msgpack type byte 0x{c:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _array_from_bytes(data)
        if code == _EXT_COMPLEX:
            re, im = _unpackb(data, raw=False)
            return complex(re, im)
        if code == _EXT_NPSCALAR:
            return _array_from_bytes(data)[()]
        raise ValueError(f"unknown msgpack ext type {code}")


def _unpackb(data: bytes, raw: bool):
    r = _Reader(data, raw)
    obj = r.obj()
    if r.pos != len(r.data):
        raise ValueError("extra bytes after the msgpack object")
    return obj


def _array_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 arrays need ml_dtypes; convert the tree "
                         "to float32 before writing it")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order="C")


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(encoded: bytes):
    """The tree of `flax.serialization.msgpack_restore(encoded)`: dicts
    with numpy leaves (read-only views of the bytes, as flax's are),
    chunked arrays whole."""
    return _unchunk(_unpackb(encoded, raw=False))
