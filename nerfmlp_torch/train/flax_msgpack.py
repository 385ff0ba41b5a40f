"""The JAX package's ``.ckpt`` files: flax's msgpack serialization, read and
written with the standard library (the card's machine has no flax and no
msgpack).

Counterpart of ``flax.serialization.msgpack_restore`` / ``to_bytes`` over
the subset of msgpack that flax writes for a param tree or a train state:

  * maps (string keys; flax stores tuples and lists as ``{"0": ...}``
    maps, and :func:`encode` does the same), arrays, str, bin, int, float,
    bool and nil;
  * ext type 1, an ndarray, and ext type 3, a numpy scalar: each payload
    is the msgpack triple ``(shape, dtype name, C-order bytes)``. Dtype
    names are numpy's, plus ``bfloat16``, whose leaves decode to
    ``torch.bfloat16`` tensors (numpy has no such type); every other array
    decodes to a numpy array;
  * leaves above :data:`MAX_CHUNK_SIZE` bytes, stored as
    ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``.

Bytes that end early or do not parse raise :class:`CheckpointCorruptError`.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30   # flax's: bytes per array leaf before chunking
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class CheckpointCorruptError(Exception):
    """The file cannot be decoded: truncated, or not flax's msgpack.
    Distinct from an architecture mismatch (a ``ValueError``): a corrupt
    resume file can be skipped, a wrong architecture is the user's to fix.
    The counterpart of ``nerfmlp_tpu/train/checkpoint.py:31-37``."""


# ------------------------------------------------------------------ decode

class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.buf):
            raise CheckpointCorruptError(
                f"truncated: {n} bytes wanted at offset {self.pos} of "
                f"{len(self.buf)}")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# Fixed-width formats: first byte -> struct format of the value.
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# Lengths of str / bin / array / map / ext: first byte -> (kind, format).
_SIZED = {0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _read(r: _Reader) -> Any:
    b = r.unpack(">B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _read_map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_read(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return _utf8(r.take(b & 0x1f))
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _SCALARS:
        return r.unpack(_SCALARS[b])
    if b in _FIXEXT:
        return _ext(r.unpack(">b"), r.take(_FIXEXT[b]))
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.unpack(fmt)
        if kind == "str":
            return _utf8(r.take(n))
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "array":
            return [_read(r) for _ in range(n)]
        if kind == "map":
            return _read_map(r, n)
        return _ext(r.unpack(">b"), r.take(n))
    raise CheckpointCorruptError(f"not msgpack: type byte 0x{b:02x} at "
                                 f"offset {r.pos - 1}")


def _utf8(raw: memoryview) -> str:
    try:
        return str(raw, "utf-8")
    except UnicodeDecodeError as e:
        raise CheckpointCorruptError(f"bad utf-8 string: {e}") from e


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        if not isinstance(key, (str, int)):
            raise CheckpointCorruptError(f"map key of type "
                                         f"{type(key).__name__}")
        out[key] = _read(r)
    return out


def _ext(code: int, payload: memoryview):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise CheckpointCorruptError(f"unsupported msgpack ext type {code}")
    r = _Reader(payload)
    triple = _read(r)
    if (r.pos != len(payload) or not isinstance(triple, list)
            or len(triple) != 3):
        raise CheckpointCorruptError("malformed ndarray payload")
    shape, name, raw = triple
    if (not isinstance(shape, list) or not isinstance(raw, bytes)
            or not all(isinstance(s, int) and s >= 0 for s in shape)):
        raise CheckpointCorruptError("malformed ndarray payload")
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        itemsize, dtype = 2, None
    else:
        try:
            dtype = np.dtype(name)
        except TypeError as e:
            raise CheckpointCorruptError(f"unknown dtype {name!r}") from e
        itemsize = dtype.itemsize
    if len(raw) != int(np.prod(shape, dtype=np.int64)) * itemsize:
        raise CheckpointCorruptError(
            f"ndarray of shape {tuple(shape)} {name} holds {len(raw)} bytes")
    if dtype is None:
        arr = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)
        arr = arr.reshape(shape)
        return arr.reshape(()) if code == EXT_NPSCALAR else arr
    arr = np.frombuffer(raw, dtype=dtype).reshape(shape).copy()
    return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        try:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        except (KeyError, IndexError, TypeError, ValueError,
                RuntimeError) as e:
            raise CheckpointCorruptError(f"malformed chunked array: {e}") \
                from e
    return {k: _unchunk(v) for k, v in tree.items()}


def decode(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` returns for these
    bytes (numpy arrays; bfloat16 leaves as torch tensors)."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.buf):
        raise CheckpointCorruptError(
            f"{len(r.buf) - r.pos} bytes after the end of the tree")
    return _unchunk(tree)


def load(path: str) -> Any:
    """:func:`decode` of a file."""
    with open(path, "rb") as f:
        return decode(f.read())


# ------------------------------------------------------------------ encode

def _head(out: bytearray, small: int, fix_max: int, fmts, n: int) -> None:
    """A length header: a fix-format byte below ``fix_max``, else the
    first of ``fmts`` ((type byte, struct format, limit)) that holds n."""
    if n < fix_max:
        out.append(small | n)
        return
    for byte, fmt, limit in fmts:
        if n <= limit:
            out.append(byte)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"too long for msgpack: {n}")


_STR = ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff), (0xdb, ">I", 0xffffffff))
_BIN = ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff), (0xc6, ">I", 0xffffffff))
_ARR = ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff))
_MAP = ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff))
_EXT = ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff), (0xc9, ">I", 0xffffffff))


def _int(out: bytearray, v: int) -> None:
    """msgpack's shortest form, as msgpack-python packs it."""
    if 0 <= v <= 0x7f or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v > 0:
        for byte, fmt, limit in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                                 (0xce, ">I", 0xffffffff),
                                 (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= limit:
                out.append(byte)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int out of msgpack's range: {v}")
    else:
        for byte, fmt, limit in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                                 (0xd2, ">i", -0x80000000),
                                 (0xd3, ">q", -0x8000000000000000)):
            if v >= limit:
                out.append(byte)
                out += struct.pack(fmt, v)
                return
        raise ValueError(f"int out of msgpack's range: {v}")


def _ndarray_payload(shape, name: str, raw: bytes) -> bytes:
    out = bytearray()
    out.append(0x93)
    _head(out, 0x90, 16, _ARR, len(shape))
    for s in shape:
        _int(out, int(s))
    _write(out, name)
    _head(out, 0, 0, _BIN, len(raw))
    out += raw
    return bytes(out)


def _write_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fix = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}.get(n)
    if fix is not None:
        out.append(fix)
    else:
        _head(out, 0, 0, _EXT, n)
    out += struct.pack(">b", code)
    out += payload


def _array_leaf(x):
    """(shape, dtype name, C-order bytes) of an array leaf."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return tuple(x.shape), "bfloat16", x.view(torch.int16).numpy() \
                .tobytes()
        x = x.numpy()
    x = np.asarray(x, order="C")   # 0-d stays 0-d
    return x.shape, x.dtype.name, x.tobytes()


def _chunk(x):
    """flax's chunked form of an oversized leaf."""
    flat = x.reshape(-1)
    itemsize = x.element_size() if isinstance(x, torch.Tensor) \
        else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    return {_CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.shape[0], size))}}


def _write(out: bytearray, x) -> None:
    if x is None:
        out.append(0xc0)
    elif isinstance(x, bool):
        out.append(0xc3 if x else 0xc2)
    elif isinstance(x, int):
        _int(out, x)
    elif isinstance(x, float):
        out.append(0xcb)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _head(out, 0xa0, 32, _STR, len(raw))
        out += raw
    elif isinstance(x, bytes):
        _head(out, 0, 0, _BIN, len(x))
        out += x
    elif isinstance(x, dict):
        _head(out, 0x80, 16, _MAP, len(x))
        for k, v in x.items():
            _write(out, str(k))
            _write(out, v)
    elif isinstance(x, (list, tuple)):
        _write(out, {str(i): v for i, v in enumerate(x)})
    elif isinstance(x, np.generic):
        _write_ext(out, EXT_NPSCALAR, _ndarray_payload(*_array_leaf(
            np.asarray(x))))
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        nbytes = (x.numel() * x.element_size() if isinstance(x, torch.Tensor)
                  else x.nbytes)
        if nbytes > MAX_CHUNK_SIZE:
            _write(out, _chunk(x))
        else:
            _write_ext(out, EXT_NDARRAY, _ndarray_payload(*_array_leaf(x)))
    else:
        raise TypeError(f"cannot write {type(x).__name__} to a .ckpt")


def encode(tree: Any) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for ``tree`` (maps
    in the tree's own key order; numpy arrays, numpy scalars and tensors
    as ndarray leaves; tuples and lists as ``{"0": ...}`` maps)."""
    out = bytearray()
    _write(out, tree)
    return bytes(out)
