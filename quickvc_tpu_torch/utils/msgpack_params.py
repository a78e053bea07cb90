"""Read the JAX package's ``.msgpack`` parameter files, in pure Python.

``scripts/export_params.py`` writes the generator's (and HuBERT's) flax
parameters with ``flax.serialization.to_bytes``: a msgpack map of maps whose
leaves are msgpack ext values. This module decodes the subset of msgpack
that such a file uses, with no ``msgpack`` or ``flax`` package:

- nil, bool, int, float, str, bin, array and map (string keys);
- ext type 1, an ndarray: the msgpack triple (shape, dtype name, C-order
  buffer);
- ext type 3, a numpy scalar: the same triple with shape ();
- a map holding ``__msgpack_chunked_array__`` (flax splits a leaf above
  2**30 bytes into flat chunks): the chunks joined and reshaped.

Any other ext type, and any dtype outside :data:`DTYPES`, raise
:class:`MsgpackFormatError` naming it. ``bfloat16`` leaves are widened to
float32 (exact). Tuples and lists that flax stored as ``{"0": ..., "1": ...}``
maps stay maps: the weight mappings of :mod:`quickvc_tpu_torch.utils.weights`
read the trees by key. :func:`load_params` gives the tree of numpy arrays
that ``utils/weights.py:generator_state_dict_from_jax`` and
``hubert_state_dict_from_jax`` take.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3          # flax.serialization._MsgpackExtType
CHUNKED = "__msgpack_chunked_array__"
DTYPES = frozenset({"float16", "float32", "float64", "bfloat16", "bool", "int8", "int16",
                    "int32", "int64", "uint8", "uint16", "uint32", "uint64"})


class MsgpackFormatError(ValueError):
    """The bytes are not a msgpack value of the kind flax writes."""


_FIXED = {  # type byte -> struct format of a big-endian scalar
    0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTH = {  # type byte -> (kind, struct format of its length)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"), 0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackFormatError(f"truncated: {n} bytes wanted at offset {self.pos}")
        out = self.buf[self.pos : end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _LENGTH:
            kind, fmt = _LENGTH[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.str(n)
            if kind == "ext":
                return self.ext(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.map(n)
        raise MsgpackFormatError(f"type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise MsgpackFormatError(f"msgpack ext type {code}: flax parameter files hold "
                                     f"ndarrays ({EXT_NDARRAY}) and numpy scalars "
                                     f"({EXT_NPSCALAR}) only")
        arr = _ndarray(payload)
        return arr if code == EXT_NDARRAY else arr[()]


def _ndarray(payload: memoryview) -> np.ndarray:
    """flax's ndarray triple (shape, dtype name, C-order bytes) -> a writable array."""
    triple = _Reader(payload).value()
    if not (isinstance(triple, list) and len(triple) == 3):
        raise MsgpackFormatError("an ndarray ext value is not a (shape, dtype, bytes) triple")
    shape, name, buf = triple
    if isinstance(name, bytes):
        name = name.decode()
    if name not in DTYPES:
        raise MsgpackFormatError(f"dtype {name!r} is not one of {sorted(DTYPES)}")
    if name == "bfloat16":   # numpy has no bf16: its bits are a float32's high half
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _unchunk(tree):
    """Join flax's chunked leaves back into arrays, everywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes):
    """Decode one msgpack value (the subset above); arrays come back as lists,
    maps as dicts, chunked leaves joined."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise MsgpackFormatError(f"{len(reader.buf) - reader.pos} bytes after the value")
    return _unchunk(out)


def load_params(path: str) -> dict:
    """The parameter tree of a file written by ``flax.serialization.to_bytes``."""
    with open(path, "rb") as f:
        tree = unpackb(f.read())
    if not isinstance(tree, dict):
        raise MsgpackFormatError(f"{path}: the top value is a {type(tree).__name__}, "
                                 "not a parameter map")
    return tree
