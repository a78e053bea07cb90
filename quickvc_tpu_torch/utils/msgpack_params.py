"""Read and write the JAX package's ``.msgpack`` parameter files, in pure Python.

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

:func:`packb` and :func:`save_params` write what ``flax.serialization.to_bytes``
writes for the same tree, byte for byte: lists and tuples become maps keyed
"0", "1", ...; every map's keys are strings, in the tree's own order
(``to_bytes`` serializes its state dict in place); an ndarray leaf above
:data:`MAX_CHUNK_SIZE` bytes becomes a ``__msgpack_chunked_array__`` map of
flat chunks; ndarrays are ext type 1 and numpy scalars ext type 3, each
holding the msgpack triple (shape, dtype name, C-order bytes); ints, floats,
strings and bytes take the encodings ``msgpack.packb(..., use_bin_type=True)``
picks (the smallest that holds an int, float64 for a float). The JAX
package's ``scripts/export_params.py`` writes trees that went through
``jax.device_get``, a JAX ``tree_map``, which leaves every dict's keys
sorted: :func:`sorted_tree` puts a tree in that order.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY, EXT_NPSCALAR = 1, 3          # flax.serialization._MsgpackExtType
CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30                  # flax.serialization.MAX_CHUNK_SIZE
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


# --------------------------------------------------------------------------
# the writer


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes((v,))
    if -0x20 <= v < 0:
        return bytes((v + 0x100,))
    for lo, hi, code, fmt in ((0, 0xFF, 0xCC, ">B"), (-0x80, -1, 0xD0, ">b"),
                              (0, 0xFFFF, 0xCD, ">H"), (-0x8000, -1, 0xD1, ">h"),
                              (0, 0xFFFFFFFF, 0xCE, ">I"), (-0x80000000, -1, 0xD2, ">i"),
                              (0, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
                              (-0x8000000000000000, -1, 0xD3, ">q")):
        if lo <= v <= hi:
            return bytes((code,)) + struct.pack(fmt, v)
    raise OverflowError(f"{v} does not fit msgpack's 64-bit integers")


def _header(n: int, fix: int | None, fix_max: int, wide: tuple) -> bytes:
    """A length header: the fix form below ``fix_max``, else the first of
    ``wide`` ((code, struct format, largest length), ...) that holds ``n``."""
    if fix is not None and n < fix_max:
        return bytes((fix | n,))
    for code, fmt, top in wide:
        if n <= top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"a msgpack object of length {n} is too long")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARRAY = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_FIXEXT_CODE = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    if n in _FIXEXT_CODE:
        head = bytes((_FIXEXT_CODE[n],))
    else:
        head = _header(n, None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                                    (0xC9, ">I", 0xFFFFFFFF)))
    return head + struct.pack(">b", code) + payload


def _triple(arr: np.ndarray) -> bytes:
    """flax's ndarray payload: the msgpack array (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no flax encoding")
    out = [b"\x93", _header(len(arr.shape), 0x90, 16, _ARRAY)]
    out += [_int(int(d)) for d in arr.shape]
    out += [_plain(arr.dtype.name), _plain(arr.tobytes("C"))]
    return b"".join(out)


def _plain(x) -> bytes:
    """A scalar of msgpack's own types."""
    if x is None:
        return b"\xc0"
    if x is True or x is False:
        return b"\xc3" if x else b"\xc2"
    if type(x) is int:
        return _int(x)
    if type(x) is float:
        return b"\xcb" + struct.pack(">d", x)
    if type(x) is str:
        data = x.encode("utf-8")
        return _header(len(data), 0xA0, 32, _STR) + data
    if type(x) in (bytes, bytearray, memoryview):
        data = bytes(x)
        return _header(len(data), None, 0, _BIN) + data
    raise TypeError(f"{type(x).__name__} has no msgpack encoding in a flax tree")


def _state_dict(x):
    """flax's ``to_state_dict``: maps with string keys, lists and tuples as
    maps keyed by index."""
    if isinstance(x, (list, tuple)):
        x = {str(i): v for i, v in enumerate(x)}
    if isinstance(x, dict):
        keys = {str(k): v for k, v in x.items()}
        if len(keys) != len(x):
            raise ValueError(f"dict keys without a unique string form: {list(x)}")
        return {k: _state_dict(v) for k, v in keys.items()}
    return x


def _chunked(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: the array as flat chunks of at most MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j : j + size]
                       for i, j in enumerate(range(0, flat.size, size))}}


def _pack(x, out: list) -> None:
    if isinstance(x, dict):
        out.append(_header(len(x), 0x80, 16, _MAP))
        for k, v in x.items():
            out.append(_plain(k))
            if isinstance(v, np.ndarray) and v.size * v.dtype.itemsize > MAX_CHUNK_SIZE:
                v = _chunked(v)
            _pack(v, out)
    elif isinstance(x, np.ndarray):
        out.append(_ext(EXT_NDARRAY, _triple(x)))
    elif isinstance(x, np.generic):
        out.append(_ext(EXT_NPSCALAR, _triple(np.asarray(x))))
    else:
        out.append(_plain(x))


def packb(tree) -> bytes:
    """``flax.serialization.to_bytes(tree)`` for a tree of dicts, lists and
    tuples whose leaves are numpy arrays, numpy scalars and msgpack's own
    scalars (None, bool, int, float, str, bytes)."""
    tree = _state_dict(tree)
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        tree = _chunked(tree)
    out: list = []
    _pack(tree, out)
    return b"".join(out)


def sorted_tree(tree):
    """``tree`` with every dict's keys sorted, the order a JAX ``tree_map``
    (``jax.device_get``) leaves them in."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def save_params(path: str, tree) -> None:
    """Write ``tree`` (a parameter tree of numpy arrays) as flax writes it."""
    with open(path, "wb") as f:
        f.write(packb(tree))
