"""flax.serialization's msgpack format, in pure Python and numpy.

``r2l_tpu`` writes its checkpoints with ``flax.serialization.to_bytes``
(``r2l_tpu/checkpoint.py:31-46``). The port imports neither flax nor the
``msgpack`` module, so this module encodes and decodes that format itself,
the same way on every machine. It follows flax 0.12's ``msgpack_serialize``
and ``msgpack_restore`` over ``msgpack.packb(..., use_bin_type=True,
strict_types=True)`` and ``msgpack.unpackb(..., raw=False)``:

* a state dict is maps with str keys, written in the order given, and
  leaves: None, bool, int, float (as a double), str, bytes and arrays;
* ext type 1 is an ndarray: a nested msgpack array ``[shape, dtype name,
  C-order bytes]``; ext type 3 a numpy scalar in the same form; ext type 2
  a complex number ``[real, imag]``;
* a leaf of more than ``MAX_CHUNK_SIZE`` bytes is written as
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": ..., ...}}`` of its flattened pieces, and read back whole.

``serialize`` gives the bytes that flax's ``to_bytes`` path
(``msgpack_serialize(state, in_place=True)``) gives for the same state
dict, keys in the order given; ``restore`` reads what ``msgpack_restore``
reads, with arrays as numpy views of the input (writable where the input
is a bytearray).
A ``bfloat16`` leaf, which numpy has no type for, reads as float32 (exact).
"""
from __future__ import annotations

import struct

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30        # flax: leaves above this many bytes chunk
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return struct.pack("B", n)
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0x80 <= n <= 0xFF:
        return struct.pack("BB", 0xCC, n)
    if -0x80 <= n < 0:
        return struct.pack(">Bb", 0xD0, n)
    if 0xFF < n <= 0xFFFF:
        return struct.pack(">BH", 0xCD, n)
    if -0x8000 <= n < -0x80:
        return struct.pack(">Bh", 0xD1, n)
    if 0xFFFF < n <= 0xFFFFFFFF:
        return struct.pack(">BI", 0xCE, n)
    if -0x80000000 <= n < -0x8000:
        return struct.pack(">Bi", 0xD2, n)
    if 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        return struct.pack(">BQ", 0xCF, n)
    if -0x8000000000000000 <= n < -0x80000000:
        return struct.pack(">Bq", 0xD3, n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _header(n: int, fix: int, fix_max: int, tags: tuple) -> bytes:
    """A length header: ``fix | n`` up to ``fix_max``, then the 8-bit (if
    ``tags[0]``), 16-bit and 32-bit forms."""
    if fix is not None and n <= fix_max:
        return struct.pack("B", fix | n)
    t8, t16, t32 = tags
    if t8 is not None and n <= 0xFF:
        return struct.pack("BB", t8, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", t16, n)
    if n <= 0xFFFFFFFF:
        return struct.pack(">BI", t32, n)
    raise ValueError(f"msgpack object of length {n} is too large")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _header(len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB)) + b


def _bin(b: bytes) -> list:
    return [_header(len(b), None, 0, (0xC4, 0xC5, 0xC6)), b]


def _ext(code: int, data: bytes) -> list:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = struct.pack("B", fixed[n])
    else:
        head = _header(n, None, 0, (0xC7, 0xC8, 0xC9))
    return [head, struct.pack("b", code), data]


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """The ext payload of an array: msgpack ``[shape, dtype name, bytes]``
    (flax's ``_ndarray_to_bytes``)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    out = [_header(3, 0x90, 0x0F, (None, 0xDC, 0xDD)),
           _header(arr.ndim, 0x90, 0x0F, (None, 0xDC, 0xDD))]
    out += [_int(int(d)) for d in arr.shape]
    out.append(_str(arr.dtype.name))
    out += _bin(arr.tobytes("C"))
    return b"".join(out)


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        out.append(_str(obj))
    elif type(obj) is bytes:
        out += _bin(obj)
    elif type(obj) is dict:
        out.append(_header(len(obj), 0x80, 0x0F, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        out += _ext(EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        out += _ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif type(obj) is complex:
        out += _ext(EXT_COMPLEX, b"\x92" + struct.pack(">Bd", 0xCB, obj.real)
                    + struct.pack(">Bd", 0xCB, obj.imag))
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} (a state "
                        "dict holds dicts, scalars and arrays)")


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: the flattened array in pieces of at most
    MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    pieces = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(pieces)}}


def _chunk_leaves(tree):
    if isinstance(tree, np.ndarray):
        return _chunk(tree) if tree.nbytes > MAX_CHUNK_SIZE else tree
    if type(tree) is dict:
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    return tree


def serialize_pieces(state: dict) -> list:
    """``serialize``'s bytes as a list of pieces (arrays' bytes unjoined),
    for ``writelines``."""
    out: list = []
    _pack(_chunk_leaves(state), out)
    return out


def serialize(state: dict) -> bytes:
    """The bytes flax writes for the state dict ``state`` (module doc)."""
    return b"".join(serialize_pieces(state))


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.mv = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",          # bin
        0xD9: ">B", 0xDA: ">H", 0xDB: ">I",          # str
        0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",   # array, map
        0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}          # ext
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _array(r: _Reader, n: int, raw: bool) -> list:
    return [_read(r, raw) for _ in range(n)]


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r, raw)
        out[k] = _read(r, raw)
    return out


def _read(r: _Reader, raw: bool = False):
    """The next object; ``raw`` (an ndarray's payload) keeps str as bytes
    and bin as a view of the input."""
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return _array(r, b & 0x0F, raw)
    if 0xA0 <= b <= 0xBF:
        s = r.take(b & 0x1F)
        return bytes(s) if raw else str(s, "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if b in _FIXEXT:
        code = r.unpack("b")
        return _ext_value(code, r.take(_FIXEXT[b]))
    if b not in _LEN:
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")
    n = r.unpack(_LEN[b])
    if b in (0xC4, 0xC5, 0xC6):     # bin: a view only for an array's bytes
        return r.take(n) if raw else bytes(r.take(n))
    if b in (0xD9, 0xDA, 0xDB):
        s = r.take(n)
        return bytes(s) if raw else str(s, "utf-8")
    if b in (0xDC, 0xDD):
        return _array(r, n, raw)
    if b in (0xDE, 0xDF):
        return _map(r, n, raw)
    code = r.unpack("b")
    return _ext_value(code, r.take(n))


def _ndarray(data: memoryview) -> np.ndarray:
    """flax's ``_ndarray_from_bytes``: a view of ``data``'s buffer."""
    shape, name, buf = _read(_Reader(data), raw=True)
    name = bytes(name).decode()
    if name == "bfloat16":
        # numpy has no bfloat16: widen to float32 (exact)
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape, order="C")


def _ext_value(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        re, im = _read(_Reader(data))
        return complex(re, im)
    raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk_leaves(tree):
    if type(tree) is not dict:
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk_leaves(v) for k, v in tree.items()}


def restore(data) -> dict:
    """The state dict of flax-serialized ``data`` (bytes or bytearray): what
    flax's ``msgpack_restore`` gives, chunked leaves joined."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.mv):
        raise ValueError(f"{len(r.mv) - r.pos} trailing bytes after the "
                         "msgpack object")
    return _unchunk_leaves(tree)
