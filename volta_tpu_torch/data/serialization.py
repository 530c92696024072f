"""msgpack-numpy compatible (de)serialisation, in pure Python.

The reference's Conceptual Captions shards are tensorpack LMDBSerializer
environments: keys ``b"{idx:08}"`` plus ``b"__keys__"``, values msgpack
blobs with msgpack_numpy's array encoding (reference:
data/conceptual_captions/preprocess_cc_train.py:30-70,
volta/datasets/concept_cap_dataset.py:202-204).

Port of ``volta_tpu/data/serialization.py``, which calls the ``msgpack``
package. The port carries its own encoder and decoder for the subset the
CC records use, so that it needs no package beyond numpy: nil, bool, ints
of every width, float32 and float64, str, bin, arrays and maps, and the
msgpack-numpy maps ``{b"nd", b"type", b"shape", b"data"}`` (numpy arrays
and scalars). ``dumps`` writes the bytes ``msgpack.packb(obj,
default=_encode, use_bin_type=True)`` writes: every value in its smallest
format, a float as float64, str as str and bytes as bin, a tuple as an
array, a numpy float64 scalar as a float (it is a Python float). ``loads``
reads what ``msgpack.unpackb(..., raw=True)`` reads: strings and map keys
come back as bytes, arrays as lists, and an msgpack-numpy map as a
read-only numpy array (or scalar); a map key that is not a string
raises, as msgpack's ``strict_map_key`` does. Ext types and timestamps
raise.
"""

from __future__ import annotations

import struct

import numpy as np

_PACK = {fmt: struct.Struct(fmt).pack for fmt in
         (">BB", ">Bb", ">BH", ">Bh", ">BI", ">Bi", ">BQ", ">Bq", ">Bd")}


def _encode(obj):
    """msgpack-numpy's ``default`` hook: a numpy array or scalar as a map."""
    if isinstance(obj, np.ndarray):
        if obj.dtype.kind == "O":
            raise TypeError("object arrays not supported")
        return {b"nd": True, b"type": obj.dtype.str,
                b"shape": list(obj.shape), b"data": obj.tobytes()}
    if isinstance(obj, (np.bool_, np.number)):
        return {b"nd": False, b"type": obj.dtype.str,
                b"data": obj.tobytes()}
    raise TypeError(f"Cannot serialize {obj!r}")


def _int(out: bytearray, v: int):
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack("b" if v < 0 else "B", v)
    elif 0x80 <= v <= 0xFF:
        out += _PACK[">BB"](0xCC, v)
    elif -0x80 <= v < 0:
        out += _PACK[">Bb"](0xD0, v)
    elif 0xFF < v <= 0xFFFF:
        out += _PACK[">BH"](0xCD, v)
    elif -0x8000 <= v < -0x80:
        out += _PACK[">Bh"](0xD1, v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += _PACK[">BI"](0xCE, v)
    elif -0x80000000 <= v < -0x8000:
        out += _PACK[">Bi"](0xD2, v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += _PACK[">BQ"](0xCF, v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += _PACK[">Bq"](0xD3, v)
    else:
        raise OverflowError("Integer value out of range")


def _header(out: bytearray, n: int, fix: int, fix_max: int, codes):
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` (8-, 16-, 32-bit lengths; None where msgpack has none)
    whose width holds n."""
    if n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">BB", ">BH", ">BI"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out += _PACK[fmt](code, n)
            return
    raise ValueError(f"length {n} is too large")


def _pack(out: bytearray, obj, default_used: bool = False):
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _header(out, len(data), 0, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, float):
        out += _PACK[">Bd"](0xCB, obj)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif not default_used:
        _pack(out, _encode(obj), True)
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


def dumps(obj) -> bytes:
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _decode(obj):
    """msgpack-numpy's ``object_hook``: an ``nd`` map as a numpy value."""
    if b"nd" in obj:
        if obj[b"nd"]:
            shape = obj.get(b"shape", [])
            return np.frombuffer(obj[b"data"],
                                 dtype=np.dtype(obj[b"type"])).reshape(shape)
        return np.frombuffer(obj[b"data"],
                             dtype=np.dtype(obj[b"type"]))[0]
    return obj


# fixed-width formats: code -> (struct, size)
_FIXED = {0xCA: struct.Struct(">f"), 0xCB: struct.Struct(">d"),
          0xCC: struct.Struct(">B"), 0xCD: struct.Struct(">H"),
          0xCE: struct.Struct(">I"), 0xCF: struct.Struct(">Q"),
          0xD0: struct.Struct(">b"), 0xD1: struct.Struct(">h"),
          0xD2: struct.Struct(">i"), 0xD3: struct.Struct(">q")}
_LEN = {1: struct.Struct(">B"), 2: struct.Struct(">H"),
        4: struct.Struct(">I")}
# code -> (kind, width of the length)
_SIZED = {0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xDC: ("array", 2), 0xDD: ("array", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4)}


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end].tobytes()
        self.pos = end
        return out

    def value(self):
        if self.pos >= len(self.buf):
            raise ValueError("truncated msgpack data")
        c = self.buf[self.pos]
        self.pos += 1
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in _FIXED:
            fmt = _FIXED[c]
            return fmt.unpack(self.take(fmt.size))[0]
        if c in _SIZED:
            kind, width = _SIZED[c]
            n = _LEN[width].unpack(self.take(width))[0]
            if kind in ("bin", "str"):
                return self.take(n)
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, bytes):
                # msgpack's strict_map_key: str and bin keys only
                raise ValueError(f"{type(k).__name__} is not allowed for "
                                 "map key")
            out[k] = self.value()
        return _decode(out)


def loads(buf: bytes):
    reader = _Reader(buf)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("extra data after the msgpack value")
    return out


def tensorpack_key(idx: int) -> bytes:
    return "{:08}".format(idx).encode("ascii")
