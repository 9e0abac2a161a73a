"""The msgpack of flax checkpoints, read and written without msgpack or flax.

The JAX package saves parameter trees with `flax.serialization.to_bytes`
(`espnet_tpu/train/checkpoint.py` `save_pytree`). For a nested dict of numpy
arrays that is `msgpack.packb(tree, default=..., strict_types=True)` where
each array leaf is an ext value: type 1 (`_MsgpackExtType.ndarray`) for an
ndarray and type 3 (`npscalar`) for a numpy scalar, its data the msgpack of
the tuple (shape, dtype name, C-order bytes). Leaves above flax's
`MAX_CHUNK_SIZE` bytes are written by flax as chunked-array maps.

`to_bytes` writes the same bytes as flax for a tree given in the same key
order, and raises for a leaf above `MAX_CHUNK_SIZE` instead of chunking it.
`restore` reads what flax writes, chunked arrays included, into nested dicts
of numpy arrays. A `bfloat16` array (numpy has no such dtype) comes back as
float32, its values unchanged.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"


# --- writer -----------------------------------------------------------------

def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0x80 <= v <= 0xFF:
        out += b"\xcc" + struct.pack(">B", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack(">b", v)
    elif 0xFF < v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif -0x8000 <= v < -0x80:
        out += b"\xd1" + struct.pack(">h", v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif -0x80000000 <= v < -0x8000:
        out += b"\xd2" + struct.pack(">i", v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack_str(s: str, out: bytearray) -> None:
    raw = s.encode("utf-8")
    n = len(raw)
    if n < 32:
        out.append(0xA0 | n)
    elif n <= 0xFF:
        out += b"\xd9" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += b"\xda" + struct.pack(">H", n)
    else:
        out += b"\xdb" + struct.pack(">I", n)
    out += raw


def _pack_bin(b: bytes, out: bytearray) -> None:
    n = len(b)
    if n <= 0xFF:
        out += b"\xc4" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += b"\xc5" + struct.pack(">H", n)
    else:
        out += b"\xc6" + struct.pack(">I", n)
    out += b


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += struct.pack(">Bb", fixed[n], code)
    elif n <= 0xFF:
        out += struct.pack(">BBb", 0xC7, n, code)
    elif n <= 0xFFFF:
        out += struct.pack(">BHb", 0xC8, n, code)
    else:
        out += struct.pack(">BIb", 0xC9, n, code)
    out += data


def _pack_header(n: int, small: int, h16: int, h32: int,
                 out: bytearray) -> None:
    if n < 16:
        out.append(small | n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", h16, n)
    else:
        out += struct.pack(">BI", h32, n)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax `_ndarray_to_bytes`: the msgpack of (shape, dtype name, bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialisable")
    out = bytearray()
    _pack(tuple(int(d) for d in arr.shape), out)
    _pack_str(arr.dtype.name, out)
    _pack_bin(arr.tobytes("C"), out)
    return bytes(b"\x93" + out)


def _pack(obj: Any, out: bytearray) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif t is str:
        _pack_str(obj, out)
    elif t in (list, tuple):
        _pack_header(len(obj), 0x90, 0xDC, 0xDD, out)
        for item in obj:
            _pack(item, out)
    elif t is dict:
        _pack_header(len(obj), 0x80, 0xDE, 0xDF, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            raise ValueError(
                f"array of {obj.size * obj.dtype.itemsize} bytes exceeds "
                f"MAX_CHUNK_SIZE ({MAX_CHUNK_SIZE}); flax would chunk it, "
                "which this writer does not")
        _pack_ext(EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot serialise {t.__name__}")


def to_bytes(tree: Dict[str, Any]) -> bytes:
    """flax's `serialization.to_bytes` of a nested dict (str keys) of numpy
    arrays and scalars, ints, floats, bools, None and str."""
    out = bytearray()
    _pack(_str_keys(tree), out)
    return bytes(out)


def _str_keys(tree):
    """flax's state dict of a dict: every key as str (flax refuses keys
    whose str forms collide)."""
    if isinstance(tree, dict):
        keys = [str(k) for k in tree]
        if len(set(keys)) != len(keys):
            raise ValueError(f"dict keys collide as strings: {keys}")
        return {str(k): _str_keys(v) for k, v in tree.items()}
    return tree


# --- reader -----------------------------------------------------------------

class _Unpacker:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def _unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n: int):
        raw = bytes(self._take(n))
        return raw if self.raw else raw.decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        return _ext_value(code, bytes(self._take(n)))

    def value(self) -> Any:
        b = self._unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(self._take(self._unpack(sized[b])))
        if b in (0xC7, 0xC8, 0xC9):
            return self._ext(self._unpack({0xC7: ">B", 0xC8: ">H",
                                           0xC9: ">I"}[b]))
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self._unpack(ints[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._unpack({0xD9: ">B", 0xDA: ">H",
                                           0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")


def _unpackb(data: bytes, raw: bool = False) -> Any:
    unpacker = _Unpacker(data, raw)
    value = unpacker.value()
    if unpacker.pos != len(data):
        raise ValueError("extra bytes after the msgpack value")
    return value


def _bfloat16_to_float32(buffer: bytes) -> np.ndarray:
    bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
    return bits.view(np.float32)


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, name, buffer = _unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        return _bfloat16_to_float32(buffer).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _ext_value(code: int, data: bytes) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data: bytes) -> Any:
    """flax's `serialization.msgpack_restore`: the nested dict of numpy
    arrays (and plain values) in `data`, chunked arrays joined."""
    return _unchunk(_unpackb(data))


def save_tree(path, tree: Dict[str, Any]) -> None:
    """Write `tree` as flax msgpack (the JAX package's `save_pytree`)."""
    from pathlib import Path

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(to_bytes(tree))


def load_tree(path) -> Any:
    """Read a flax msgpack file into nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return restore(f.read())


def flatten(tree: Dict[str, Any], sep: str = "/",
            prefix: str = "") -> Dict[str, Any]:
    """{"a": {"b": x}} -> {"a/b": x} (flax's `traverse_util.flatten_dict`
    with `sep`)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        path = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, dict) and v:
            out.update(flatten(v, sep, path))
        else:
            out[path] = v
    return out


def unflatten(flat: Dict[str, Any], sep: str = "/") -> Dict[str, Any]:
    """The inverse of `flatten`."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        cur = out
        parts = path.split(sep)
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out

