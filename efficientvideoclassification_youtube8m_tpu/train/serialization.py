"""msgpack checkpoint codec.

Writes the same bytes as `flax.serialization.to_bytes` for the trees this
repo checkpoints, and reads what that wrote, without flax or the msgpack
package (the repo hand-writes its proto and TF-bundle codecs the same
way). The format, as flax defines it:

  * a state dataclass becomes a map of its fields in declaration order;
    a NamedTuple a map of its fields; a list or tuple a map "0", "1", ...;
    a dict a map with its keys as strings, in insertion order;
  * an array (numpy or jax) is msgpack ext type 1 whose payload is the
    msgpack array (shape, dtype name, C-order bytes); a numpy scalar is
    ext type 3 with the same payload;
  * an array above 2**30 bytes is split into a map
    {"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}
    of flat pieces;
  * None, bool, int, float, str and bytes are plain msgpack values.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _is_array(x) -> bool:
    import jax

    return isinstance(x, (np.ndarray, jax.Array))


# --- pytree <-> state dict -------------------------------------------------

def to_state_dict(x) -> Any:
    """Nested dicts of the tree's leaves (flax's state-dict layout)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: to_state_dict(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if _is_namedtuple(x):
        return {k: to_state_dict(getattr(x, k)) for k in x._fields}
    if isinstance(x, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(x)}
    if isinstance(x, dict):
        if len({str(k) for k in x}) != len(x):
            raise ValueError(f"dict keys are not unique as strings: {list(x)}")
        return {str(k): to_state_dict(v) for k, v in x.items()}
    return x


def from_state_dict(target, state) -> Any:
    """Rebuild `target`'s structure from a state dict; leaves come from
    `state`. Raises ValueError where the two trees' keys differ."""
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        names = [f.name for f in dataclasses.fields(target)]
        missing = [n for n in names if n not in state]
        extra = [k for k in state if k not in names]
        if missing or extra:
            raise ValueError(
                f"{type(target).__name__} fields {names} do not match the "
                f"state dict (missing {missing}, unknown {extra})")
        return dataclasses.replace(target, **{
            n: from_state_dict(getattr(target, n), state[n]) for n in names})
    if _is_namedtuple(target):
        if set(state) != set(target._fields):
            raise ValueError(
                f"named tuple fields {target._fields} do not match the "
                f"state dict keys {sorted(state)}")
        return type(target)(**{
            k: from_state_dict(getattr(target, k), state[k])
            for k in target._fields})
    if isinstance(target, (list, tuple)):
        if len(state) != len(target):
            raise ValueError(
                f"sequence of {len(target)} entries restored from a state "
                f"dict of {len(state)}")
        items = [from_state_dict(v, state[str(i)])
                 for i, v in enumerate(target)]
        return items if isinstance(target, list) else tuple(items)
    if isinstance(target, dict):
        missing = {str(k) for k in target} - set(state)
        if missing:
            raise ValueError(
                f"state dict lacks the target's keys {sorted(missing)}")
        return {k: from_state_dict(v, state[str(k)])
                for k, v in target.items()}
    return state


# --- msgpack encoding --------------------------------------------------------

def _pack_uint(out: bytearray, n: int) -> None:
    if n < 0x80:
        out.append(n)
    elif n < 0x100:
        out += b"\xcc" + struct.pack(">B", n)
    elif n < 0x10000:
        out += b"\xcd" + struct.pack(">H", n)
    elif n < 0x100000000:
        out += b"\xce" + struct.pack(">I", n)
    else:
        out += b"\xcf" + struct.pack(">Q", n)


def _pack_int(out: bytearray, n: int) -> None:
    if n >= 0:
        _pack_uint(out, n)
    elif n >= -32:
        out += struct.pack(">b", n)
    elif n >= -(1 << 7):
        out += b"\xd0" + struct.pack(">b", n)
    elif n >= -(1 << 15):
        out += b"\xd1" + struct.pack(">h", n)
    elif n >= -(1 << 31):
        out += b"\xd2" + struct.pack(">i", n)
    else:
        out += b"\xd3" + struct.pack(">q", n)


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int,
              codes: bytes) -> None:
    """Length header: fixed form below `fix_max`, else 8/16/32-bit
    (codes holds the 8-, 16- and 32-bit type bytes; 0 = no 8-bit form)."""
    if n < fix_max:
        out.append(fix | n)
    elif codes[0] and n < 0x100:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n < 0x10000:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack_bin(out: bytearray, b: bytes) -> None:
    n = len(b)
    if n < 0x100:
        out += b"\xc4" + struct.pack(">B", n)
    elif n < 0x10000:
        out += b"\xc5" + struct.pack(">H", n)
    else:
        out += b"\xc6" + struct.pack(">I", n)
    out += b


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += bytes([fixed[n], code])
    elif n < 0x100:
        out += bytes([0xC7, n, code])
    elif n < 0x10000:
        out += b"\xc8" + struct.pack(">H", n) + bytes([code])
    else:
        out += b"\xc9" + struct.pack(">I", n) + bytes([code])
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out += b"\xcb" + struct.pack(">d", x)
    elif type(x) in (bytes, bytearray):
        _pack_bin(out, bytes(x))
    elif type(x) is str:
        b = x.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 32, b"\xd9\xda\xdb")
        out += b
    elif type(x) is dict:
        _pack_len(out, len(x), 0x80, 16, b"\x00\xde\xdf")
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif type(x) is list:
        _pack_len(out, len(x), 0x90, 16, b"\x00\xdc\xdd")
        for v in x:
            _pack(out, v)
    elif _is_array(x):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(np.asarray(x)))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__!r} object")


def _chunk_large_arrays(x):
    if isinstance(x, dict):
        return {k: _chunk_large_arrays(v) for k, v in x.items()}
    if _is_array(x):
        arr = np.asarray(x)
        if arr.size * arr.dtype.itemsize > MAX_CHUNK_SIZE:
            step = max(1, MAX_CHUNK_SIZE // arr.dtype.itemsize)
            flat = arr.reshape(-1)
            return {
                _CHUNKED: True,
                "shape": {str(i): d for i, d in enumerate(arr.shape)},
                "chunks": {str(i): flat[s:s + step] for i, s in
                           enumerate(range(0, flat.size, step))},
            }
    return x


def msgpack_serialize(tree) -> bytes:
    """A tree of dicts and leaves (a state dict) -> msgpack bytes."""
    out = bytearray()
    _pack(out, _chunk_large_arrays(tree))
    return bytes(out)


def to_bytes(target) -> bytes:
    return msgpack_serialize(to_state_dict(target))


# --- msgpack decoding --------------------------------------------------------

def _dtype_from_name(name: str):
    if name == "bfloat16":
        import jax.numpy as jnp

        return np.dtype(jnp.bfloat16)
    return np.dtype(name)


def _ndarray_from_payload(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = _Unpacker(data).value()
    return np.frombuffer(buf, dtype=_dtype_from_name(dtype_name)).reshape(
        shape, order="C")


class _Unpacker:
    """Reads one msgpack value from `data` (the whole spec bar
    timestamps: ext types other than 1 and 3 are refused)."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _ext(self, code: int, n: int):
        data = bytes(self._take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_payload(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_payload(data)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def value(self):
        b = self._take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if 0xD4 <= b <= 0xD8:
            code = self._unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", lambda n: bytes(self._take(n))),
            0xC5: (">H", lambda n: bytes(self._take(n))),
            0xC6: (">I", lambda n: bytes(self._take(n))),
            0xD9: (">B", self._str), 0xDA: (">H", self._str),
            0xDB: (">I", self._str),
            0xDC: (">H", self._array), 0xDD: (">I", self._array),
            0xDE: (">H", self._map), 0xDF: (">I", self._map),
        }
        if b in sized:
            fmt, read = sized[b]
            return read(self._unpack(fmt))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(self._unpack(">b"), n)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self._unpack(scalars[b])
        raise ValueError(f"invalid msgpack type byte 0x{b:02x}")


def _unchunk(x):
    if isinstance(x, dict):
        if _CHUNKED in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in x.items()}
    return x


def msgpack_restore(data: bytes):
    """msgpack bytes -> the tree of dicts and numpy leaves they hold."""
    unpacker = _Unpacker(data)
    tree = unpacker.value()
    if unpacker.pos != len(unpacker.data):
        raise ValueError("trailing bytes after the msgpack value")
    return _unchunk(tree)


def from_bytes(target, data: bytes):
    return from_state_dict(target, msgpack_restore(data))
