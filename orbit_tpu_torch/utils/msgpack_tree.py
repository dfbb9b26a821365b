"""Flax msgpack checkpoint files without flax or msgpack (counterpart of
``flax.serialization.to_bytes``/``msgpack_restore`` as
``orbit_tpu/utils/checkpoint.py`` uses them).

A flax checkpoint is one msgpack document: a map of string keys whose
leaves are arrays. The subset read and written here is the one flax emits:

- maps, arrays (read back as lists), ints, floats, strings, byte strings,
  bools and nil;
- ext type 1, an ndarray: a nested msgpack document ``(shape, dtype name,
  C-order bytes)``; ext type 3, a numpy scalar, the same document of a
  0-d array;
- leaves above :data:`MAX_CHUNK_SIZE` bytes in flax's chunked form, a map
  ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
  "chunks": {"0": flat chunk, ...}}``.

Read arrays are numpy arrays, except ``bfloat16`` ones, which numpy cannot
hold: they become ``torch.bfloat16`` tensors through a uint16 view. The
writer takes numpy arrays and scalars, torch tensors (``bfloat16``
included), Python scalars, strings and nested dicts; like the JAX
package's ``save_checkpoint`` (a ``jax.tree_util`` map before flax
serialises) it writes every dict's keys in sorted order, and it picks the
same encodings as the msgpack packer, so its bytes equal flax's for the
same tree.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: leaves larger than this many bytes are
# written in chunks of at most this size
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ------------------------------------------------------------------ read ----
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
            0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
# type byte -> (kind, big-endian length format)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, raw: bool = False):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.value(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b not in _SIZED:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not in the subset flax writes")
        kind, fmt = _SIZED[b]
        n = self.unpack(fmt)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return self.str(n, raw)
        if kind == "array":
            return [self.value(raw) for _ in range(n)]
        if kind == "map":
            return self.map(n, raw)
        return self.ext(n)

    def str(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> Dict:
        out = {}
        for _ in range(n):
            key = self.value(raw)
            out[key] = self.value(raw)
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not in the subset flax writes")
        arr = _array_from_bytes(payload)
        return arr if code == _EXT_NDARRAY else arr[()]


def _array_from_bytes(payload: bytes):
    """flax ``_ndarray_from_bytes``: ``(shape, dtype name, bytes)``."""
    reader = _Reader(payload)
    shape, name, buf = reader.value(raw=True)
    shape = tuple(shape)
    name = name.decode("ascii")
    if name == "bfloat16":
        flat = torch.from_numpy(np.frombuffer(buf, np.uint16).copy().view(np.int16))
        return flat.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _unchunk(node: Dict):
    shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(node):
    if isinstance(node, dict):
        if CHUNKED in node:
            return _unchunk(node)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def loads(data: bytes):
    """One flax msgpack document -> nested dicts (and lists) of arrays."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack document")
    return _unchunk_tree(tree)


def load(path: str):
    with open(path, "rb") as f:
        return loads(f.read())


def is_msgpack_map(head: bytes) -> bool:
    """Whether a file starting with ``head`` holds a msgpack map (a flax
    checkpoint); a torch zip file starts with ``PK``."""
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


# ----------------------------------------------------------------- write ----
def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for lim, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"),
                               (0xFFFFFFFF, 0xCE, ">I"), (2 ** 64 - 1, 0xCF, ">Q")):
            if v <= lim:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for lim, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                               (-0x80000000, 0xD2, ">i"), (-2 ** 63, 0xD3, ">q")):
            if v >= lim:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack")


def _sized(n: int, fix: Tuple[int, int] | None, codes) -> bytes:
    """The header of a str/bin/array/map/ext of ``n`` entries or bytes."""
    if fix is not None and n < fix[1]:
        return bytes([fix[0] | n])
    for (code, fmt), lim in zip(codes, (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= lim:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} entries or bytes do not fit msgpack")


def _str(s: str) -> bytes:
    data = s.encode("utf-8")
    return _sized(len(data), (0xA0, 32), ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))) + data


def _bin(b: bytes) -> bytes:
    return _sized(len(b), None, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I"))) + b


def _ext(code: int, payload: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(payload) in fixed:
        head = bytes([fixed[len(payload)]])
    else:
        head = _sized(len(payload), None, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I")))
    return head + struct.pack(">b", code) + payload


def _array_parts(x) -> Tuple[Tuple[int, ...], str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or torch tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    arr = np.asarray(x)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialised")
    return arr.shape, arr.dtype.name, arr.tobytes("C")


def _array_doc(x) -> bytes:
    shape, name, data = _array_parts(x)
    return (_sized(3, (0x90, 16), ((None, None), (0xDC, ">H"), (0xDD, ">I")))
            + _value(list(shape)) + _str(name) + _bin(data))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunked(x) -> Dict:
    """flax ``_chunk``: the flat array in pieces of at most
    MAX_CHUNK_SIZE bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[s:s + size] for i, s in enumerate(range(0, n, size))}}


def _value(v, sort: bool = False) -> bytes:
    if v is None:
        return b"\xc0"
    if isinstance(v, bool):
        return b"\xc3" if v else b"\xc2"
    if isinstance(v, int):
        return _int(v)
    if isinstance(v, float):
        return b"\xcb" + struct.pack(">d", v)
    if isinstance(v, str):
        return _str(v)
    if isinstance(v, bytes):
        return _bin(v)
    if isinstance(v, (torch.Tensor, np.ndarray)):
        return _ext(_EXT_NDARRAY, _array_doc(v))
    if isinstance(v, np.generic):
        return _ext(_EXT_NPSCALAR, _array_doc(np.asarray(v)))
    if isinstance(v, (list, tuple)):
        return (_sized(len(v), (0x90, 16), ((None, None), (0xDC, ">H"), (0xDD, ">I")))
                + b"".join(_value(x, sort) for x in v))
    if isinstance(v, dict):
        items = sorted(v.items()) if sort else list(v.items())
        out = [_sized(len(items), (0x80, 16), ((None, None), (0xDE, ">H"), (0xDF, ">I")))]
        for key, x in items:
            if isinstance(x, (torch.Tensor, np.ndarray)) and _nbytes(x) > MAX_CHUNK_SIZE:
                x = _chunked(x)
                out.append(_str(str(key)) + _value(x, sort=False))
            else:
                out.append(_str(str(key)) + _value(x, sort))
        return b"".join(out)
    raise TypeError(f"cannot serialise {type(v).__name__} into a flax checkpoint")


def dumps(tree: Dict[str, Any]) -> bytes:
    """Nested dicts of arrays -> flax msgpack bytes (keys sorted)."""
    return _value(tree, sort=True)


def save(path: str, tree: Dict[str, Any]) -> None:
    """Write ``tree`` to ``path`` atomically (``save_checkpoint``)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(dumps(tree))
    os.replace(tmp, path)
