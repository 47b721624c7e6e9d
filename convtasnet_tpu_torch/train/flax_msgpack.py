"""A msgpack decoder for the subset that ``flax.serialization`` writes.

The JAX package's ``.ckpt`` payload is ``flax.serialization.
msgpack_serialize`` of a nested dict of arrays. The machine with the card
has neither flax nor msgpack, so this module decodes that payload itself:

- maps, arrays, str and bin, ints, floats, bool and nil (the msgpack
  spec's formats, big-endian);
- ext 1 (ndarray): a nested msgpack array ``(shape, dtype name,
  C-order bytes)``, as ``flax.serialization._ndarray_to_bytes`` packs it;
  the outer stream decodes str as utf-8 (``raw=False``) and the inner one
  keeps the dtype name as bytes (``raw=True``), as flax reads them;
- ext 3 (numpy scalar): the same inner encoding, returned 0-d;
- ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``
  maps, which flax writes for arrays above its chunk size, joined back
  into one array.

Arrays come back as read-only numpy arrays, but a
``bfloat16`` array, which numpy has no dtype for: it is read as uint16 and
viewed as a ``torch.bfloat16`` tensor. An unknown format byte or ext code,
a truncated stream, a length past the end or trailing bytes raise
``ValueError`` naming the offset; nothing is skipped.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """One msgpack stream; ``raw`` keeps str as bytes."""

    def __init__(self, data: bytes, raw: bool, base: int = 0):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.base = base   # offset of this stream in the outer payload

    def _take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(
                f"msgpack stream truncated at offset {self.base + self.pos}: "
                f"{n} bytes wanted, {len(self.data) - self.pos} left")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def _unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, n: int, at: int):
        code = self._unpack(">b")
        start = self.base + self.pos
        payload = self._take(n)
        if code == EXT_NDARRAY:
            return _ndarray(payload, start)
        if code == EXT_NPSCALAR:
            return _ndarray(payload, start)[()]
        raise ValueError(f"unknown msgpack ext code {code} at offset {at}")

    def read(self) -> Any:
        at = self.base + self.pos
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
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self._take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(n, at)
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self._ext(1 << (b - 0xD4), at)
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self._unpack(ints[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._unpack({0xD9: ">B", 0xDA: ">H",
                                           0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"invalid msgpack format byte 0x{b:02x} at offset "
                         f"{at}")


def _ndarray(payload: memoryview, at: int):
    """flax's inner ``(shape, dtype name, bytes)`` -> numpy array (a torch
    bfloat16 tensor for ``bfloat16``)."""
    inner = _Reader(payload, raw=True, base=at)
    tpl = inner.read()
    if inner.pos != len(payload):
        raise ValueError(f"ndarray ext at offset {at}: "
                         f"{len(payload) - inner.pos} trailing bytes")
    if (not isinstance(tpl, list) or len(tpl) != 3
            or not isinstance(tpl[0], list)
            or not isinstance(tpl[1], bytes)
            or not isinstance(tpl[2], bytes)):
        raise ValueError(f"ndarray ext at offset {at} is not (shape, dtype "
                         f"name, bytes)")
    shape, name, buf = tuple(tpl[0]), tpl[1].decode("ascii"), tpl[2]
    bf16 = name == "bfloat16"
    try:
        dtype = np.dtype(np.uint16 if bf16 else name)
    except TypeError as e:
        raise ValueError(f"ndarray ext at offset {at}: unknown dtype "
                         f"{name!r}") from e
    if dtype.hasobject or len(buf) != int(np.prod(shape)) * dtype.itemsize:
        raise ValueError(f"ndarray ext at offset {at}: {len(buf)} bytes for "
                         f"shape {shape} of {name}")
    arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
    if bf16:
        import torch

        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return arr


def _unchunk(tree: Any) -> Any:
    """Join flax's chunked-array maps back into arrays, anywhere in
    ``tree``."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if chunks and not all(isinstance(c, np.ndarray) for c in chunks):
            import torch

            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(payload: bytes, base: int = 0) -> Any:
    """Decode a ``flax.serialization.msgpack_serialize`` payload into
    nested dicts of arrays and Python scalars. ``base`` is the payload's
    offset in its file, for the offsets errors name."""
    reader = _Reader(payload, raw=False, base=base)
    tree = reader.read()
    if reader.pos != len(payload):
        raise ValueError(f"msgpack payload has {len(payload) - reader.pos} "
                         f"trailing bytes at offset {base + reader.pos}")
    return _unchunk(tree)

