"""flax's msgpack checkpoint format over the standard library and numpy.

Counterpart of `flax.serialization.to_bytes` / `from_bytes` as the JAX
package writes and reads `lm`, `flow`, `hift`, `speech_tokenizer` and
`campplus.msgpack`. A file is one msgpack map: str keys, nested maps, and
leaves that are msgpack natives (nil, bool, int, float, str, bin) or ext
types:

- 1, an ndarray: its payload is msgpack `[shape, dtype name, C-order bytes]`;
- 3, a numpy scalar: the same payload for a 0-d array;
- 2, a complex number, is not read (raises).

flax stores lists as maps keyed "0", "1", ... and splits an array of more
than MAX_CHUNK_SIZE bytes into flat chunks under
`{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}`.

`read` parses a memoryview of the file: each array is an `np.frombuffer`
view of the file's buffer, so reading makes no per-byte Python loop and no
second copy (a chunked array is concatenated once). numpy has no bfloat16:
such an array is read with the structured dtype BFLOAT16 (one uint16 field
named "bfloat16"), which `to_torch` views as torch.bfloat16 and the writer
writes back as "bfloat16". `write` streams a tree to a file, each array's
bytes straight from its buffer, in flax's encoding: the bytes equal
`flax.serialization.to_bytes` of the same tree.
"""

import struct
from typing import Any

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE: larger arrays are written in chunks
BFLOAT16 = np.dtype([("bfloat16", "<u2")])
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3  # flax's ext codes (2, a complex number, is not read)


# ---------------------------------------------------------------- reading


class _Reader:
    """Recursive descent over `buf`; a bin is returned as bytes, or as a
    view of `buf` where `views` (an array's buffer)."""

    def __init__(self, buf: memoryview, views: bool = False):
        self.buf = buf
        self.pos = 0
        self.views = views

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (need {n} more of {len(self.buf)})")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        (val,) = struct.unpack_from(fmt, self._take(size))
        return val

    def value(self):
        b = self._take(1)[0]
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
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self._unpack(fixed[b])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",
                 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in sized:
            n = self._unpack(sized[b])
            if b <= 0xC6:
                return self._take(n) if self.views else bytes(self._take(n))
            if b <= 0xC9:
                return self._ext(n)
            if b <= 0xDB:
                return self._str(n)
            return self._array(n) if b <= 0xDD else self._map(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self._ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at {self.pos - 1}")

    def _str(self, n: int) -> str:
        return str(self._take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        payload = self._take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"msgpack: ext type {code} is not read (1 ndarray and 3 numpy scalar are)")


def _dtype(name: str) -> np.dtype:
    return BFLOAT16 if name == "bfloat16" else np.dtype(name)


def _ndarray(payload: memoryview) -> np.ndarray:
    """An ext 1 payload, msgpack [shape, dtype name, bytes], as a view of
    the buffer."""
    shape, name, data = _Reader(payload, views=True).value()
    return np.frombuffer(data, dtype=_dtype(name)).reshape(shape)


def _unchunk(node):
    if isinstance(node, dict):
        if node.get(_CHUNKED) is True:
            shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
            chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    return node


def loads(data) -> Any:
    """The tree in `data` (bytes, bytearray or memoryview): nested dicts of
    numpy arrays (views of `data`) and msgpack natives."""
    r = _Reader(memoryview(data))
    tree = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes after the tree")
    return _unchunk(tree)


def read(path: str) -> Any:
    """`loads` of a file, read once into a writable buffer that the arrays
    view."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        buf = bytearray(f.tell())
        f.seek(0)
        if f.readinto(buf) != len(buf):
            raise IOError(f"{path}: short read")
    return loads(buf)


def to_torch(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over `arr` (BFLOAT16 as torch.bfloat16); a copy only
    where the buffer is not aligned for the dtype or not writable (bytes)."""
    arr = np.require(arr, requirements=("A", "W"))
    if arr.dtype == BFLOAT16:
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# ---------------------------------------------------------------- writing


def _uint(n: int, small: int, codes) -> bytes:
    """Header of a str / bin / array / map / ext of length n: the fixed
    form below `small` (None: none), else the 8/16/32-bit length form."""
    fix, c8, c16, c32 = codes
    if fix is not None and n < small:
        return bytes([fix | n])
    if c8 is not None and n < 1 << 8:
        return bytes([c8, n])
    if n < 1 << 16:
        return bytes([c16]) + struct.pack(">H", n)
    if n < 1 << 32:
        return bytes([c32]) + struct.pack(">I", n)
    raise ValueError(f"msgpack: length {n} does not fit in 32 bits")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _uint(len(b), 32, (0xA0, 0xD9, 0xDA, 0xDB)) + b


def _bin_header(n: int) -> bytes:
    return _uint(n, 0, (None, 0xC4, 0xC5, 0xC6))


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32),
                               (0xCF, ">Q", 1 << 64)):
            if v < lim:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15), (0xD2, ">i", 1 << 31),
                               (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"msgpack: int {v} out of range")


def _ext_header(n: int, code: int) -> bytes:
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixext[n]]) if n in fixext else _uint(n, 0, (None, 0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _array_parts(arr: np.ndarray, code: int):
    """The bytes of an ext `code` for `arr`: header pieces, then the array's
    buffer (C order)."""
    arr = np.require(arr, requirements="C")  # keeps a 0-d array 0-d
    if arr.dtype.hasobject or (arr.dtype.names is not None and arr.dtype != BFLOAT16):
        raise ValueError(f"msgpack: dtype {arr.dtype} is not written")
    name = "bfloat16" if arr.dtype == BFLOAT16 else arr.dtype.name
    shape = _uint(arr.ndim, 16, (0x90, None, 0xDC, 0xDD)) + b"".join(_int(int(d)) for d in arr.shape)
    inner = b"\x93" + shape + _str(name) + _bin_header(arr.nbytes)
    return [_ext_header(len(inner) + arr.nbytes, code), inner, memoryview(arr.reshape(-1).view(np.uint8))]


def _chunk(arr: np.ndarray) -> dict:
    n = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = np.ascontiguousarray(arr).reshape(-1)
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[j : j + n] for i, j in enumerate(range(0, flat.size, n))}}


def _parts(node, out: list):
    """Append the encoding of `node` to `out`, as flax's to_bytes encodes
    its state dict: lists and tuples as maps keyed by index, arrays over
    MAX_CHUNK_SIZE bytes in chunks."""
    if isinstance(node, (list, tuple)):
        node = {str(i): v for i, v in enumerate(node)}
    if isinstance(node, dict):
        keys = {str(k) for k in node}
        if len(keys) != len(node):
            raise ValueError(f"msgpack: dict keys without a unique str form: {list(node)}")
        out.append(_uint(len(node), 16, (0x80, None, 0xDE, 0xDF)))
        for k, v in node.items():
            out.append(_str(str(k)))
            _parts(v, out)
    elif isinstance(node, np.ndarray):
        if node.size * node.dtype.itemsize > MAX_CHUNK_SIZE:
            _parts(_chunk(node), out)
        else:
            out.extend(_array_parts(node, _EXT_NDARRAY))
    elif isinstance(node, np.generic):
        out.extend(_array_parts(np.asarray(node), _EXT_NPSCALAR))
    elif node is None:
        out.append(b"\xc0")
    elif isinstance(node, bool):
        out.append(b"\xc3" if node else b"\xc2")
    elif isinstance(node, int):
        out.append(_int(node))
    elif isinstance(node, float):
        out.append(b"\xcb" + struct.pack(">d", node))
    elif isinstance(node, str):
        out.append(_str(node))
    elif isinstance(node, (bytes, bytearray)):
        out.extend([_bin_header(len(node)), bytes(node)])
    else:
        raise TypeError(f"msgpack: cannot write a {type(node).__name__}")


def dumps(tree) -> bytes:
    out = []
    _parts(tree, out)
    return b"".join(out)


def write(path: str, tree) -> int:
    """Write `tree` to `path`; returns the bytes written."""
    out = []
    _parts(tree, out)
    with open(path, "wb") as f:
        for part in out:
            f.write(part)
    return sum(len(p) for p in out)  # the buffers are 1-D uint8 views

