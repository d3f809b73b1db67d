"""The JAX package's flax msgpack checkpoints, read and written with the
standard library and numpy only (no ``msgpack``, no ``flax``).

* ``loads(data)`` is ``flax.serialization.msgpack_restore``: msgpack (nil,
  bool, ints, float32/64, str, bin, array, map) plus the extension types
  flax writes: 1 an ndarray, a msgpack ``(shape, dtype name, C-order
  buffer)``; 3 a numpy scalar with the same payload; 2 a complex number,
  refused here.  Leaves split at flax's ``MAX_CHUNK_SIZE`` into a
  ``__msgpack_chunked_array__`` dict are joined again.  A ``bfloat16``
  leaf, which numpy cannot name, comes back as its uint16 bits in a
  ``BFloat16Bits`` array (``as_float32`` widens it exactly; torch can view
  the bits as ``torch.bfloat16``).
* ``dumps(tree)`` is ``flax.serialization.msgpack_serialize`` for trees of
  dicts, lists, numpy leaves and plain Python scalars, byte for byte: dict
  keys sorted (``msgpack_serialize`` maps the tree with
  ``jax.tree_util.tree_map``, which sorts them) and large leaves chunked.
  The port's trainer writes its own (torch) format; ``dumps`` builds
  JAX-format files where flax is absent.
* ``sniff(path)`` tells the port's torch files from flax files by their
  first bytes, never by their name.
"""
from __future__ import annotations

import struct

import numpy as np

# flax serialization.py: leaves above this many bytes are chunked
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
ACCEPTED = ("a torch zip archive (first bytes PK\\x03\\x04)",
            "a torch legacy pickle (\\x80 and a protocol byte 2-5)",
            "a flax msgpack checkpoint (a msgpack map: \\x80-\\x8f, \\xde "
            "or \\xdf)")


class BFloat16Bits(np.ndarray):
    """The uint16 bit patterns of a bfloat16 leaf."""


def as_float32(leaf):
    """A leaf as a float32 numpy array (bfloat16 bits widened exactly)."""
    if isinstance(leaf, BFloat16Bits):
        bits = np.asarray(leaf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    return np.asarray(leaf, np.float32)


def sniff(path):
    """``"torch"`` (zip or legacy pickle) or ``"flax"`` (msgpack map) from
    the file's first bytes; raises ``ValueError`` naming the accepted
    formats for anything else.  ``\\x80`` alone is msgpack's empty map,
    ``\\x80`` then a protocol byte a pickle."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head.startswith(b"PK\x03\x04"):
        return "torch"
    if len(head) >= 2 and head[0] == 0x80 and 2 <= head[1] <= 5:
        return "torch"
    if head and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf)):
        return "flax"
    raise ValueError(f"{path}: not a checkpoint this package reads (first "
                     f"bytes {head!r}); it reads {'; '.join(ACCEPTED)}")


def load(path):
    """``loads`` of a file's bytes."""
    with open(path, "rb") as f:
        return loads(f.read())


# ----------------------------------------------------------------- decode
_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q",
          0xca: ">f", 0xcb: ">d"}
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",        # bin
        0xd9: ">B", 0xda: ">H", 0xdb: ">I",        # str
        0xdc: ">H", 0xdd: ">I",                    # array
        0xde: ">H", 0xdf: ">I",                    # map
        0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}        # ext
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data):
        self.data = data
        self.pos = 0

    def unpack(self, fmt):
        (value,) = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += struct.calcsize(fmt)
        return value

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        start, self.pos = self.pos, self.pos + n
        return start

    def obj(self):
        b = self.data[self.take(1)]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.obj() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b not in _LEN:
            raise ValueError(f"unknown msgpack type byte 0x{b:02x} at "
                             f"{self.pos - 1}")
        n = self.unpack(_LEN[b])
        if b <= 0xc6:
            start = self.take(n)
            return bytes(self.data[start:start + n])
        if b <= 0xc9:
            return self.ext(n)
        if b <= 0xdb:
            return self.str(n)
        if b <= 0xdd:
            return [self.obj() for _ in range(n)]
        return self.map(n)

    def str(self, n):
        start = self.take(n)
        return bytes(self.data[start:start + n]).decode("utf-8")

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n):
        code = self.unpack(">b")
        start = self.take(n)
        if code == EXT_COMPLEX:
            raise ValueError("complex leaves (msgpack ext 2) are not read")
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack extension type {code}")
        end, self.pos = self.pos, start
        shape, name, buf = self.obj()
        if self.pos != end:
            raise ValueError("an ndarray payload of the wrong length")
        arr = _ndarray(shape, name, buf)
        if code == EXT_NPSCALAR and not isinstance(arr, BFloat16Bits):
            return arr[()]
        return arr


def _ndarray(shape, name, buf):
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        return np.frombuffer(buf, np.uint16).reshape(shape).view(
            BFloat16Bits)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"a leaf of dtype {name!r}, which numpy does not "
                         f"name") from None
    return np.frombuffer(buf, dtype).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        flat = np.concatenate(chunks)
        return flat.reshape(shape).view(type(chunks[0]))
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(data):
    """A flax msgpack byte string -> its tree (dicts, lists, numpy leaves,
    Python scalars), as ``msgpack_restore`` gives it."""
    reader = _Reader(memoryview(data).cast("B") if not isinstance(
        data, bytes) else data)
    tree = reader.obj()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes after the msgpack "
                         f"object")
    return _unchunk(tree)


# ----------------------------------------------------------------- encode
def _int(v):
    if 0 <= v < 0x80:
        return struct.pack(">B", v)
    if v >= 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if v <= top:
                return bytes([code]) + struct.pack(fmt, v)
    elif v >= -0x20:
        return struct.pack(">b", v)
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if v >= low:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack")


def _sized(n, fix_base, fix_max, codes):
    """The header of a str/bin/array/map of ``n`` elements."""
    if fix_base is not None and n <= fix_max:
        return bytes([fix_base | n])
    for code, fmt, top in codes:
        if n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} elements do not fit msgpack")


_STR = ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff), (0xdb, ">I", 0xffffffff))
_BIN = ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff), (0xc6, ">I", 0xffffffff))
_ARR = ((0xdc, ">H", 0xffff), (0xdd, ">I", 0xffffffff))
_MAP = ((0xde, ">H", 0xffff), (0xdf, ">I", 0xffffffff))


def _ext(code, payload):
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _sized(n, None, 0, ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff),
                                   (0xc9, ">I", 0xffffffff)))
    return head + struct.pack(">b", code) + payload


def _ndarray_payload(arr):
    name = "bfloat16" if isinstance(arr, BFloat16Bits) else arr.dtype.name
    if arr.dtype.hasobject:
        raise TypeError("object arrays are not written")
    parts = [_sized(3, 0x90, 15, _ARR), _sized(arr.ndim, 0x90, 15, _ARR)]
    parts += [_int(int(d)) for d in arr.shape]
    raw = np.ascontiguousarray(arr).tobytes("C")
    parts += [_str(name), _sized(len(raw), None, 0, _BIN), raw]
    return b"".join(parts)


def _str(s):
    raw = s.encode("utf-8")
    return _sized(len(raw), 0xa0, 31, _STR) + raw


def _chunk(arr):
    """flax ``_chunk``: a flat array split into chunks of at most
    ``MAX_CHUNK_SIZE`` bytes, keys in flax's insertion order."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + size] for i, s in
                       enumerate(range(0, flat.size, size))}}


def _too_big(v):
    return v.size * v.dtype.itemsize > MAX_CHUNK_SIZE


def _encode(v, out, sort=True):
    if v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif type(v) is int:
        out.append(_int(v))
    elif type(v) is float:
        out.append(b"\xcb" + struct.pack(">d", v))
    elif type(v) is str:
        out.append(_str(v))
    elif type(v) is bytes:
        out.append(_sized(len(v), None, 0, _BIN) + v)
    elif type(v) is list:
        out.append(_sized(len(v), 0x90, 15, _ARR))
        for x in v:
            _encode(x, out, sort)
    elif type(v) is dict:
        out.append(_sized(len(v), 0x80, 15, _MAP))
        keys = sorted(v) if sort else list(v)
        for k in keys:
            _encode(k, out)
            x = v[k]
            if isinstance(x, np.ndarray) and _too_big(x):
                _encode(_chunk(x), out, sort=False)
            else:
                _encode(x, out, sort)
    elif isinstance(v, np.ndarray):
        out.append(_ext(EXT_NDARRAY, _ndarray_payload(v)))
    elif isinstance(v, np.generic):
        out.append(_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(v))))
    else:
        raise TypeError(f"can not serialize {type(v).__name__!r} object")


def dumps(tree):
    """``tree`` (dicts with str keys, lists, numpy arrays and scalars,
    Python scalars) -> the bytes ``flax.serialization.msgpack_serialize``
    writes for it."""
    out = []
    if isinstance(tree, np.ndarray) and _too_big(tree):
        _encode(_chunk(tree), out, sort=False)
    else:
        _encode(tree, out)
    return b"".join(out)
