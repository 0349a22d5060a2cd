"""The checkpoint format of the JAX package, on numpy and the standard library.

The JAX package writes its train state with `flax.serialization.to_bytes` and
reads it with `msgpack_restore` (txt2vid_tpu/utils/checkpoint.py:25-34,
104-123). This module reads and writes the same bytes without flax or the
`msgpack` package:

- msgpack's nil, bool, int, float, str, bin, array, map and ext types, each
  written in its shortest form, as msgpack-python's packer writes them (so a
  tree written here is byte for byte what flax writes for the same tree);
- ext 1, an ndarray: the msgpack encoding of (shape, dtype name, C-order
  bytes); ext 3, a numpy scalar, the same encoding of a 0-d array (flax's
  ext 2, a Python complex, has no place in a state tree and raises);
- a state tree is nested dicts with string keys (flax stores a tuple as
  {"0": ..., "1": ...} and a namedtuple by its field names); None is nil;
- an array over MAX_CHUNK_SIZE bytes is written as flax's chunked form
  {"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}} and
  read back whole.

A bfloat16 leaf (the --bf16 / --bf16_nu Adam moments) is written as flax
writes it: ext 1 with the dtype name "bfloat16" and the high 16 bits of each
float32. numpy has no bfloat16, so on the host such a leaf is a
`BFloat16Array`, the uint16 bit patterns; reading gives float32, which holds
every bfloat16 value exactly (a restore rounds it to the state's dtype).
"""

import struct

import numpy as np

MAX_CHUNK_SIZE = 2**30
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class BFloat16Array(np.ndarray):
    """A bfloat16 array on numpy: its uint16 bit patterns, the high halves of
    float32 values."""

    @classmethod
    def from_bits(cls, bits) -> "BFloat16Array":
        return np.array(bits, dtype=np.uint16, order="C").view(cls)

    @classmethod
    def from_float32(cls, x) -> "BFloat16Array":
        """float32 rounded to the nearest bfloat16, ties to even (NaN stays
        NaN), as jnp's astype and torch's .to(torch.bfloat16) round."""
        bits = np.array(x, dtype=np.float32, order="C").view(np.uint32)
        rounded = (bits + (0x7FFF + ((bits >> 16) & 1))) >> 16
        nan = np.isnan(bits.view(np.float32))
        return cls.from_bits(np.where(nan, (bits >> 16) | 0x40, rounded).astype(np.uint16))

    def to_float32(self) -> np.ndarray:
        return (self.view(np.ndarray).astype(np.uint32) << 16).view(np.float32)


def as_float32(a) -> np.ndarray:
    """A leaf as a float32 numpy array (a BFloat16Array by its values)."""
    if isinstance(a, BFloat16Array):
        return a.to_float32()
    return np.asarray(a, dtype=np.float32)


# --------------------------------------------------------------------- writing

def _pack_len(out, n, fix_base, fix_max, codes):
    """A length header: the fix form below fix_max, else the 8/16/32-bit code."""
    if fix_base is not None and n <= fix_max:
        out.append(struct.pack("B", fix_base | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack("BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"object of length {n} is too large for msgpack")


def _pack_int(out, x):
    if 0 <= x < 0x80:
        out.append(struct.pack("B", x))
    elif -0x20 <= x < 0:
        out.append(struct.pack("b", x))
    elif 0x80 <= x <= 0xFF:
        out.append(struct.pack("BB", 0xCC, x))
    elif -0x80 <= x < 0:
        out.append(struct.pack(">Bb", 0xD0, x))
    elif 0xFF < x <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, x))
    elif -0x8000 <= x < -0x80:
        out.append(struct.pack(">Bh", 0xD1, x))
    elif 0xFFFF < x <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, x))
    elif -0x80000000 <= x < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, x))
    elif 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, x))
    elif -0x8000000000000000 <= x < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, x))
    else:
        raise OverflowError(f"integer {x} does not fit msgpack")


def _pack_ext(out, code, data: bytes):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack("Bb", fixed[n], code))
    elif n <= 0xFF:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """msgpack of (shape, dtype name, C-order bytes), flax's _ndarray_to_bytes."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no msgpack form")
    name = "bfloat16" if isinstance(arr, BFloat16Array) else arr.dtype.name
    out = []
    _pack(out, [list(int(s) for s in arr.shape), name,
                arr.view(np.ndarray).tobytes("C")])
    return b"".join(out)


def _pack(out, obj):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif type(obj) is bytes:
        _pack_len(out, len(obj), None, -1, (0xC4, 0xC5, 0xC6))
        out.append(obj)
    elif type(obj) is list:
        _pack_len(out, len(obj), 0x90, 0x0F, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif type(obj) is dict:
        _pack_len(out, len(obj), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):     # a BFloat16Array too
        _pack_ext(out, EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    else:
        raise TypeError(f"no msgpack form for {type(obj).__name__}")


def _chunk(arr: np.ndarray) -> dict:
    chunksize = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + chunksize] for i in range(0, flat.size, chunksize)]
    return {_CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunk_large(tree):
    """Arrays over MAX_CHUNK_SIZE bytes -> flax's chunked form (a new tree)."""
    if isinstance(tree, dict):
        return {k: _chunk_large(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def packb(tree) -> bytes:
    """The bytes flax's `msgpack_serialize` writes for a tree of dicts with
    string keys, lists, None, Python scalars and numpy arrays."""
    out = []
    _pack(out, _chunk_large(tree))
    return b"".join(out)


# --------------------------------------------------------------------- reading

def _dtype(name: str):
    if name == "bfloat16":
        return None
    return np.dtype(name)


def _ndarray_from(data) -> np.ndarray:
    shape, name, buf = _Reader(data, raw=True).read_all()
    name = name.decode() if isinstance(name, bytes) else name
    dtype = _dtype(name)
    if dtype is None:        # bfloat16: the high half of a float32
        return np.frombuffer(buf, dtype=np.uint16).reshape(shape).view(
            BFloat16Array).to_float32()
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


class _Reader:
    def __init__(self, data, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def read_all(self):
        obj = self.read()
        if self.pos != len(self.data):
            raise ValueError(f"{len(self.data) - self.pos} bytes after the msgpack object")
        return obj

    def _take(self, n: int):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw else b.decode("utf-8")

    def _ext(self, n: int):
        code = self._unpack("b")
        data = self._take(n)
        if code == EXT_NDARRAY:
            return _ndarray_from(data)
        if code == EXT_NPSCALAR:
            return _ndarray_from(data)[()]
        raise ValueError(f"unknown msgpack ext type {code}")

    def read(self):
        b = self._unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return self._unpack(ints[b])
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lens:
            return bytes(self._take(self._unpack(lens[b])))
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lens:
            return self._str(self._unpack(lens[b]))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self._unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixed:
            return self._ext(fixed[b])
        lens = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lens:
            return self._ext(self._unpack(lens[b]))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} starts no msgpack object")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes):
    """What flax's `msgpack_restore` returns for `data`: nested dicts with
    numpy array leaves (read-only views of `data`), chunked arrays joined; a
    bfloat16 leaf as float32."""
    return _unchunk(_Reader(data).read_all())
