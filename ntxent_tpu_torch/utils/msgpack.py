"""The flax msgpack checkpoint codec, written out for the port.

Counterpart of ``flax.serialization.msgpack_serialize`` /
``msgpack_restore`` (and ``to_bytes`` of a state dict), which the JAX
package's ``training/checkpoint.py`` writes its ``state.msgpack`` with.
The port imports neither flax nor the ``msgpack`` package, so the wire
format is encoded here:

* a tree is nested dicts (str keys) and lists of ints, floats, bools,
  None, str and bytes, with array leaves;
* an array (numpy, or a torch tensor on the CPU) is msgpack ext type 1
  whose payload is the msgpack array ``[shape, dtype name, raw C-order
  bytes]``; a numpy scalar is ext type 3 with the same payload of its 0-d
  array (decoded back to a scalar);
* an array over ``MAX_CHUNK_SIZE`` bytes that is a dict value (or the
  tree itself) is written as ``{"__msgpack_chunked_array__": True,
  "shape": {"0": d0, ..}, "chunks": {"0": flat piece, ..}}`` of pieces of
  ``MAX_CHUNK_SIZE / itemsize`` elements, and read back whole;
* ``bfloat16`` is written and read by its name: a torch ``bfloat16``
  tensor (or a numpy array of an extension bfloat16 dtype) goes out as
  its raw 16-bit words, and a ``bfloat16`` array decodes to a torch
  ``bfloat16`` tensor (numpy has no such dtype without an extension).

Every integer, string, container and float takes msgpack's shortest
encoding, as the reference packer does, so ``to_bytes(tree)`` equals
``flax.serialization.msgpack_serialize(tree)`` byte for byte on the same
numpy tree. Decoded arrays are read-only views of the input bytes.

``pack(tree, write)`` streams the encoding to ``write`` (array payloads
are handed over as memoryviews, never copied into one buffer), which the
checkpoint writer uses to checksum and write a multi-GB state in one
pass; ``to_bytes`` joins the same pieces.
"""

from __future__ import annotations

import struct
from collections.abc import Callable

import numpy as np
import torch

__all__ = ["MAX_CHUNK_SIZE", "from_bytes", "pack", "to_bytes"]

MAX_CHUNK_SIZE = 2**30  # flax's limit per array leaf, bytes
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


# --- encoding ---------------------------------------------------------------


def _int(x: int) -> bytes:
    if 0 <= x < 0x80:
        return struct.pack("B", x)
    if -0x20 <= x < 0:
        return struct.pack("b", x)
    if 0 <= x <= 0xFF:
        return b"\xcc" + struct.pack("B", x)
    if -0x80 <= x < 0:
        return b"\xd0" + struct.pack("b", x)
    if 0 <= x <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", x)
    if -0x8000 <= x < 0:
        return b"\xd1" + struct.pack(">h", x)
    if 0 <= x <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", x)
    if -0x80000000 <= x < 0:
        return b"\xd2" + struct.pack(">i", x)
    if 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", x)
    if -0x8000000000000000 <= x < 0:
        return b"\xd3" + struct.pack(">q", x)
    raise OverflowError(f"integer {x} does not fit msgpack's 64 bits")


def _sized(n: int, fix: int | None, fix_max: int, codes: tuple) -> bytes:
    """The header of a str (fix 0xa0), bin (no fix form), array (0x90) or
    map (0x80) of ``n`` items: the fix form, else the 8/16/32-bit
    length forms ``codes`` offers."""
    if fix is not None and n <= fix_max:
        return struct.pack("B", fix | n)
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return struct.pack("B", code) + struct.pack(fmt, n)
    raise ValueError(f"msgpack cannot hold {n} items or bytes in one "
                     "object")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _sized(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, (0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return struct.pack("Bb", fixed[n], code)
    return _sized(n, None, 0, (0xC7, 0xC8, 0xC9)) + struct.pack("b", code)


def _array_parts(x) -> tuple[tuple, str, memoryview]:
    """(shape, dtype name, C-order bytes) of an array leaf, without a copy
    where it is already contiguous."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"only CPU tensors serialize, got {x.device}")
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:
            return (tuple(x.shape), "bfloat16",
                    memoryview(x.view(torch.int16).numpy()).cast("B"))
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes do not serialize")
    # (np.ascontiguousarray would make a 0-d array 1-d)
    arr = x if x.flags.c_contiguous else np.array(x, order="C")
    # an extension dtype (bfloat16) exports no buffer format: its bytes
    # are read through a same-size integer view
    view = arr.view(f"u{arr.dtype.itemsize}") if arr.dtype.kind == "V" \
        or arr.dtype.name == "bfloat16" else arr
    return tuple(int(d) for d in arr.shape), arr.dtype.name, \
        memoryview(view.reshape(-1)).cast("B")


def _array_ext(code: int, x, write: Callable) -> None:
    shape, name, raw = _array_parts(x)
    head = (b"\x93" + _sized(len(shape), 0x90, 15, (None, 0xDC, 0xDD))
            + b"".join(_int(d) for d in shape) + _str(name)
            + _bin_header(raw.nbytes))
    write(_ext_header(code, len(head) + raw.nbytes) + head)
    write(raw)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunked(x) -> dict:
    """flax's ``_chunk``: the flat array in pieces of at most
    MAX_CHUNK_SIZE bytes."""
    flat = x.reshape(-1)
    itemsize = x.element_size() if isinstance(x, torch.Tensor) \
        else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    n = flat.shape[0]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[lo:lo + size]
                       for i, lo in enumerate(range(0, n, size))}}


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _pack(x, write: Callable, chunk: bool) -> None:
    if chunk and _is_array(x) and _nbytes(x) > MAX_CHUNK_SIZE:
        x = _chunked(x)
    if x is None:
        write(b"\xc0")
    elif x is True:
        write(b"\xc3")
    elif x is False:
        write(b"\xc2")
    elif type(x) is int:
        write(_int(x))
    elif type(x) is float:
        write(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        write(_str(x))
    elif type(x) is bytes:
        write(_bin_header(len(x)) + x)
    elif type(x) is dict:
        write(_sized(len(x), 0x80, 15, (None, 0xDE, 0xDF)))
        for key, value in x.items():
            if type(key) is not str:
                raise TypeError(f"dict keys must be str, got {key!r}")
            write(_str(key))
            _pack(value, write, chunk)
    elif type(x) is list:
        write(_sized(len(x), 0x90, 15, (None, 0xDC, 0xDD)))
        for value in x:
            _pack(value, write, False)  # flax chunks dict values only
    elif _is_array(x):
        _array_ext(_EXT_NDARRAY, x, write)
    elif isinstance(x, np.generic):
        _array_ext(_EXT_NPSCALAR, np.asarray(x), write)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__} object")


def pack(tree, write: Callable[[bytes | memoryview], object]) -> None:
    """Stream the encoding of ``tree`` to ``write`` piece by piece."""
    _pack(tree, write, chunk=True)


def to_bytes(tree) -> bytes:
    """The msgpack bytes of ``tree`` (flax's ``msgpack_serialize``)."""
    parts: list = []
    pack(tree, parts.append)
    return b"".join(parts)


# --- decoding ---------------------------------------------------------------


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data).cast("B")
        self.at = 0

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H",
            0xC9: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H",
            0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _array_from(payload: memoryview):
    shape, name, raw = _decode(_Reader(payload), raw_str=True)
    name = bytes(name).decode()
    if name == "bfloat16":
        words = torch.frombuffer(bytearray(raw), dtype=torch.int16) \
            if len(raw) else torch.empty(0, dtype=torch.int16)
        return words.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, payload: memoryview):
    if code == _EXT_NDARRAY:
        return _array_from(payload)
    if code == _EXT_NPSCALAR:
        arr = _array_from(payload)
        return arr[()] if isinstance(arr, np.ndarray) else arr
    raise ValueError(f"unknown msgpack ext type {code}")


def _decode(r: _Reader, raw_str: bool = False):
    b = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r, raw_str) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _text(r.take(b & 0x1F), raw_str)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _NUMBERS:
        return r.unpack(_NUMBERS[b])
    if b in (0xC4, 0xC5, 0xC6):
        raw = r.take(r.unpack(_LENGTHS[b]))
        return raw if raw_str else bytes(raw)
    if b in (0xD9, 0xDA, 0xDB):
        return _text(r.take(r.unpack(_LENGTHS[b])), raw_str)
    if b in (0xDC, 0xDD):
        return [_decode(r, raw_str) for _ in range(r.unpack(_LENGTHS[b]))]
    if b in (0xDE, 0xDF):
        return _map(r, r.unpack(_LENGTHS[b]))
    if b in _FIXEXT or b in (0xC7, 0xC8, 0xC9):
        n = _FIXEXT[b] if b in _FIXEXT else r.unpack(_LENGTHS[b])
        code = r.unpack("b")
        return _ext(code, r.take(n))
    raise ValueError(f"unknown msgpack type byte 0x{b:02x}")


def _text(raw: memoryview, raw_str: bool):
    return raw if raw_str else bytes(raw).decode("utf-8")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _decode(r)
        out[key] = _decode(r)
    return out


def _unchunk(tree):
    """flax's ``_unchunk_array_leaves_in_place``: chunked dicts back to
    arrays, the tree's own and its dict values' (recursively)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    for key, value in tree.items():
        tree[key] = _unchunk(value)
    return tree


def from_bytes(data) -> object:
    """The tree msgpack ``data`` encodes (flax's ``msgpack_restore``)."""
    r = _Reader(data)
    tree = _decode(r)
    if r.at != len(r.data):
        raise ValueError(f"{len(r.data) - r.at} bytes after the msgpack "
                         "object")
    return _unchunk(tree)
