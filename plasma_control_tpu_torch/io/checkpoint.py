"""Full-state checkpoints, and actor and critic weight files in flax's
msgpack layout.

:func:`save_checkpoint` / :func:`restore_checkpoint` are the counterparts of
the JAX package's orbax pair: a nested dict (or list) of tensors, numpy
arrays, Python scalars and ``torch.Generator`` s (stored as their states),
in the port's own format (``torch.save`` of the tree with every tensor moved
to the host),
written to a temporary name and renamed into place, so a preempted write
never leaves a partial checkpoint. ``like`` pins the structure, shapes and
dtypes at restore and puts each tensor on its device. The orbax checkpoints
of the JAX package are not read here: their on-disk format is
tensorstore's.

:func:`save_params` / :func:`load_params` are the counterparts of
:func:`plasma_control_tpu.io.checkpoint.save_params` / ``load_params``: a
params tree written by ``flax.serialization.to_bytes``,
read and written here with no flax and no ``msgpack`` package. The codec
covers what flax emits for a params tree: maps with string keys, strings,
binary, arrays, integers, floats, nil, booleans, and the extension types
flax registers, 1 = ndarray and 3 = numpy scalar, whose payload is the
msgpack of ``(shape, dtype name, C-order bytes)``. A file this module writes
is byte for byte what flax's ``to_bytes`` writes for the same tree (both keep
the tree's key order), so either package loads the other's files. (flax
splits arrays over 1 GiB into chunks; no weight file comes near that, and
:func:`packb` refuses such an array.)
"""

from __future__ import annotations

import os
import struct
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "conform", "packb", "unpackb",
           "save_params", "load_params"]

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_MAX_ARRAY_BYTES = 2**30  # flax chunks arrays above this size


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out += b"\xc0"
    elif obj is True or obj is False:
        out += b"\xc3" if obj else b"\xc2"
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        out += (bytes([0xA0 | n]) if n < 32 else b"\xd9" + struct.pack(">B", n) if n < 2**8
                else b"\xda" + struct.pack(">H", n) if n < 2**16 else b"\xdb" + struct.pack(">I", n))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        n = len(obj)
        out += (b"\xc4" + struct.pack(">B", n) if n < 2**8 else b"\xc5" + struct.pack(">H", n)
                if n < 2**16 else b"\xc6" + struct.pack(">I", n))
        out += obj
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        out += (bytes([0x90 | n]) if n < 16 else b"\xdc" + struct.pack(">H", n) if n < 2**16
                else b"\xdd" + struct.pack(">I", n))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        out += (bytes([0x80 | n]) if n < 16 else b"\xde" + struct.pack(">H", n) if n < 2**16
                else b"\xdf" + struct.pack(">I", n))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 128:
        out += bytes([v])
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16), (0xCE, ">I", 2**32),
                               (0xCF, ">Q", 2**64)):
            if v < top:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15), (0xD2, ">i", 31),
                                (0xD3, ">q", 63)):
            if v >= -(2**bits):
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += bytes([fixed[n], code])
    elif n < 2**8:
        out += b"\xc7" + struct.pack(">Bb", n, code)
    elif n < 2**16:
        out += b"\xc8" + struct.pack(">Hb", n, code)
    else:
        out += b"\xc9" + struct.pack(">Ib", n, code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    if arr.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError(f"array of {arr.nbytes} bytes: flax would chunk it, this codec does not")
    return packb((tuple(int(s) for s in arr.shape), arr.dtype.name, arr.tobytes("C")))


def packb(obj: Any) -> bytes:
    """msgpack bytes of a tree, as ``flax.serialization.to_bytes`` writes
    it (numpy arrays and scalars as flax's extension types)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        sizes = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in sizes:
            return self.take(self.unpack(sizes[b])).decode("utf-8")
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sizes:
            return self.take(self.unpack(sizes[b]))
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return self.read_map(self.unpack(">H" if b == 0xDE else ">I"))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixed:
            n = fixed[b]
        elif b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        else:
            raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
        code = self.unpack(">b")
        return _ext(code, self.take(n))

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ext(code: int, data: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"msgpack extension type {code} is not supported")
    shape, dtype_name, buf = unpackb(data)
    arr = np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape, order="C")
    return arr if code == _EXT_NDARRAY else arr[()]


def unpackb(data: bytes) -> Any:
    """The tree of msgpack bytes, as ``flax.serialization.msgpack_restore``
    returns it: dicts, lists, numpy arrays (read-only views of the bytes,
    as there) and scalars."""
    r = _Reader(data)
    obj = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after the msgpack object")
    return obj


def save_params(path: str, params: Any) -> None:
    """Write a params tree (numpy arrays; see
    :func:`...interop.actor_params_to_numpy` for a network's) as flax's
    ``to_bytes`` writes it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(packb(params))


def load_params(path: str, like: Optional[Any] = None) -> Any:
    """Read a params tree. With ``like`` a network of
    :mod:`...control.rl.networks`, the weights are loaded into it (a
    mismatched tree raises) and the network is returned."""
    with open(path, "rb") as f:
        tree = unpackb(f.read())
    if like is None:
        return tree
    from ..interop import actor_params_from_numpy

    like.load_state_dict(actor_params_from_numpy(tree, like))
    return like


_NUMPY = "__ndarray__"  # marks a numpy leaf, stored as a host tensor


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Generator):
        return tree.get_state()
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return {_NUMPY: torch.from_numpy(np.ascontiguousarray(tree).copy())}
    if isinstance(tree, np.generic):
        return tree.item()
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    raise TypeError(f"a checkpoint cannot hold a {type(tree).__name__}")


def _from_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        if set(tree) == {_NUMPY}:
            return tree[_NUMPY].numpy()
        return {k: _from_host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_from_host(v) for v in tree]
    return tree


def save_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` to the file ``path`` (its directory is made): to
    ``path + ".tmp"`` first, then ``os.replace``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_host(tree), tmp)
    os.replace(tmp, path)


def conform(tree: Any, like: Any, where: str = "") -> Any:
    """``tree`` (as read from a checkpoint) checked against ``like``: the same
    dict keys and list lengths, each tensor or array of the same shape and
    dtype (a tensor then moved to ``like``'s device; a generator's state is
    a uint8 tensor of its kind's length), each scalar of the same kind.
    Raises ``ValueError`` naming the first leaf that differs."""
    name = where or "the root"
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"checkpoint leaf {name}: keys {got}, expected {sorted(like)}")
        return {k: conform(tree[k], like[k], f"{where}/{k}") for k in like}
    if isinstance(like, (list, tuple)):
        if not isinstance(tree, list) or len(tree) != len(like):
            raise ValueError(f"checkpoint leaf {name}: expected a list of {len(like)}")
        return [conform(t, l, f"{where}[{i}]") for i, (t, l) in enumerate(zip(tree, like))]
    if isinstance(like, (torch.Tensor, np.ndarray)):
        is_np = isinstance(like, np.ndarray)
        if not isinstance(tree, np.ndarray if is_np else torch.Tensor):
            raise ValueError(f"checkpoint leaf {name}: {type(tree).__name__}, expected "
                             f"{type(like).__name__}")
        if tuple(tree.shape) != tuple(like.shape) or tree.dtype != like.dtype:
            raise ValueError(f"checkpoint leaf {name}: {tree.dtype} {tuple(tree.shape)}, "
                             f"expected {like.dtype} {tuple(like.shape)}")
        return tree if is_np else tree.to(like.device)
    kinds = (bool,) if isinstance(like, bool) else (int,) if isinstance(like, int) else (
        (int, float) if isinstance(like, float) else (type(like),))
    if isinstance(tree, bool) != isinstance(like, bool) or not isinstance(tree, kinds):
        raise ValueError(f"checkpoint leaf {name}: {type(tree).__name__}, expected "
                         f"{type(like).__name__}")
    return tree


def restore_checkpoint(path: str, like: Optional[Any] = None) -> Any:
    """The tree :func:`save_checkpoint` wrote (tensors on the host, generator
    states as uint8 tensors), or with ``like`` that tree passed through
    :func:`conform`. The file is read with ``torch.load(weights_only=True)``:
    tensors, containers and scalars only, no code."""
    tree = _from_host(torch.load(os.path.abspath(path), map_location="cpu", weights_only=True))
    return tree if like is None else conform(tree, like)
