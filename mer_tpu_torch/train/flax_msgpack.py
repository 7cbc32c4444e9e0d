"""A reader of ``mer_tpu``'s flax msgpack checkpoints in plain Python.

``mer_tpu`` writes ``flax.serialization.msgpack_serialize`` of its payload
``{epoch, params, opt_state, extra}`` to one file
(``mer_tpu/train/checkpoint.py:30``), or one file per process,
``<dir>/shard<i>-of-<n>.msgpack``, whose array leaves are self-describing
``__ckpt_leaf__`` dicts (``:147``). This module reads both with neither
msgpack nor flax installed:

- :func:`unpackb` decodes the msgpack format itself (maps, arrays, str, bin,
  ints, floats, nil, bool and ext types);
- flax's ext types (``flax/serialization.py:278-316``): 1, an ndarray packed
  as ``(shape, dtype name, buffer)``; 2, a native complex; 3, a numpy scalar.
  A ``bfloat16`` buffer becomes a ``torch.bfloat16`` tensor through a uint16
  view (numpy has no bfloat16); every other dtype stays a numpy array;
- flax's ``__msgpack_chunked_array__`` chunking of arrays over 2^30 bytes
  is put back (``:344-390``);
- :func:`load_sharded` merges a shard directory as
  ``mer_tpu``'s ``load_checkpoint_sharded`` does (``:209``): every region of a
  sharded leaf covered, a replicated leaf from process 0, and a missing shard
  file or an uncovered region raises.

:func:`load` dispatches on the path: a directory is a shard layout, a file
a single msgpack payload. Both return ``mer_tpu``'s payload layout with an
``int`` epoch.
"""

from __future__ import annotations

import glob
import json
import os
import struct

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"
_LEAF = "__ckpt_leaf__"


class ExtType:
    """An ext value of a type code this reader does not interpret."""

    def __init__(self, code: int, data: bytes):
        self.code, self.data = code, data


class _Reader:
    """One pass over a msgpack buffer; ``raw`` keeps str values as bytes."""

    def __init__(self, data: bytes, ext_hook=None, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook
        self.raw = raw

    def take(self, n: int) -> memoryview:
        start, self.pos = self.pos, self.pos + n
        if self.pos > len(self.buf):
            raise ValueError("truncated msgpack data")
        return self.buf[start:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        return self.ext_hook(code, data) if self.ext_hook is not None else ExtType(code, data)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack({0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.string(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"invalid msgpack type byte 0x{b:02x} at offset {self.pos - 1}")


def unpackb(data: bytes, ext_hook=None, raw: bool = False):
    """The one msgpack object in ``data`` (trailing bytes raise); ext values
    go through ``ext_hook(code, data)``, or come back as :class:`ExtType`."""
    reader = _Reader(data, ext_hook, raw)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes of extra data after the msgpack object")
    return out


def _ndarray(data: bytes):
    """flax's ``_ndarray_from_bytes``: a numpy array, or a ``torch.bfloat16``
    tensor for a bfloat16 buffer."""
    shape, name, buffer = unpackb(data, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        return torch.from_numpy(np.frombuffer(buffer, np.uint16).reshape(shape).copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _flax_ext(code: int, data: bytes):
    if code == 1:
        return _ndarray(data)
    if code == 2:
        real, imag = unpackb(data)
        return complex(real, imag)
    if code == 3:
        return _ndarray(data)[()]
    return ExtType(code, data)


def _concat(chunks: list):
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks])
    return np.concatenate(chunks)


def _unchunk(node: dict):
    """flax's ``_unchunk``: the array a chunked-array dict stands for."""
    shape = tuple(int(node["shape"][str(i)]) for i in range(len(node["shape"])))
    chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
    return _concat(chunks).reshape(shape)


def _unchunk_tree(node):
    """Every chunked-array dict in ``node`` replaced by its array."""
    if isinstance(node, dict):
        if _CHUNKED in node:
            return _unchunk(node)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def msgpack_restore(data: bytes):
    """flax's ``msgpack_restore``: the tree ``msgpack_serialize`` wrote."""
    return _unchunk_tree(unpackb(data, ext_hook=_flax_ext))


def _read(path: str):
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def is_msgpack_checkpoint(path: str | os.PathLike) -> bool:
    """Whether ``path`` is a file whose first byte opens a msgpack map (a
    flax payload) or a directory of ``shard*-of-*.msgpack`` files."""
    if os.path.isdir(path):
        return bool(glob.glob(os.path.join(os.fspath(path), "shard*-of-*.msgpack")))
    with open(path, "rb") as f:
        first = f.read(1)
    return bool(first) and (0x80 <= first[0] <= 0x8F or first[0] in (0xDE, 0xDF))


def load_file(path: str | os.PathLike) -> dict:
    """A single-file checkpoint (``mer_tpu``'s ``load_checkpoint``)."""
    payload = _read(os.fspath(path))
    payload["epoch"] = int(payload["epoch"])
    return payload


def _merge_leaf(leaves: list[dict]):
    sharded = [leaf for leaf in leaves if leaf["kind"] == "sharded"]
    if sharded:
        shape = tuple(int(d) for d in sharded[0]["shape"])
        dtype = sharded[0]["dtype"]
        out = (torch.empty(shape, dtype=torch.bfloat16) if "bfloat16" in dtype
               else np.empty(shape, dtype=np.dtype(dtype)))
        seen = np.zeros(shape, dtype=bool)
        for leaf in sharded:
            for key, arr in leaf["shards"].items():
                idx = tuple(slice(a, b) for a, b in json.loads(key))
                out[idx] = arr
                seen[idx] = True
        if not seen.all():
            raise ValueError(f"sharded checkpoint leaf has uncovered regions (shape {shape})")
        return out
    for leaf in leaves:
        if leaf["kind"] == "value":
            return leaf["value"]
    raise ValueError("checkpoint leaf present only as 'elsewhere' markers: shard file(s) missing")


def _merge_trees(trees: list):
    if all(isinstance(t, dict) and t.get(_LEAF) == 1 for t in trees):
        return _merge_leaf(trees)
    if isinstance(trees[0], dict):
        return {k: _merge_trees([t[k] for t in trees]) for k in trees[0]}
    return trees[0]


def load_sharded(dirpath: str | os.PathLike) -> dict:
    """Every ``shard*-of-*.msgpack`` file of ``dirpath`` merged into the
    single-file payload layout (``mer_tpu``'s ``load_checkpoint_sharded``)."""
    files = sorted(glob.glob(os.path.join(os.path.abspath(os.fspath(dirpath)), "shard*-of-*.msgpack")))
    if not files:
        raise FileNotFoundError(f"no shard files under {dirpath}")
    payloads = [_read(p) for p in files]
    count = int(payloads[0]["process_count"])
    if len(files) != count:
        raise ValueError(f"found {len(files)} shard files, checkpoint was written by {count} processes")
    return {
        "epoch": int(payloads[0]["epoch"]),
        "params": _merge_trees([p["params"] for p in payloads]),
        "opt_state": _merge_trees([p["opt_state"] for p in payloads]),
        "extra": payloads[0].get("extra", {}),
    }


def load(path: str | os.PathLike) -> dict:
    """Either layout: a shard directory or a single file
    (``mer_tpu``'s ``load_checkpoint_auto``)."""
    return load_sharded(path) if os.path.isdir(path) else load_file(path)
