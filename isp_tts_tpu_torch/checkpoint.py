"""Read the JAX package's ``.ckpt`` files with the standard library and numpy.

Counterpart of ``isp_tts_tpu/training/checkpoint.py:load_checkpoint``. A
checkpoint is one msgpack document written by ``flax.serialization``:
nested maps of config values and arrays, where each array is a msgpack
extension of type 1 holding the msgpack triple (shape, dtype name, C-order
bytes). This module decodes that subset of msgpack itself, so the port
reads checkpoints without ``msgpack`` or ``flax`` installed.

:func:`load_checkpoint` returns the document as flax does, except that the
model's nested ``state`` is flattened to ``{"a.b.c": np.ndarray}``, the
form :func:`isp_tts_tpu_torch.models.base.load_jax_state` takes.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder over one bytes object (the subset flax writes)."""

    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw  # keep str payloads as bytes (flax's inner triples)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack document")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> str | bytes:
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def value(self) -> Any:
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        fixed = {
            0xC0: lambda: None, 0xC2: lambda: False, 0xC3: lambda: True,
            0xC4: lambda: bytes(self.take(self.unpack(">B"))),
            0xC5: lambda: bytes(self.take(self.unpack(">H"))),
            0xC6: lambda: bytes(self.take(self.unpack(">I"))),
            0xC7: lambda: self.ext(self.unpack(">B")),
            0xC8: lambda: self.ext(self.unpack(">H")),
            0xC9: lambda: self.ext(self.unpack(">I")),
            0xCA: lambda: self.unpack(">f"), 0xCB: lambda: self.unpack(">d"),
            0xCC: lambda: self.unpack(">B"), 0xCD: lambda: self.unpack(">H"),
            0xCE: lambda: self.unpack(">I"), 0xCF: lambda: self.unpack(">Q"),
            0xD0: lambda: self.unpack(">b"), 0xD1: lambda: self.unpack(">h"),
            0xD2: lambda: self.unpack(">i"), 0xD3: lambda: self.unpack(">q"),
            0xD4: lambda: self.ext(1), 0xD5: lambda: self.ext(2),
            0xD6: lambda: self.ext(4), 0xD7: lambda: self.ext(8),
            0xD8: lambda: self.ext(16),
            0xD9: lambda: self.str_(self.unpack(">B")),
            0xDA: lambda: self.str_(self.unpack(">H")),
            0xDB: lambda: self.str_(self.unpack(">I")),
            0xDC: lambda: self.array(self.unpack(">H")),
            0xDD: lambda: self.array(self.unpack(">I")),
            0xDE: lambda: self.map_(self.unpack(">H")),
            0xDF: lambda: self.map_(self.unpack(">I")),
        }
        if t not in fixed:
            raise ValueError(f"msgpack type byte 0x{t:02x} is not valid")
        return fixed[t]()

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            arr = _ndarray_from_bytes(payload)
            return arr if code == _EXT_NDARRAY else arr[()]
        if code == _EXT_COMPLEX:
            re_, im = _Reader(payload).value()
            return complex(re_, im)
        raise ValueError(f"msgpack extension type {code} is not a flax type")


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Reader(payload, raw=True).value()
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: widen the bits to float32 exactly
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape, order="C")


def _unchunk(node: Any) -> Any:
    """Rejoin arrays flax split into chunks (only those over 1 GiB)."""
    if not isinstance(node, dict):
        return node
    if _CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def msgpack_restore(data: bytes) -> Any:
    """Decode a flax msgpack document (``flax.serialization.msgpack_restore``)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack document")
    return _unchunk(out)


def flatten_state(state: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested ``{"a": {"b": array}}`` -> ``{"a.b": array}``."""
    flat: dict[str, np.ndarray] = {}
    for key, value in state.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(flatten_state(value, name + "."))
        else:
            flat[name] = value
    return flat


def load_checkpoint(path: str | Path) -> dict:
    """Read a ``.ckpt`` file: ``{"model": {"config": dict, "state": flat}}``
    plus whatever else the file holds (``format``, ``experiment``)."""
    ckpt = msgpack_restore(Path(path).read_bytes())
    model = ckpt.get("model")
    if not isinstance(model, dict) or "config" not in model or "state" not in model:
        raise ValueError(f"{path} holds no model config and state")
    model["state"] = flatten_state(model["state"])
    return ckpt
