"""Read and write the JAX package's ``.ckpt`` files with the standard
library and numpy.

Counterpart of ``isp_tts_tpu/training/checkpoint.py``. A checkpoint is one
msgpack document as ``flax.serialization`` writes it: nested maps of config
values and arrays, where each array is a msgpack extension of type 1
holding the msgpack triple (shape, dtype name, C-order bytes) and a numpy
scalar one of type 3. This module encodes and decodes that subset of
msgpack itself, so the port reads and writes checkpoints without
``msgpack`` or ``flax`` installed.

:func:`load_checkpoint` returns the document as flax does, except that the
model's ``state`` is flattened to ``{"a.b.c": np.ndarray}`` (the JAX
trainer writes it flat; nested maps are flattened too), the form
:func:`isp_tts_tpu_torch.models.base.load_jax_state` takes.
:func:`save_checkpoint` writes a payload atomically (through ``.tmp``).

The reference's torch ``.pt`` checkpoints (``{"model": {"config",
"state_dict"}}``) are read by :func:`load_torch_checkpoint`, which
:func:`load_checkpoint` calls for a ``.pt`` path as the JAX package does,
and written by :func:`save_torch_checkpoint`; the names map through
:mod:`isp_tts_tpu_torch.models.acoustic.interop`.
"""

from __future__ import annotations

import logging
import struct
from pathlib import Path
from typing import Any

import numpy as np

logger = logging.getLogger("isp_tts_tpu_torch")

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
    plus whatever else the file holds (``format``, ``experiment``). A
    ``.pt`` file is a reference checkpoint: :func:`load_torch_checkpoint`."""
    if Path(path).suffix == ".pt":
        return load_torch_checkpoint(path)
    ckpt = msgpack_restore(Path(path).read_bytes())
    model = ckpt.get("model")
    if not isinstance(model, dict) or "config" not in model or "state" not in model:
        raise ValueError(f"{path} holds no model config and state")
    model["state"] = flatten_state(model["state"])
    return ckpt


def _pack_int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if n <= top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                               (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"{n} does not fit msgpack's 64-bit integers")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple) -> bytes:
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError("msgpack object too large")


def _pack_ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _pack_len(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject:
        raise ValueError("object arrays cannot be written")
    return _pack([list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes("C")])


def _pack(obj: Any) -> bytes:
    if obj is None:
        return b"\xc0"
    if obj is True:
        return b"\xc3"
    if obj is False:
        return b"\xc2"
    if isinstance(obj, np.ndarray):
        return _pack_ext(_EXT_NDARRAY, _ndarray_to_bytes(obj))
    if isinstance(obj, np.generic):
        return _pack_ext(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(obj)))
    if isinstance(obj, int):
        return _pack_int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, complex):
        return _pack_ext(_EXT_COMPLEX, _pack([obj.real, obj.imag]))
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        return _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(obj, (bytes, bytearray)):
        return _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6)) + bytes(obj)
    if isinstance(obj, (list, tuple)):
        return _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD)) + b"".join(
            _pack(v) for v in obj)
    if isinstance(obj, dict):
        return _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF)) + b"".join(
            _pack(k) + _pack(obj[k]) for k in sorted(obj, key=str))
    raise TypeError(f"cannot write {type(obj).__name__} to a checkpoint")


def msgpack_serialize(tree: Any) -> bytes:
    """Encode a tree of dicts, lists, scalars and numpy arrays as
    ``flax.serialization.msgpack_serialize`` does (map keys sorted)."""
    return _pack(tree)


def save_checkpoint(path: str | Path, payload: dict) -> None:
    """Write ``payload`` to ``path`` through ``path.tmp`` and a rename. The
    model's ``state`` is written as given: flat, ``{"a.b.c": array}``, as
    the JAX trainer writes it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(msgpack_serialize(payload))
    tmp.replace(path)


# -- reference torch ``.pt`` files ----------------------------------------------


def _plain(obj: Any) -> Any:
    """Mappings and sequences (OmegaConf's containers too) as dicts and lists."""
    if hasattr(obj, "items"):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def load_torch_checkpoint(path: str | Path) -> dict:
    """Read a reference torch checkpoint: ``{"format": "torch", "model":
    {"config": dict, "state": {reference name: np.ndarray}}}``. Map the
    names with the model class's ``convert_torch_checkpoint``.

    Files of tensors and plain containers load in ``weights_only`` mode.
    The reference's own files pickle an OmegaConf config beside the
    tensors; for those it warns and unpickles in full, which runs code from
    the file, as the JAX package does.
    """
    import torch

    try:
        ckpt = torch.load(str(path), map_location="cpu", weights_only=True)
    except Exception:  # noqa: BLE001 - any refusal of the safe loader
        logger.warning("%s does not load in safe mode (weights_only); unpickling it in "
                       "full: only do this with checkpoints you trust", path)
        ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    model_blob = ckpt.get("model", ckpt)
    state_dict = model_blob.get("state_dict", model_blob)
    state = {str(k): v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
             for k, v in state_dict.items()}
    config = model_blob.get("config", {})
    return {"format": "torch", "model": {"config": _plain(config), "state": state}}


def save_torch_checkpoint(model, path: str | Path) -> None:
    """Write a port acoustic model as a reference-format ``.pt``
    (``{"model": {"config", "state_dict"}}``), which the reference's
    ``from_pretrained`` and the JAX package's :func:`load_torch_checkpoint`
    read: the inverse of :func:`load_torch_checkpoint`."""
    import torch

    from .config import config_to_dict
    from .models.acoustic.interop import export_torch_config, export_torch_state

    temb = getattr(getattr(getattr(model, "temporal_adaptor", None), "predictor", None),
                   "time_embedding", None)
    freq_scale = float(temb.freq_scale) if temb is not None else None
    state = export_torch_state(model.state_dict(), freq_scale)
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in state.items()}
    config = export_torch_config(config_to_dict(model.config))
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": {"config": config, "state_dict": tensors}}, str(path))
