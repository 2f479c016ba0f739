"""Native (C++) WAV decode, built with g++ and loaded with ctypes.

Counterpart of ``isp_tts_tpu/native``: ``src/wavio.cc`` (the port's copy)
parses RIFF/WAVE, converts PCM 8/16/24/32 and float32 to mono float32 and
decodes a batch of files on a C++ thread pool, bit-equal to the Python
reader of :mod:`isp_tts_tpu_torch.data.audio`. It is compiled on first use
with ``g++ -O3 -shared -fPIC`` into ``isp_tts_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name that hashes the source, as the kernels'
libraries are.

Unlike the JAX package, a failed build or load raises: nothing falls back
to the Python reader unless the caller asks for it
(``load_audio(..., native=False)``, or ``ISP_TTS_TPU_NATIVE=0`` in the
environment, the JAX package's setting).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "wavio.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
ABI_VERSION = 1
ERR_OPEN, ERR_FORMAT, ERR_CODEC, ERR_ALLOC = -1, -2, -3, -4
_ERRORS = {
    ERR_OPEN: "file missing or unreadable",
    ERR_FORMAT: "not a RIFF/WAVE file or missing fmt/data chunk",
    ERR_CODEC: "unsupported codec (PCM 8/16/24/32 and float32 only)",
    ERR_ALLOC: "out of memory",
}

_lib: ctypes.CDLL | None = None


class WavDecodeError(ValueError):
    """A file the native parser refused; ``codes`` holds each file's error
    code (``ERR_*``) by path."""

    def __init__(self, message: str, codes: dict[str, int]):
        super().__init__(message)
        self.codes = codes


def enabled() -> bool:
    """Whether readers decode natively by default (``ISP_TTS_TPU_NATIVE``
    is not ``0``)."""
    return os.environ.get("ISP_TTS_TPU_NATIVE", "1") != "0"


def library_path() -> Path:
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
                         + str(ABI_VERSION).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libwavio-{tag}.so"


def build() -> Path:
    """Compile ``src/wavio.cc`` unless its hashed library exists; raises
    when g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)  # a concurrent build writes the same bytes
    except FileNotFoundError as e:
        raise RuntimeError("the native WAV decoder needs g++ to build") from e
    finally:
        Path(tmp).unlink(missing_ok=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if that fails."""
    global _lib
    if _lib is not None:
        return _lib
    cdll = ctypes.CDLL(str(build()))
    cdll.wav_decode_mono.restype = ctypes.c_int64
    cdll.wav_decode_mono.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                     ctypes.POINTER(ctypes.c_int32)]
    cdll.wav_free.restype = None
    cdll.wav_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    cdll.wav_decode_batch.restype = ctypes.c_int32
    cdll.wav_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    cdll.wavio_abi_version.restype = ctypes.c_int32
    cdll.wavio_abi_version.argtypes = []
    if cdll.wavio_abi_version() != ABI_VERSION:
        raise RuntimeError(f"{library_path()}: ABI {cdll.wavio_abi_version()}, "
                           f"expected {ABI_VERSION}")
    _lib = cdll
    return cdll


def _take(cdll, ptr, n: int) -> np.ndarray:
    """Copy a malloc'd float buffer into numpy and free it."""
    arr = (np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n
           else np.zeros(0, dtype=np.float32))
    cdll.wav_free(ptr)
    return arr


def decode_wav_mono(path) -> tuple[np.ndarray, int]:
    """One WAV -> (mono float32 in [-1, 1], rate); raises
    :class:`WavDecodeError` on a file the parser refuses."""
    cdll = lib()
    out = ctypes.POINTER(ctypes.c_float)()
    rate = ctypes.c_int32(0)
    n = cdll.wav_decode_mono(str(path).encode(), ctypes.byref(out), ctypes.byref(rate))
    if n < 0:
        raise WavDecodeError(f"{path}: {_ERRORS.get(n, f'decode error {n}')}",
                             {str(path): int(n)})
    return _take(cdll, out, int(n)), int(rate.value)


def decode_wav_batch(paths, n_threads: int = 0) -> list[tuple[np.ndarray, int]]:
    """Many WAVs on the C++ thread pool (0 threads: the hardware's count).
    Raises :class:`WavDecodeError` naming every file that failed (the
    others are freed first)."""
    cdll = lib()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    outs = (ctypes.POINTER(ctypes.c_float) * n)()
    lens = (ctypes.c_int64 * n)()
    rates = (ctypes.c_int32 * n)()
    errs = (ctypes.c_int32 * n)()
    failures = cdll.wav_decode_batch(c_paths, n, int(n_threads), outs, lens, rates, errs)
    results, codes = [], {}
    for i in range(n):
        if errs[i] != 0:
            codes[str(paths[i])] = int(errs[i])
        else:
            results.append((_take(cdll, outs[i], int(lens[i])), int(rates[i])))
    if failures:
        raise WavDecodeError("native WAV batch decode failed: " + "; ".join(
            f"{p}: {_ERRORS.get(c, c)}" for p, c in codes.items()), codes)
    return results
