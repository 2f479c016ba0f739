"""Build the port's CUDA sources with plain ``nvcc`` and load them with ctypes.

Each source under ``isp_tts_tpu_torch/csrc/`` has a plain C interface and
no PyTorch or Python headers, so ``nvcc`` builds it in seconds into a shared
library under ``isp_tts_tpu_torch/_build/`` (listed in ``.gitignore``). The
library's file name carries a hash of the source and of the command, so an
edited source builds anew and an unchanged one is built once. Nothing is
built at import time: :func:`load` builds at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-O3", "-arch=sm_90a", "-std=c++17", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> loaded library; filled by :func:`load`
_LOADED: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build seconds (0.0 when cached), "log": nvcc output}
BUILD_INFO: dict[str, dict] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def nvcc_command(source: Path, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(source)]


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    out = library_path(name)
    if out.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "cached"})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a temporary name and rename: a concurrent build or a run
    # cut mid-build never leaves a half-written library under the real name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(nvcc_command(CSRC / f"{name}.cu", Path(tmp)),
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                        "log": proc.stdout + proc.stderr}
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
