"""Build the port's CUDA sources with plain ``nvcc`` and load them with ctypes.

Each source under ``isp_tts_tpu_torch/csrc/`` has a plain C interface and
no PyTorch or Python headers, so ``nvcc`` builds it in seconds into a shared
library under ``isp_tts_tpu_torch/_build/`` (listed in ``.gitignore``). The
library's file name carries a hash of the source, of the shared headers
(``csrc/*.cuh``) and of the command, so an edited source builds anew and an
unchanged one is built once. Nothing is built at import time: :func:`load`
builds at first use. Inside :func:`libraries` it returns libraries the
caller loaded itself (an exported artifact's embedded ones) instead.

A library is named by its source, ``mas`` for ``csrc/mas.cu``, or, for the
attention sources built once per tile width, by the source and the width:
``mqa_fwd_d128`` is ``csrc/mqa_fwd.cu`` built with ``-DATT_TILE_D=128``.
Each (source, width) is its own nvcc process, so :func:`build_all` builds
them in parallel.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import re
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
#: name -> library that :func:`load` returns instead, set by :func:`libraries`
_OVERRIDE: contextvars.ContextVar[dict[str, ctypes.CDLL]] = contextvars.ContextVar(
    "isp_tts_kernel_libraries", default={})
#: name -> {"seconds": seconds from the start of its build batch to the end of
#: its nvcc (0.0 when cached), "log": nvcc output}
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


def unit(name: str, csrc: Path | None = None) -> tuple[Path, tuple[str, ...]]:
    """(source, macro definitions) of library ``name`` in ``csrc`` (the
    package's sources by default): ``<source>``, or ``<source>_d<width>``
    for a source built once per tile width."""
    csrc = CSRC if csrc is None else csrc
    m = re.fullmatch(r"(\w+)_d(\d+)", name)
    if m and not (csrc / f"{name}.cu").exists() and (csrc / f"{m[1]}.cu").exists():
        return csrc / f"{m[1]}.cu", (f"-DATT_TILE_D={m[2]}",)
    return csrc / f"{name}.cu", ()


def nvcc_command(source: Path, out: Path, defines: tuple[str, ...] = ()) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, *defines, "-o", str(out), str(source)]


def sources_hash() -> str:
    """One hash of every kernel source, the shared headers and the flags:
    libraries built from equal hashes are interchangeable."""
    blob = b"".join(f.name.encode() + f.read_bytes() for f in sorted(CSRC.glob("*.cu*")))
    return hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]


def library_path(name: str) -> Path:
    source, defines = unit(name)
    # the shared headers count too: an edited header rebuilds every source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(source.read_bytes() + headers
                         + " ".join(NVCC_FLAGS + defines).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str) -> Path:
    """Compile library ``name`` (:func:`unit`) unless its hashed file exists."""
    return build_all([name])[name]


def build_all(names: list[str]) -> dict[str, Path]:
    """Compile every library of ``names`` whose hashed file is missing, one
    nvcc process per library, all started together; raise if any fails."""
    out = {name: library_path(name) for name in names}
    todo = [n for n in names if not out[n].exists()]
    for name in names:
        if name not in todo:
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "cached"})
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to temporary names and rename: a concurrent build or a run cut
    # mid-build never leaves a half-written library under the real name
    jobs = {}
    t0 = time.perf_counter()
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            log = tempfile.TemporaryFile(mode="w+")
            source, defines = unit(name)
            proc = subprocess.Popen(nvcc_command(source, Path(tmp), defines),
                                    stdout=log, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, log)
        pending = set(todo)
        while pending:
            for name in sorted(pending):
                proc, tmp, log = jobs[name]
                if proc.poll() is None:
                    if time.perf_counter() - t0 > 600:
                        raise RuntimeError(f"nvcc took over 600 s for {name}")
                    continue
                pending.discard(name)
                log.seek(0)
                BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log.read()}
            time.sleep(0.05)
        failed = [f"nvcc failed for {name}:\n{BUILD_INFO[name]['log']}"
                  for name, (proc, _, _) in jobs.items() if proc.returncode != 0]
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, (_, tmp, _) in jobs.items():
            os.replace(tmp, out[name])
    finally:
        for proc, tmp, log in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


@contextlib.contextmanager
def launch_stream(device):
    """The current CUDA stream of ``device``, with ``device`` the current
    card inside the block: a kernel launched there runs on the card that
    holds its tensors, whichever card is current outside (a Synthesizer
    serving over several cards runs them from one thread)."""
    import torch

    with torch.cuda.device(device):
        yield torch.cuda.current_stream().cuda_stream


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library ``name`` (:func:`unit`), or return
    the one that an enclosing :func:`libraries` names."""
    lib = _OVERRIDE.get().get(name) or _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib


@contextlib.contextmanager
def libraries(libs: dict[str, ctypes.CDLL]):
    """Inside the block (in this thread or task) :func:`load` returns
    ``libs[name]`` for each name in ``libs``, and builds nothing for them:
    the caller's own libraries serve its launches without entering the
    shared build directory or :data:`_LOADED`."""
    token = _OVERRIDE.set(libs)
    try:
        yield
    finally:
        _OVERRIDE.reset(token)
