"""Build the port's CUDA sources with plain ``nvcc`` and load them with ctypes.

Each source under ``isp_tts_tpu_torch/csrc/`` has a plain C interface and
no PyTorch or Python headers, so ``nvcc`` builds it in seconds into a shared
library under ``isp_tts_tpu_torch/_build/`` (listed in ``.gitignore``). The
library's file name carries a hash of the source, of the shared headers
(``csrc/*.cuh``) and of the command, so an edited source builds anew and an
unchanged one is built once. Nothing is built at import time: :func:`load`
builds at first use.
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


def nvcc_command(source: Path, out: Path) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(source)]


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    # the shared headers count too: an edited header rebuilds every source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(source.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    return build_all([name])[name]


def build_all(names: list[str]) -> dict[str, Path]:
    """Compile every ``csrc/<name>.cu`` whose hashed library is missing, one
    nvcc process per source, all started together; raise if any fails."""
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
            proc = subprocess.Popen(nvcc_command(CSRC / f"{name}.cu", Path(tmp)),
                                    stdout=log, stderr=subprocess.STDOUT, text=True)
            jobs[name] = (proc, tmp, log)
        pending = set(todo)
        while pending:
            for name in sorted(pending):
                proc, tmp, log = jobs[name]
                if proc.poll() is None:
                    if time.perf_counter() - t0 > 600:
                        raise RuntimeError(f"nvcc took over 600 s for {name}.cu")
                    continue
                pending.discard(name)
                log.seek(0)
                BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log.read()}
            time.sleep(0.05)
        failed = [f"nvcc failed for {name}.cu:\n{BUILD_INFO[name]['log']}"
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


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
