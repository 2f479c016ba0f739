"""Build the port's CUDA sources for the CPU emulation in this directory.

The sources are copied, and in the copy the PTX helpers of
``attention_mma.cuh`` and ``dp_common.cuh`` (cp.async, ldmatrix, mma.sync,
cvt.rna.tf32, ex2/lg2.approx) become calls into ``emu.h``, each ``<<<...>>>``
launch becomes ``emu::launch`` and the dynamic shared memory the block's
buffer; then g++ builds each source into a shared library with the same C
entry points, which take pointers to CPU memory. ``emu.h`` runs one block
at a time, one fiber per thread, with warp collectives (ldmatrix,
mma.sync, shuffles, ballots) computed from all 32 lanes' operands: it
checks fragment layouts, lane layouts, indexing and masks, not timing,
register use or races between warps.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))

from isp_tts_tpu_torch.ops.cuda_build import unit  # noqa: E402
#: PTX helper -> the body that emulates it
REPLACE = {
    "cp_async16": "{ if (pred) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16); }",
    "cp_async4": "{ if (pred) std::memcpy(dst, src, 4); else std::memset(dst, 0, 4); }",
    "cp_async8": "{ if (pred) std::memcpy(dst, src, 8); else std::memset(dst, 0, 8); }",
    "cp_async_commit": "{}",
    "cp_async_wait": "{}",
    "ldmatrix_x4": "{ emu::ldmatrix(r, p, false); }",
    "ldmatrix_x4_trans": "{ emu::ldmatrix(r, p, true); }",
    "mma_bf16": "{ emu::mma(d, a, b0, b1, false); }",
    "mma_tf32": "{ emu::mma(d, a, b0, b1, true); }",
    "to_tf32": "{ return emu::to_tf32(x); }",
    "fast_exp2": "{ float y = exp2f(x); return std::fabs(y) < 1.17549435e-38f ? 0.f : y; }",
    "fast_log2": "{ return log2f(x); }",
}


def _replace_bodies(text: str) -> str:
    for name, body in REPLACE.items():
        m = re.search(r"__device__ __forceinline__ [\w:]+ " + name + r"\(", text)
        if not m:
            continue
        i = text.index("{", m.end())
        depth, j = 0, i
        while True:
            depth += {"{": 1, "}": -1}.get(text[j], 0)
            if depth == 0:
                break
            j += 1
        text = text[:i] + body + text[j + 1:]
    return text


def transform(text: str) -> str:
    text = _replace_bodies(text)
    text = re.sub(r"extern __shared__ __align__\(16\) unsigned char (\w+)\[\];",
                  r"unsigned char* \1 = emu::dyn_smem();", text)
    return re.sub(r"([\w:<>]+?)<<<(.+?)>>>\((.*?)\);", r"emu::launch(\1, \2, \3);", text,
                  flags=re.S)


def build(csrc: Path, names, out: Path) -> dict[str, ctypes.CDLL]:
    """g++ each library of ``names`` (as ``ops/cuda_build.unit`` names them:
    ``mas``, or ``mqa_fwd_d128`` for a source at one tile width) for the
    emulation into ``out``; returns the loaded libraries."""
    src = out / "src"
    shutil.rmtree(src, ignore_errors=True)
    src.mkdir(parents=True)
    for f in list(csrc.glob("*.cuh")) + list(csrc.glob("*.cu")):
        (src / f.name).write_text(transform(f.read_text()))
    procs = []
    for name in names:
        so = out / f"lib{name}.so"
        source, defines = unit(name, csrc)
        cmd = ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", str(HERE), *defines,
               "-x", "c++", str(src / source.name), "-o", str(so)]
        procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"g++ failed for {name}:\n{log[:8000]}")
        libs[name] = ctypes.CDLL(str(so))
    return libs
