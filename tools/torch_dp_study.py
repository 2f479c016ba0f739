#!/usr/bin/env python3
"""Times of the aligner's DP kernels on one NVIDIA card: K3 (MAS,
``csrc/mas.cu``), K4's forward and K4's backward (banded CTC,
``csrc/ctc.cu``), each as CUDA-graph device time, beside
``F.ctc_loss`` and the bytes bound.

    python3 tools/torch_dp_study.py [--variants NAME ...] [--parent DIR]

Shapes: the training path's (B 32, M 320, T 48, the lengths of
``chip_smoke.py``'s training batch) and B 64, M 1024, T 192 (random
lengths). Each variant (VARIANTS) is built from a copy of ``csrc/`` and
timed in a process of its own (two libraries of the same kernels in one
process do not stay apart), in two rounds, the second in reverse order:
- ``built``: the kernels as they are;
- ``no_stage``: the map and the alphas from registers, no staging;
- ``no_stores``: no global store (K4's backward keeps its occupancies);
- ``floor``: both, the serial floor: the least the recurrence allows on
  this card (K3 keeps its choice bits and its walk);
- ``floor_bare``: the floor without the lse's f32 tails (K4) and without
  the walk (K3): the f64 (f32) max/add chain and the shuffles alone;
- ``precise_tails``: K4's f32 tails with ``exp2f``/``log2f`` in place of
  ``ex2.approx``/``lg2.approx``;
- ``no_barrier``: the rows over warps without their barrier a frame (the
  edge exchange races), the barrier's cost.
The stubs compute wrong results and are timed, never used. ``--parent DIR``
adds another checkout's kernels through that checkout's own wrappers (e.g.
``git archive HEAD isp_tts_tpu_torch | tar -x -C _scratch/parent``), as
variant ``parent``. Every variant but the stubs is checked (K3 equal to the
plain version, K4's loss and gradient errors against the f64 plain
version); ``F.ctc_loss`` is timed eagerly, and whether it can be captured
in a CUDA graph is tried once, at the end; nvcc's ptxas registers, stack
and spills are printed for each kernel.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402

SOURCES = ("mas", "ctc")
#: the package's sources (cuda_build.CSRC is pointed at each variant's copy)
CSRC = ROOT / "isp_tts_tpu_torch" / "csrc"
_K4_STAGE = [
    ("for (int s = 0; s < D - 1; ++s) stage.fetch();", ""),
    ("cp_async_wait<D - 2>();  // frame t has landed\n    stage.fetch();", ""),
    ("cp_async_wait<D - 2>();  // frame ml - 1 - n has landed\n    stage.fetch();", ""),
    ("static_cast<double>(slot[lane])", "__hiloint2double(0xc0000000 | (t & 7), 0)"),
    ("const double lp0 = slot[32 + lane];",
     "const double lp0 = __hiloint2double(0xbff00000 | (t & 7), 0);"),
    ("static_cast<double>(map[lane])", "__hiloint2double(0xc0000000 | (n & 7), 0)"),
    ("const double lp0 = map[32 + lane];",
     "const double lp0 = __hiloint2double(0xbff00000 | (n & 7), 0);"),
    ("static_cast<double>(map[64 + lane])", "__hiloint2double(0xc0000000 | (n & 3), 0)"),
    ("alpha[lane]", "__hiloint2double(0xc0080000 | (n & 7), 0)"),
    ("alpha[32 + lane]", "__hiloint2double(0xc00c0000 | (n & 7), 0)"),
]
_K4_STORES = [
    ("*pab = nb;  // alpha store", ""),
    ("*pal = nl;  // alpha store", ""),
    ("if (next) *grad = -gb * ol;  // gradient store", "if (ol == -1.f) *grad = ol;"),
    ("grad0[-static_cast<ptrdiff_t>(n - CHUNK + lane) * W] = -gb * s;  // gradient store",
     "if (s == -1.f) grad0[0] = s;"),
    ("grad0[-static_cast<ptrdiff_t>(n0 + lane) * W] = -gb * s;  // gradient store",
     "if (s == -1.f) grad0[0] = s;"),
    ("*zero = 0.f;  // rows past mel_len", ";"),
]
_K4_NO_TAILS = [("fast_exp2(", "("), ("fast_log2(", "(")]
_NO_BARRIER = [("      __syncthreads();\n      if (w > 0) edge", "      if (w > 0) edge"),
               ("      __syncthreads();\n      if (next_warp) {", "      if (next_warp) {")]
_K3_STAGE = [
    ("for (int s = 1; s < D; ++s) stage.fetch();", ""),
    ("cp_async_wait<D - 2>();  // row i has landed\n    stage.fetch();", ""),
    ("slot[k * 32 + lane] : NEG_INF;  // map read",
     "__int_as_float(0xbf800000 | ((i + k) & 7)) : NEG_INF;"),
]
_K3_STORES = [
    ("if (j0 + 32 * k < T) ob[static_cast<size_t>(i) * T + j0 + 32 * k] = 0.f;  // one-hot store",
     ""),
    ("if (j0 + 32 * k < T) orow[32 * k] = pj == 32 * k ? 1.f : 0.f;  // one-hot store",
     "if (pj == -7) orow[32 * k] = 1.f;"),
]
_K3_NO_WALK = [("col = max(col - static_cast<int>(bit), 0);",
                "col = max(col - static_cast<int>(bit & 0u), 0);")]
#: name -> {source: substitutions}; the stubs (no_stage, no_stores, floor,
#: floor_bare) compute wrong results
VARIANTS = {
    "built": {},
    "no_stage": {"ctc": _K4_STAGE, "mas": _K3_STAGE},
    "no_stores": {"ctc": _K4_STORES, "mas": _K3_STORES},
    "floor": {"ctc": _K4_STAGE + _K4_STORES, "mas": _K3_STAGE + _K3_STORES},
    "floor_bare": {"ctc": _K4_STAGE + _K4_STORES + _K4_NO_TAILS,
                   "mas": _K3_STAGE + _K3_STORES + _K3_NO_WALK},
    "precise_tails": {"ctc": [("fast_exp2(", "exp2f("), ("fast_log2(", "log2f(")]},
    "no_barrier": {"ctc": _NO_BARRIER, "mas": _NO_BARRIER[:1]},
}
STUBS = ("no_stage", "no_stores", "floor", "floor_bare", "no_barrier")
SHAPES = [("B=32 M=320 T=48, the training batch's lengths", 32, 320, 48),
          ("B=64 M=1024 T=192, random lengths", 64, 1024, 192)]


class Variant:
    """A set of kernels: a copy of ``csrc/`` with its substitutions made (or
    another checkout's), and the wrapper modules that launch them."""

    def __init__(self, name: str, work: Path, parent: Path | None):
        from isp_tts_tpu_torch.ops import ctc, cuda_build, mas

        self.name, self.dir = name, work / name
        self.ctc, self.mas, self.build_mod = ctc, mas, cuda_build
        if name == "parent":
            self.ctc, self.mas, self.build_mod = parent_modules(parent)
            self.sources = SOURCES
            if not self.dir.exists():
                shutil.copytree(parent / "isp_tts_tpu_torch/csrc", self.dir / "csrc")
        elif not self.dir.exists():
            subs = VARIANTS[name]
            shutil.copytree(CSRC, self.dir / "csrc")
            for source, pairs in subs.items():
                f = self.dir / "csrc" / f"{source}.cu"
                text = f.read_text()
                for old, new in pairs:
                    if old not in text:
                        raise SystemExit(f"variant {name}: {old!r} not in {source}.cu")
                    text = text.replace(old, new)
                f.write_text(text)
        if name != "parent":
            self.sources = tuple(VARIANTS[name]) or SOURCES
        self.use()

    def use(self):
        """Point the wrapper modules' loader at this variant's kernels."""
        self.build_mod.CSRC, self.build_mod.BUILD_DIR = self.dir / "csrc", self.dir / "_build"
        self.build_mod._LOADED.clear()
        self.build_mod.BUILD_INFO.clear()


def parent_modules(parent: Path):
    """Another checkout's ``ops.ctc``, ``ops.mas`` and ``ops.cuda_build``,
    imported as package ``parent_port``."""
    name = "parent_port"
    if name not in sys.modules:
        pkg = parent / "isp_tts_tpu_torch"
        spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                      submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.ops.{m}") for m in ("ctc", "mas", "cuda_build"))


def kernel_name(mangled: str) -> str:
    """'name<a, b>' for a kernel template's mangled name (integer arguments)."""
    m = re.search(r"([A-Za-z_]+_kernel)I((?:Li\d+E)+)E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{', '.join(re.findall(r'Li(\d+)E', m.group(2)))}>"


def ptxas_lines(log: str) -> list[str]:
    """'kernel<C=n> registers R, stack S, spills st/ld' for each kernel in
    an nvcc -Xptxas -v log."""
    out, fn, extra = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = kernel_name(ln.split("'")[1])
        elif "stack frame" in ln and fn is not None:
            w = ln.replace(",", "").split()
            extra = f"stack {w[w.index('stack') - 2]}, spills {w[w.index('spill') - 2]}/" \
                    f"{w[w.index('loads') - 3]}"
        elif "Used" in ln and "registers" in ln and fn is not None:
            w = ln.replace(",", "").split()
            out.append(f"{fn} registers {w[w.index('registers') - 1]}, {extra}")
    return out


def build(variants: list[Variant]) -> None:
    """Every source of every variant, one nvcc each, all started together;
    prints ptxas's registers, stack and spills per kernel of ``built`` and
    ``parent``."""
    jobs = []
    for v in variants:
        v.use()
        v.build_mod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in v.sources:
            cmd = v.build_mod.nvcc_command(v.build_mod.CSRC / f"{name}.cu",
                                           v.build_mod.library_path(name))
            jobs.append((v.name, name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True)))
    for variant, name, proc in jobs:
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed, {variant} {name}.cu:\n{log}")
        if variant in ("built", "parent"):
            print(f"[dp] {variant} {name}.cu ptxas: " + "; ".join(ptxas_lines(log)), flush=True)


def ctc_loss_call(lp, tl, ml, backward: bool):
    """One ``F.ctc_loss`` call (and its backward) on K4's inputs."""
    import torch
    import torch.nn.functional as F

    B, _, W = lp.shape
    x = lp.detach().requires_grad_(backward)
    labels = torch.arange(1, W, device="cuda").repeat(B, 1)

    def call():
        loss = F.ctc_loss(x.transpose(0, 1), labels, ml.long(), tl.long(), blank=0,
                          reduction="sum", zero_infinity=True)
        if backward:
            torch.autograd.grad(loss, x)
    return call


def ctc_loss_captures(lp, tl, ml) -> str:
    """Whether ``F.ctc_loss`` can be captured in a CUDA graph (tried once, at
    the end of the run: a failed capture may leave the stream unusable)."""
    try:
        c.graph_ms(ctc_loss_call(lp, tl, ml, backward=True), iters=2, replays=1)
    except RuntimeError as err:
        return f"no: {str(err).splitlines()[0][:120]}"
    return "yes"


def inputs(shape, lengths):
    """The shape's inputs (K3's map, K4's map, text and mel lengths, K4's
    output gradient), made from seeds, so every process has the same; at
    the training shape the training batch's lengths."""
    import torch

    _, B, M, T = shape
    gen = torch.Generator(device="cuda").manual_seed(11 + B)
    la, tl, ml = c.mas_inputs(B, M, T, gen)
    lp, _, _ = c.ctc_inputs(B, M, T, gen)
    if B == lengths[0].shape[0]:
        tl, ml = (x.cuda().contiguous() for x in lengths)
    return la, lp, tl, ml, torch.rand((B,), generator=gen, device="cuda")


def clocks() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def worker(args) -> None:
    """One variant's times (and, but for the stubs, its errors) at every
    shape, printed as one JSON line."""
    import torch

    v = Variant(args.worker, args.work, args.parent)
    lengths = torch.load(args.work / "lengths.pt")
    out = {}
    for shape in SHAPES:
        la, lp, tl, ml, g = inputs(shape, lengths)
        r = {}
        if "mas" in v.sources:
            got = v.mas.monotonic_alignment_search(la, tl, ml)
            if v.name not in STUBS:
                ref = v.mas.monotonic_alignment_search_reference(la, tl, ml)
                r["K3 equal"] = torch.equal(got, ref)
            r["K3"] = c.graph_ms(lambda: v.mas.monotonic_alignment_search(la, tl, ml))
        if "ctc" in v.sources:
            neg, ab, al, logz = v.ctc.ctc_fwd(lp, tl, ml)
            dlp = v.ctc.ctc_bwd(lp, ab, al, logz, g, tl, ml)
            if v.name not in STUBS:
                ref = c.k4_pair(lp, tl, ml, g, plain=True)
                r["K4 errors"] = [c.rel_err(neg, ref[0]), c.rel_err(dlp, ref[1])]
            r["K4 fwd"] = c.graph_ms(lambda: v.ctc.ctc_fwd(lp, tl, ml))
            r["K4 bwd"] = c.graph_ms(lambda: v.ctc.ctc_bwd(lp, ab, al, logz, g, tl, ml))
        out[shape[0]] = r
    out["clocks"] = clocks()
    print(json.dumps(out), flush=True)


def times(args, work: Path) -> None:
    import torch

    from isp_tts_tpu_torch.serving import Synthesizer

    smi = c.phase_env(time.perf_counter())
    synth = Synthesizer.from_pretrained(c.CKPT)
    batch = c.training_batch(synth, torch.Generator(device="cuda").manual_seed(5))[0]
    del synth
    lengths = (batch["text_vector_len"].cpu(), batch["mel_len"].cpu())
    torch.save(lengths, work / "lengths.pt")
    names = list(args.variants) + (["parent"] if args.parent else [])
    variants = [Variant(n, work, args.parent) for n in names]
    t0 = time.perf_counter()
    build(variants)
    print(f"[dp] built {len(variants)} variants in {time.perf_counter() - t0:.1f}s", flush=True)
    results = {n: [] for n in names}
    for name in names + names[::-1]:
        cmd = [sys.executable, __file__, "--worker", name, "--work", str(work)]
        if args.parent:
            cmd += ["--parent", str(args.parent)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise SystemExit(f"worker {name} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        results[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"[dp] {name}: clocks.sm, clocks.max.sm, power.draw after its timings: "
              f"{results[name][-1]['clocks']}", flush=True)

    for shape in SHAPES:
        la, lp, tl, ml, _ = inputs(shape, lengths)
        bounds = {"K3": c.mas_bound(la, tl, ml), "K4 fwd": c.ctc_fwd_bound(lp, tl, ml),
                  "K4 bwd": c.ctc_bwd_bound(lp, tl, ml)}
        libs = {"K4 fwd": c.cuda_ms(ctc_loss_call(lp, tl, ml, backward=False)),
                "K4 bwd": c.cuda_ms(ctc_loss_call(lp, tl, ml, backward=True))}
        for kernel, bound in bounds.items():
            row = [f"{n} {r[0][shape[0]][kernel]:.4f} / {r[1][shape[0]][kernel]:.4f}"
                   for n, r in results.items() if kernel in r[0][shape[0]]]
            lib = libs.get(kernel)
            print(f"[dp] {kernel} {shape[0]} (ms, round 1 / round 2): " + ", ".join(row)
                  + ("" if lib is None else f"; F.ctc_loss{' fwd + bwd' if 'bwd' in kernel else ''}"
                     f" {lib:.4f} (eager)") + f"; bound {bound[0]:.4f} ({bound[1]})", flush=True)
        checks = [f"{n} K3 equal {r[0][shape[0]].get('K3 equal')}, K4 loss/gradient errors "
                  + "/".join(f"{e:.2e}" for e in r[0][shape[0]].get("K4 errors", []))
                  for n, r in results.items() if n not in STUBS]
        print(f"[dp] checks {shape[0]}: " + "; ".join(checks), flush=True)
        last = lp, tl, ml
    print(f"[dp] F.ctc_loss captures in a CUDA graph: {ctc_loss_captures(*last)}", flush=True)
    print(f"[dp] {smi}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--work", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_dp_study: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.worker:
        worker(args)
        return 0
    with tempfile.TemporaryDirectory(prefix="dp_study_") as tmp:
        times(args, Path(tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
