#!/usr/bin/env python3
"""Studies of the port's tensor-core attention kernels on one NVIDIA card:
the forwards (K1 ``mqa_fwd``, K5a ``flash_fwd``) and the backwards (K2
``mqa_bwd``, K5b ``flash_bwd``), beside ``chip_smoke.py``'s gates.

    python3 tools/torch_fwd_study.py times [--variants NAME ...] [--parent DIR]
    python3 tools/torch_fwd_study.py gates [--seeds 5 6 8] [--variant NAME]
                                           [--parent DIR] [--scale-o X ...]

``times``: each variant of a tile core (one part of its per-element work
taken out, the other bf16 launch bound, or a fixed count of row splits of
the backward's dk/dv pass; see VARIANTS and SPLITS) built from a copy of
``csrc/`` and timed as CUDA-graph device time beside the library call:
- the forwards K1 and K5a at the decoder's bf16 training shape (B 32,
  N = M = 320, H 6, dropout 0.1 and 0; the smoke run's batch's frame
  counts and random lengths) and at the serving decoder's f32 shape (B 4,
  N = M = 1024), beside one ``scaled_dot_product_attention`` call;
- the backwards K2 and K5b (6 and 1 key/value heads) at the decoder's bf16
  training shape with the batch's lengths and dropout 0.1, and at B 2,
  N = M = 3072 in f32 with random lengths, from the plain forward's o and
  lse, beside SDPA's autograd backward (``chip_smoke.library_bwd_ms``).
A stub variant computes wrong attention; it is timed, never used. ``--parent
DIR`` adds another checkout's kernels (e.g. a ``git archive`` of the parent
commit) through that checkout's own wrappers, as variant ``parent``.

``gates``: the smoke run's two noise-bound training gates on training
batches synthesized with the noise seeds given (the smoke run uses 5): the
bf16 step, kernel path against plain path, on the f32 plain step's MAS
alignment, one draw and the sums of the first k draws (the gate sums
``BF16_DRAWS``); and the multi-KV-head ``to_kv`` gradient
check with and without its K/V pin (the gate pins). ``--scale-o X`` also
reads the bf16 gate with every bf16 forward output of the kernel path
scaled by 1 + X, a fault of known size. ``--variant`` / ``--parent`` run
the gates on those kernels instead.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402

FWD = ("mqa_fwd", "flash_fwd")
BWD = ("mqa_bwd", "flash_bwd")
KERNELS = ("mqa_fwd", "flash_fwd", "mqa_bwd", "flash_bwd")

# (old, new) substitutions, each made in every listed file that holds it
_F_NO_BIAS = [("const bool full = c0 + ATT_KEYS <= key_len && (lower || upper);",
               "const bool full = true;"),
              ("x = fmaf(s[j][2 * half + e], scale2, sl * dist);",
               "x = s[j][2 * half + e] * scale2;")]
_F_NO_EXP = [("x = fast_exp2(x - m_use);", "x = x - m_use;")]
_F_NO_HASH = [("if (drop) {  // the normaliser", "if (false) {  // the normaliser")]
_B_NO_BIAS = _F_NO_BIAS + [
    ("const bool full = cw + 16 <= key_len && n0 + PART <= q_len && (lower || upper);",
     "const bool full = true;")]
_B_NO_EXP = [("const float pr = fast_exp2(x - r.lse2);", "const float pr = x - r.lse2;"),
             ("const float pr = fast_exp2(x - lse2);", "const float pr = x - lse2;")]
_B_NO_HASH = [("if (drop) {  // dropped probabilities carry no gradient",
               "if (false) {  // dropped probabilities carry no gradient")]
_FWD_CORE = ("attention_fwd.cuh",)
_BWD_CORE = ("attention_bwd.cuh",)
_ROWS = ("attention_common.cuh",)
#: name -> (sources it changes, files, substitutions); the stubs compute
#: wrong attention
VARIANTS = {
    "built": (KERNELS, (), []),
    # forward
    "one_term_p": (FWD, _FWD_CORE, [("FWD_P_TERMS = 2;", "FWD_P_TERMS = 1;")]),  # K1's TPU P
    "no_bias_mask": (FWD, _FWD_CORE, _F_NO_BIAS),  # no ALiBi bias, no length/causal compare
    "no_exp": (FWD, _FWD_CORE, _F_NO_EXP),  # the probabilities' exp2 left out
    "no_hash": (FWD, _FWD_CORE, _F_NO_HASH),  # the dropout hash left out
    "mma_only": (FWD, _FWD_CORE, _F_NO_BIAS + _F_NO_EXP + _F_NO_HASH),
    "k1_4_blocks": (FWD, _ROWS, [("kBf16Blocks = 3;", "kBf16Blocks = 4;")]),
    "k5a_3_blocks": (FWD, _ROWS, [("kBf16Blocks = 4;", "kBf16Blocks = 3;")]),
    # backward
    "bwd_one_term": (BWD, _BWD_CORE, [("BWD_TERMS = 2;", "BWD_TERMS = 1;")]),  # K2's TPU p, ds
    "bwd_no_bias_mask": (BWD, _BWD_CORE, _B_NO_BIAS),
    "bwd_no_hash": (BWD, _BWD_CORE, _B_NO_HASH),
    "bwd_mma_only": (BWD, _BWD_CORE, _B_NO_BIAS + _B_NO_EXP + _B_NO_HASH),
    "bwd_3_blocks": (BWD, _BWD_CORE, [("BWD_BF16_BLOCKS = 2;", "BWD_BF16_BLOCKS = 3;")]),
}
#: the built kernels with the dk/dv pass's row splits fixed (variant "splits_N")
SPLITS = (1, 2, 4, 8)


class Variant:
    """A set of kernels to time: a directory with a copy of ``csrc/`` (and
    the sources it builds), and the wrapper module that launches them."""

    def __init__(self, name: str, work: Path, parent: Path | None):
        from isp_tts_tpu_torch.ops import cuda_build
        from isp_tts_tpu_torch.ops import flash_attention as fa

        self.name, self.splits = name, None
        if name.startswith("splits_"):
            self.splits, name = int(name.split("_")[1]), "built"
        self.dir = work / name
        self.ops, self.build_mod = fa, cuda_build
        if name == "parent":
            self.ops, self.build_mod = parent_modules(parent)
            self.sources = KERNELS
            if not self.dir.exists():
                shutil.copytree(parent / "isp_tts_tpu_torch/csrc", self.dir / "csrc")
            self.build_mod.CSRC, self.build_mod.BUILD_DIR = self.dir / "csrc", self.dir / "_build"
            return
        self.sources, files, subs = VARIANTS[name]
        if self.dir.exists():  # a splits variant shares the built kernels
            return
        shutil.copytree(cuda_build.CSRC, self.dir / "csrc")
        for old, new in subs:
            hits = [self.dir / "csrc" / f for f in files if old in (self.dir / "csrc" / f).read_text()]
            if not hits:
                raise SystemExit(f"variant {name}: {old!r} not in {files}")
            for f in hits:
                f.write_text(f.read_text().replace(old, new))

    def use(self):
        """Point the wrapper module's loader at this variant's kernels."""
        if self.name != "parent":
            self.build_mod.CSRC, self.build_mod.BUILD_DIR = self.dir / "csrc", self.dir / "_build"
            self.build_mod._LOADED.clear()
            self.build_mod.BUILD_INFO.clear()

    def fn(self, kernel: str):
        """The wrapper of ``kernel``, with this variant's split count."""
        self.use()
        f = getattr(self.ops, kernel)
        if self.splits is None:
            return f
        n = self.splits

        def call(*a):
            saved = self.ops._dkv_splits
            self.ops._dkv_splits = lambda tiles: min(n, tiles)
            try:
                return f(*a)
            finally:
                self.ops._dkv_splits = saved
        return call


def parent_modules(parent: Path):
    """Another checkout's ``isp_tts_tpu_torch.ops.flash_attention`` and
    ``cuda_build``, imported as package ``parent_port``."""
    name = "parent_port"
    if name not in sys.modules:
        pkg = parent / "isp_tts_tpu_torch"
        spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                      submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return (importlib.import_module(name + ".ops.flash_attention"),
            importlib.import_module(name + ".ops.cuda_build"))


def build(variants: list[Variant], wanted) -> None:
    """Every wanted source of every variant, one nvcc each, all started
    together (a splits variant shares the built kernels)."""
    jobs, seen = [], set()
    for v in variants:
        if v.dir in seen:
            continue
        seen.add(v.dir)
        v.use()
        v.build_mod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for name in v.sources:
            if name not in wanted:
                continue
            if v.name == "parent" and not hasattr(v.build_mod, "unit"):
                # a checkout from before the tile widths: one library a source
                out = v.build_mod.library_path(name)
                cmd = v.build_mod.nvcc_command(v.build_mod.CSRC / f"{name}.cu", out)
            else:  # the head dim 64 libraries, which these shapes launch
                lib = f"{name}_d64"
                out = v.build_mod.library_path(lib)
                cmd = v.build_mod.nvcc_command(*v.build_mod.unit(lib)[:1], out,
                                               v.build_mod.unit(lib)[1])
            jobs.append((v.name, name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True)))
    for variant, name, proc in jobs:
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed, {variant} {name}.cu:\n{log}")
        if variant in ("built", "parent") or "blocks" in variant:
            usage = c.ptxas_usage(log)
            print(f"[times] {variant} {name}.cu ptxas registers / spill store / spill load "
                  "bytes: " + "; ".join(f"{c.kernel_label(k)} {u[0]}/{u[1]}/{u[2]}"
                                        for k, u in sorted(usage.items())), flush=True)


def times(args, work: Path) -> None:
    import torch

    from isp_tts_tpu_torch.ops import flash_attention as fa
    from isp_tts_tpu_torch.serving import Synthesizer

    c.phase_env(time.perf_counter())
    # the smoke run's training batch (noise seed 5): its frame counts
    synth = Synthesizer.from_pretrained(c.CKPT)
    frames = c.training_batch(synth, torch.Generator(device="cuda").manual_seed(5))[0]["mel_len"]
    frames = frames.contiguous()
    del synth
    names = list(args.variants) + (["parent"] if args.parent else [])
    variants = [Variant(n, work, args.parent) for n in names]
    t0 = time.perf_counter()
    build(variants, set(KERNELS))
    print(f"[times] built {len(variants)} variants in {time.perf_counter() - t0:.1f}s", flush=True)
    scale = 64 ** -0.5

    fwd = [v for v in variants if v.splits is None and set(FWD) & set(v.sources)]
    shapes = [("bf16 B=32 N=M=320 H=6, the batch's lengths", 32, 320, torch.bfloat16, (0.1,)),
              ("bf16 B=32 N=M=320 H=6, random lengths", 32, 320, torch.bfloat16, (0.1, 0.0)),
              ("f32 B=4 N=M=1024 H=6, random lengths", 4, 1024, torch.float32, (0.0,))]
    for label, B, N, dtype, rates in shapes if fwd else ():
        for kv_heads, kernel in ((None, "mqa_fwd"), (6, "flash_fwd")):
            gen = torch.Generator(device="cuda").manual_seed(11)
            q, k, v, sl, kl, ql = c.mqa_inputs(B, N, N, 6, dtype, True, gen, kv_heads=kv_heads)
            if "batch" in label:
                kl = ql = frames
            seed = c.seed_tensor(2024)
            lib = c.graph_ms(c.library_call(q, k, v, sl, kl, scale))
            row = []
            for var in fwd:
                f = var.fn(kernel)
                for rate in rates:
                    ms = c.graph_ms(lambda: f(q, k, v, sl, kl, scale, 0, ql, False, rate, seed))
                    row.append(f"{var.name}{'' if rate else ' rate 0'} {ms:.4f}")
            bound = c.attention_bound(q, k, kl, ql)
            name = "K1" if kv_heads is None else "K5a"
            print(f"[times] {name} {label}: " + ", ".join(row) + f"; SDPA {lib:.4f}; bound "
                  f"{bound[0]:.4f} ({bound[1]}) ms", flush=True)
            del q, k, v
            torch.cuda.empty_cache()

    bwd = [v for v in variants if set(BWD) & set(v.sources)]
    shapes = [("bf16 B=32 N=M=320 H=6 dropout 0.1, the batch's lengths", 32, 320,
               torch.bfloat16, (None, 6, 1)),
              ("f32 B=2 N=M=3072 H=6 dropout 0.1, random lengths", 2, 3072, torch.float32,
               (None, 6))]
    for label, B, N, dtype, kv in shapes if bwd else ():
        for kv_heads in kv:
            kernel, plain = (("mqa_bwd", fa.mqa_attention_reference) if kv_heads is None
                             else ("flash_bwd", fa.flash_attention_reference))
            gen = torch.Generator(device="cuda").manual_seed(12)
            q, k, v, sl, kl, ql = c.mqa_inputs(B, N, N, 6, dtype, True, gen, kv_heads=kv_heads)
            if "batch" in label:
                kl = ql = frames
            seed, rate = c.seed_tensor(2025), 0.1
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            o, lse = plain(q, k, v, sl, kl, scale, 0, ql, False, rate, seed)
            lib = c.library_bwd_ms(q, k, v, sl, kl, scale, 0, False, do,
                                   iters=10 if N <= 1024 else 3)
            row = []
            for var in bwd:
                f = var.fn(kernel)
                ms = c.graph_ms(lambda: f(q, k, v, sl, kl, ql, seed, o, lse, do, scale, 0,
                                          False, rate), iters=10 if N <= 1024 else 3)
                row.append(f"{var.name} {ms:.4f}")
            bound = c.attention_bound(q, k, kl, ql, backward=True)
            name = "K2" if kv_heads is None else f"K5b Hkv={kv_heads}"
            print(f"[times] {name} {label}: " + ", ".join(row) + f"; SDPA backward {lib:.4f}; "
                  f"bound {bound[0]:.4f} ({bound[1]}) ms", flush=True)
            del q, k, v, o, lse, do
            torch.cuda.empty_cache()


def scaled(fn, factor):
    """``fn`` with its bf16 outputs scaled by ``factor``."""
    import torch

    def call(q, *a):
        o, lse = fn(q, *a)
        return ((o.float() * factor).to(o.dtype) if o.dtype == torch.bfloat16 else o), lse
    call.launches = 0
    return call


def gates(args, work: Path) -> None:
    import torch

    from isp_tts_tpu_torch.ops import flash_attention as fa
    from isp_tts_tpu_torch.serving import Synthesizer

    t0 = time.perf_counter()
    c.phase_env(t0)
    if args.variant != "built" or args.parent:
        var = Variant("parent" if args.parent else args.variant, work, args.parent)
        build([var], set(KERNELS) & set(var.sources))
        if var.name == "parent":  # its own wrappers: the C signatures may differ
            for name in KERNELS:
                setattr(fa, name, getattr(var.ops, name))
        else:
            var.use()
        print(f"[gates] kernels of {var.name}", flush=True)
    else:
        c.phase_build(t0)
    synth = Synthesizer.from_pretrained(c.CKPT)
    from isp_tts_tpu_torch.checkpoint import load_checkpoint

    experiment = load_checkpoint(c.CKPT)["experiment"]["config"]
    batches = {}
    for seed in args.seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        batches[seed] = c.training_batch(synth, gen)[0]
    del synth

    def bf16_line(tag, e, ctl=None):
        worst = max(e["module"], key=e["module"].get)
        print(f"[gates] {tag}: module max {worst} {e['module'][worst]:.3e}, cosine "
              f"{e['cosine']:.6f}, loss max {max(e['loss'].values()):.2e}, norm "
              f"{e['norm']:.2e}, durations differ {e['durations']}, misses {c.bf16_misses(e)}"
              + ("" if ctl is None else f"; control module max {max(ctl['module'].values()):.3e}"
                 f" cosine {ctl['cosine']:.6f}"), flush=True)

    for seed, batch in batches.items():
        for mha in (False, True):
            r = c.bf16_step_readings(experiment, batch, mha, draws=max(args.draws))
            model = "H-KV" if mha else "1-KV"
            for k in args.draws:
                bf16_line(f"seed {seed} {model} bf16 {k} draw(s) summed", r["bf16_sums"][k - 1],
                          r["control"] if k == 1 else None)
            torch.cuda.empty_cache()
        for pin in (False, True):
            kv = c.kv_grad_errors(experiment, batch, pin=pin)
            worst = max(kv[0], key=kv[0].get)
            print(f"[gates] seed {seed} to_kv {'pinned' if pin else 'unpinned'}: {kv[0][worst]:.3e}"
                  f" ({worst}), other max {max(kv[1].values()):.3e}, durations differ {kv[3]}",
                  flush=True)
        torch.cuda.empty_cache()
    saved = fa.mqa_fwd, fa.flash_fwd
    for x in args.scale_o:
        fa.mqa_fwd, fa.flash_fwd = scaled(saved[0], 1 + x), scaled(saved[1], 1 + x)
        seed = args.seeds[0]
        for mha in (False, True):
            r = c.bf16_step_readings(experiment, batches[seed], mha, draws=max(args.draws))
            model = "H-KV" if mha else "1-KV"
            for k in args.draws:
                bf16_line(f"seed {seed} {model} bf16 o x (1 + {x}) {k} draw(s) summed",
                          r["bf16_sums"][k - 1])
        fa.mqa_fwd, fa.flash_fwd = saved
    print(f"[gates] {time.perf_counter() - t0:.1f}s", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    names = list(VARIANTS) + [f"splits_{n}" for n in SPLITS]
    t = sub.add_parser("times")
    t.add_argument("--variants", nargs="+", default=names, choices=names)
    t.add_argument("--parent", type=Path)
    g = sub.add_parser("gates")
    g.add_argument("--seeds", nargs="+", type=int, default=[5, 6, 8])
    g.add_argument("--variant", default="built", choices=list(VARIANTS))
    g.add_argument("--parent", type=Path)
    g.add_argument("--scale-o", nargs="*", type=float, default=[])
    g.add_argument("--draws", nargs="+", type=int, default=[1, c.BF16_DRAWS],
                   help="bf16 readings of the sum of the first k draws, for each k")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_fwd_study: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="attention_study_") as tmp:
        (times if args.cmd == "times" else gates)(args, Path(tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
