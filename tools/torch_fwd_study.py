#!/usr/bin/env python3
"""Studies of the port's tensor-core attention forward (K1 ``mqa_fwd``, K5a
``flash_fwd``) on one NVIDIA card, beside ``chip_smoke.py``'s gates.

    python3 tools/torch_fwd_study.py times [--variants NAME ...] [--parent DIR]
    python3 tools/torch_fwd_study.py gates [--seeds 5 6 8] [--variant NAME]
                                           [--parent DIR] [--scale-o X ...]

``times``: each variant of the forward tile core (one part of its
per-element work taken out, or the other bf16 launch bound; see VARIANTS)
built from a copy of ``csrc/`` and timed, K1 and K5a, at the decoder's bf16
training shape (B 32, N = M = 320, H 6, dropout 0.1 and 0; the smoke run's
batch's frame counts and random lengths) and at the serving decoder's f32
shape (B 4, N = M = 1024), as CUDA-graph device time beside one
``scaled_dot_product_attention`` call. A stub variant computes
wrong attention; it is timed, never used. ``--parent DIR`` adds the kernels
of another checkout's ``isp_tts_tpu_torch/csrc`` (e.g. a ``git archive`` of
the parent commit) as variant ``parent``.

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
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402

# (old, new) substitutions in attention_fwd.cuh
_ONE_TERM = [("for (int term = 1; term >= 0; --term) {",
              "for (int term = 0; term >= 0; --term) {")]
_NO_BIAS = [("const bool full = c0 + FWD_KEYS <= key_len && (lower || upper);",
             "const bool full = true;"),
            ("x = fmaf(s[j][2 * half + e], scale2, sl * dist);", "x = s[j][2 * half + e] * scale2;")]
_NO_EXP = [("x = fast_exp2(x - m_use);", "x = x - m_use;")]
_NO_HASH = [("if (drop) {  // the normaliser", "if (false) {  // the normaliser")]
#: name -> substitutions; the stubs compute wrong attention
VARIANTS = {
    "built": [],
    "one_term_p": _ONE_TERM,  # bf16 P.V with P rounded to bf16 (K1's TPU kernel)
    "no_bias_mask": _NO_BIAS,  # no ALiBi bias, no per-element length / causal compare
    "no_exp": _NO_EXP,  # the probabilities' exp2 left out
    "no_hash": _NO_HASH,  # the dropout hash left out
    "mma_only": _NO_BIAS + _NO_EXP + _NO_HASH,  # loads, MMAs, max and sums only
    # the other bf16 launch bound of each row geometry (exact arithmetic)
    "k1_4_blocks": [("kBf16Blocks = 3;", "kBf16Blocks = 4;")],
    "k5a_3_blocks": [("kBf16Blocks = 4;", "kBf16Blocks = 3;")],
}
FWD = ("mqa_fwd", "flash_fwd")


def variant_dir(name: str, work: Path, parent: Path | None) -> Path:
    """A copy of csrc/ (or the parent's) with the variant's substitutions,
    each made in every forward source that holds it."""
    from isp_tts_tpu_torch.ops import cuda_build

    d = work / name
    shutil.rmtree(d, ignore_errors=True)
    src = parent / "isp_tts_tpu_torch/csrc" if name == "parent" else cuda_build.CSRC
    shutil.copytree(src, d / "csrc")
    files = [d / "csrc" / f for f in ("attention_fwd.cuh", "mqa_fwd.cu", "flash_fwd.cu")]
    for old, new in [] if name == "parent" else VARIANTS[name]:
        hits = [f for f in files if old in f.read_text()]
        if not hits:
            raise SystemExit(f"variant {name}: {old!r} not in the forward sources")
        for f in hits:
            f.write_text(f.read_text().replace(old, new))
    return d


def use(d: Path) -> None:
    """Point the kernel loader at variant directory ``d``."""
    from isp_tts_tpu_torch.ops import cuda_build

    cuda_build.CSRC, cuda_build.BUILD_DIR = d / "csrc", d / "_build"
    cuda_build._LOADED.clear()
    cuda_build.BUILD_INFO.clear()


def build(dirs: list[Path], sources) -> None:
    """Every source of every directory, one nvcc each, all started together."""
    from isp_tts_tpu_torch.ops import cuda_build

    jobs = []
    for d in dirs:
        use(d)
        (d / "_build").mkdir(exist_ok=True)
        for name in sources:
            out = cuda_build.library_path(name)
            cmd = cuda_build.nvcc_command(cuda_build.CSRC / f"{name}.cu", out)
            jobs.append((d.name, name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True)))
    for variant, name, proc in jobs:
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed, {variant} {name}.cu:\n{log}")


def times(args, work: Path) -> None:
    import torch

    from isp_tts_tpu_torch.ops import flash_attention as fa
    from isp_tts_tpu_torch.serving import Synthesizer

    # the smoke run's training batch (noise seed 5): its frame counts
    synth = Synthesizer.from_pretrained(c.CKPT)
    frames = c.training_batch(synth, torch.Generator(device="cuda").manual_seed(5))[0]["mel_len"]
    del synth
    names = list(args.variants) + (["parent"] if args.parent else [])
    dirs = [variant_dir(n, work, args.parent) for n in names]
    t0 = time.perf_counter()
    build(dirs, FWD)
    print(f"[times] built {len(dirs)} variants in {time.perf_counter() - t0:.1f}s", flush=True)

    scale = 64 ** -0.5
    shapes = [("bf16 B=32 N=M=320 H=6, the batch's lengths", 32, 320, torch.bfloat16, (0.1,)),
              ("bf16 B=32 N=M=320 H=6, random lengths", 32, 320, torch.bfloat16, (0.1, 0.0)),
              ("f32 B=4 N=M=1024 H=6, random lengths", 4, 1024, torch.float32, (0.0,))]
    for label, B, N, dtype, rates in shapes:
        for kv_heads, fwd in ((None, "mqa_fwd"), (6, "flash_fwd")):
            gen = torch.Generator(device="cuda").manual_seed(11)
            q, k, v, sl, kl, ql = c.mqa_inputs(B, N, N, 6, dtype, True, gen, kv_heads=kv_heads)
            if "batch" in label:
                kl = ql = frames.contiguous()
            seed = c.seed_tensor(2024)
            lib = c.graph_ms(c.library_call(q, k, v, sl, kl, scale))
            row = []
            for d in dirs:
                use(d)
                fn = getattr(fa, fwd)
                for rate in rates:
                    ms = c.graph_ms(lambda: fn(q, k, v, sl, kl, scale, 0, ql, False, rate, seed))
                    row.append(f"{d.name}{'' if rate else ' rate 0'} {ms:.4f}")
            bound = c.attention_bound(q, k, kl, ql)
            kernel = "K1" if kv_heads is None else "K5a"
            print(f"[times] {kernel} {label}: " + ", ".join(row) + f"; SDPA {lib:.4f}; bound "
                  f"{bound[0]:.4f} ({bound[1]}) ms", flush=True)
            del q, k, v
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
        d = variant_dir("parent" if args.parent else args.variant, work, args.parent)
        build([d], c.SOURCES)
        use(d)
        print(f"[gates] kernels of {d.name}", flush=True)
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
    t = sub.add_parser("times")
    t.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
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
    with tempfile.TemporaryDirectory(prefix="fwd_study_") as tmp:
        (times if args.cmd == "times" else gates)(args, Path(tmp))
    return 0


if __name__ == "__main__":
    sys.exit(main())
