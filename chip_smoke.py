#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``isp_tts_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one flushed line with its seconds, so a cut run shows
how far it got:

1. env    - Python, torch and CUDA versions; the card's name and power limit
            as ``nvidia-smi`` gives them.
2. build  - compiles every kernel of the serving path from ``csrc/`` with nvcc.
3. kernel - holds kernel K1 (folded-MQA attention forward) against its plain
            version on the card at the serving path's shapes, f32 and bf16,
            and times it beside the plain version and one PyTorch call.
4. slice  - ``Synthesizer.from_pretrained`` on the committed 23M-parameter
            checkpoint, three sentences one at a time and then as one batch,
            with the launch counts zeroed just before and read just after;
            then the same model on the plain attention with the same noise
            and durations, held against the kernel path's mel.
5. profile - one sentence and the batch under torch.profiler: device busy
            time against wall time, and the kernels that take it.

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "docs/assets/scale_r5/acoustic_scratch10k_r5.f16.ckpt"
SENTENCES = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It is easy to tell the depth of a well.",
]
# K1 against its plain version, unit-scale inputs: f32 differs only in the
# order of f32 sums; bf16 outputs are rounded to bf16 (8 bits of mantissa)
F32_BOUND = 1e-4
BF16_BOUND = 2e-2
# the whole model on K1 against the same model on the plain einsum attention,
# f32, same noise and durations: 25 attention calls whose outputs differ by
# ~1e-6 pass through 16 residual layers and to_mel
MEL_BOUND = 1e-3
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) and
# bf16 dense tensor operations/s
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}


def say(phase: str, t0: float, text: str = "") -> None:
    print(f"[{phase}] {time.perf_counter() - t0:.2f}s {text}".rstrip(), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back runs."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mqa_inputs(B, N, M, H, dtype, symmetric, gen):
    """Unit-scale q/k/v, trained-like ALiBi slopes and ragged lengths."""
    import torch

    from isp_tts_tpu_torch.nn.embeddings import alibi_slopes

    dev = "cuda"
    q = torch.randn((B, N, H, 64), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, M, 64), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, M, 64), generator=gen, device=dev).to(dtype)
    sl = torch.tensor(alibi_slopes(H), device=dev)
    sl = sl * (0.5 + torch.rand((H,), generator=gen, device=dev))
    hi = sl if symmetric else sl * (0.5 + torch.rand((H,), generator=gen, device=dev))
    slopes = torch.stack([sl, hi]).contiguous()
    key_lens = torch.randint(M // 2, M + 1, (B,), generator=gen, device=dev,
                             dtype=torch.int32)
    q_lens = torch.randint(N // 2, N + 1, (B,), generator=gen, device=dev,
                           dtype=torch.int32)
    key_lens[0] = M  # one full row
    return q, k, v, slopes, key_lens, q_lens


def mqa_bound(q, k, key_lens, q_lens, causal=False, offset=0):
    """(ms, 'bytes' | 'operations'): the least time for K1's work on these
    inputs — each input read once, each output written once; 4*D operations
    per (live query row, valid key) pair."""
    B, N, H, D = q.shape
    es = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * es + 4 * B * N * H + 8 * H + 8 * B
    pairs = 0
    for ql, kl in zip(q_lens.tolist(), key_lens.tolist()):
        if causal:
            pairs += sum(max(0, min(kl, n + offset + 1)) for n in range(ql))
        else:
            pairs += ql * kl
    ops = 4 * D * H * pairs
    peak = PEAK_OPS_S[str(q.dtype).replace("torch.", "")]
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def library_call(q, k, v, slopes, key_lens, scale, offset=0, causal=False):
    """One PyTorch call for the same function, the bias and mask built
    beforehand: scaled_dot_product_attention with an additive ALiBi + mask."""
    import torch
    import torch.nn.functional as F

    B, N, H, D = q.shape
    M = k.shape[1]
    n = torch.arange(N, device=q.device)[:, None]
    c = torch.arange(M, device=q.device)[None, :]
    dist = -(c - n - offset).abs().float()
    lower = c <= n + offset
    bias = torch.where(lower[None], slopes[0][:, None, None] * dist,
                       slopes[1][:, None, None] * dist)  # (H, N, M)
    valid = c[None] < key_lens[:, None, None]
    if causal:
        valid = valid & lower[None]
    bias = bias[None].masked_fill(~valid[:, None], float("-inf")).to(q.dtype)
    qh = q.transpose(1, 2)
    kh = k[:, None].expand(B, H, M, D).contiguous()
    vh = v[:, None].expand(B, H, M, D).contiguous()
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias,
                                                  scale=scale)


def phase_env(t0):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    # f32 stays f32: no TF32 in matrix products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("env", t0, f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    print(smi.splitlines()[0], flush=True)
    return smi.splitlines()[0]


def phase_build(t0):
    from isp_tts_tpu_torch.ops import cuda_build

    cuda_build.load("mqa_fwd")
    info = cuda_build.BUILD_INFO["mqa_fwd"]
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    say("build", t0, f"mqa_fwd.cu nvcc {info['seconds']:.2f}s; " + " | ".join(regs))


KERNEL_CASES = (  # B, N, M, H, dtype, symmetric, offset, causal
    [(B, N, N, H, "float32", True, 0, False)
     for H in (6, 4) for N in (128, 1024, 2048) for B in (1, 4)]
    + [(4, N, N, H, "bfloat16", True, 0, False) for H in (6, 4) for N in (128, 2048)]
    + [(2, 1024, 1024, 6, "float32", False, 0, False),  # asymmetric ALiBi
       (2, 96, 224, 6, "float32", False, 128, False),  # offset != 0
       (2, 1024, 1024, 4, "float32", True, 0, True)]  # causal
)


def check_mqa(q, k, v, slopes, key_lens, q_lens, offset=0, causal=False):
    """K1 against its plain version: (max |o err|, bound)."""
    import torch

    from isp_tts_tpu_torch.ops.flash_attention import mqa_attention_reference, mqa_fwd

    scale = 64 ** -0.5
    o, lse = mqa_fwd(q, k, v, slopes, key_lens, scale, offset, q_lens, causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = mqa_attention_reference(q, k, v, slopes, key_lens, scale, offset,
                                             q_lens, causal)
    err = (o.float() - o_ref.float()).abs().max().item()
    bound = F32_BOUND if q.dtype == torch.float32 else BF16_BOUND
    live = torch.isfinite(lse_ref)
    lse_err = (lse[live] - lse_ref[live]).abs().max().item()
    if not (torch.isfinite(lse) == live).all():
        raise AssertionError("K1 lse marks other rows dead than the plain version")
    if not (err <= bound and lse_err <= bound * (1 + lse_ref[live].abs().max().item())):
        raise AssertionError(f"K1 disagrees with its plain version: o err {err:.3e}, "
                             f"lse err {lse_err:.3e}, bound {bound:.0e}")
    return err, lse_err, bound


def phase_kernel(t0):
    import torch

    from isp_tts_tpu_torch.ops.flash_attention import mqa_fwd

    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, N, M, H, dt, sym, offset, causal in KERNEL_CASES:
        dtype = getattr(torch, dt)
        q, k, v, slopes, key_lens, q_lens = mqa_inputs(B, N, M, H, dtype, sym, gen)
        err, lse_err, bound = check_mqa(q, k, v, slopes, key_lens, q_lens, offset, causal)
        scale = 64 ** -0.5
        k_ms = cuda_ms(lambda: mqa_fwd(q, k, v, slopes, key_lens, scale, offset,
                                       q_lens, causal))
        lib_ms = cuda_ms(library_call(q, k, v, slopes, key_lens, scale, offset, causal))
        bound_ms, _ = mqa_bound(q, k, key_lens, q_lens, causal, offset)
        say("kernel", t0, f"K1 B={B} N={N} M={M} H={H} {dt} "
            f"{'sym' if sym else 'asym'} offset={offset} causal={int(causal)} "
            f"max_err={err:.3e} lse_err={lse_err:.3e} bound={bound:.0e} "
            f"kernel_ms={k_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f}")
        del q, k, v
    torch.cuda.empty_cache()


def set_flash(model, mode: str) -> None:
    from isp_tts_tpu_torch.nn.attention import Attention

    for m in model.modules():
        if isinstance(m, Attention):
            m.flash = mode


def phase_slice(t0):
    import torch

    from isp_tts_tpu_torch.ops.flash_attention import mqa_fwd
    from isp_tts_tpu_torch.serving import Synthesizer

    synth = Synthesizer.from_pretrained(CKPT)
    say("slice", t0, f"loaded {CKPT.name} on {synth.device}: "
        f"{sum(p.numel() for p in synth.model.parameters())} parameters")

    # the main path: counts zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats()
    mqa_fwd.launches = 0
    request_ms = []  # (first, second) for each request
    outputs = []
    for text in SENTENCES + [SENTENCES]:
        pair = []
        for _ in range(2):  # the first call at a new shape loads kernels
            t = time.perf_counter()
            out = synth(text)  # numpy on return: the device is done
            pair.append(1e3 * (time.perf_counter() - t))
        outputs.append(out)
        request_ms.append(pair)
    launches = {"K1 mqa_fwd": mqa_fwd.launches}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    budget = synth.config.frame_budgets[-1]
    mels = [m for out in outputs for m in out]
    for m in mels:
        if not (m.ndim == 2 and m.shape[1] == synth.model.mel_dim and 0 < m.shape[0] < budget
                and np.isfinite(m).all()):
            raise AssertionError(f"bad mel: shape {m.shape}, finite {np.isfinite(m).all()}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    say("slice", t0, "ms per request, first/second call (3 singles, then the batch "
        "of 3): " + ", ".join(f"{a:.1f}/{b:.1f}" for a, b in request_ms)
        + f"; frames {[m.shape[0] for m in mels]}; launches {launches}; "
        f"peak memory {peak_mib:.1f} MiB")

    # kernel path vs plain path: same model, noise and durations
    tokens, lens, fb, B = synth.prepare(SENTENCES)
    tok = torch.from_numpy(tokens).long().cuda()
    ln = torch.from_numpy(lens).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    noise = torch.randn((tok.shape[0], tok.shape[1], 3), generator=gen, device="cuda")
    model = synth.model
    _, ad = model.infer(tok, ln, max_dec_len=fb, noise=noise)
    durations = ad.duration
    mel_k, ad_k = model.infer(tok, ln, max_dec_len=fb, noise=noise,
                              duration_target=durations)
    set_flash(model, "off")
    try:
        mel_p, ad_p = model.infer(tok, ln, max_dec_len=fb, noise=noise,
                                  duration_target=durations)
    finally:
        set_flash(model, "auto")
    dec = ad_k.dec_lengths  # pad rows included: the decoder's K1 calls see them
    mel_err = (mel_k - mel_p).abs().max().item()
    real = dec[:B]
    if not (torch.equal(dec, ad_p.dec_lengths) and (real > 0).all() and (real < fb).all()):
        raise AssertionError(f"dec_lengths {dec.tolist()} / {ad_p.dec_lengths.tolist()}, "
                             f"budget {fb}")
    if not (torch.isfinite(mel_k).all() and mel_err <= MEL_BOUND):
        raise AssertionError(f"kernel-path mel differs from the plain path by {mel_err:.3e}")
    say("slice", t0, f"kernel path vs plain path: mel max_err={mel_err:.3e} "
        f"bound={MEL_BOUND:.0e}, dec_lengths {real.tolist()} < budget {fb}")
    return synth, launches, dec, fb


def phase_profile(t0, synth, request, label):
    """One warm request under torch.profiler: device busy time against the
    request's wall time, and the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        synth(request)
        wall_ms = 1e3 * (time.perf_counter() - t)
    # device-side events only (kernels, copies): a host op's own device
    # total repeats the time of the kernels it launched
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0]
    busy_ms = sum(r[0] for r in rows) / 1e3
    rows.sort(reverse=True)
    if busy_ms == 0:
        say("profile", t0, f"{label}: {wall_ms:.1f} ms under the profiler; device time "
            "not measured (the profiler saw no CUDA activity)")
        return
    top = "; ".join(f"{name[:60]} x{n} {us / 1e3:.3f} ms" for us, n, name in rows[:8])
    say("profile", t0, f"{label}: wall {wall_ms:.1f} ms under the profiler, device "
        f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%); top: {top}")


def kernel_record(launches, dec, fb):
    """K1's numbers at the decoder's main-path shape: the batch bucket,
    N = M = the frame budget, 6 heads, lengths = the batch's frame counts."""
    import torch

    from isp_tts_tpu_torch.ops.flash_attention import mqa_attention_reference, mqa_fwd

    gen = torch.Generator(device="cuda").manual_seed(2)
    B, H = dec.shape[0], 6
    q, k, v, slopes, _, _ = mqa_inputs(B, fb, fb, H, torch.float32, True, gen)
    lens = dec.to(torch.int32).contiguous()
    err, _, _ = check_mqa(q, k, v, slopes, lens, lens)
    scale = 64 ** -0.5
    ms = cuda_ms(lambda: mqa_fwd(q, k, v, slopes, lens, scale, 0, lens))
    plain_ms = cuda_ms(lambda: mqa_attention_reference(q, k, v, slopes, lens, scale,
                                                       0, lens))
    library_ms = cuda_ms(library_call(q, k, v, slopes, lens, scale))
    bound_ms, bound_by = mqa_bound(q, k, lens, lens)
    return {"name": "K1 mqa_fwd", "route": "cuda",
            "source": "isp_tts_tpu_torch/csrc/mqa_fwd.cu",
            "replaces": "isp_tts_tpu/ops/flash_attention.py:736",
            "launches": launches["K1 mqa_fwd"], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": f"B={B} N=M={fb} H={H} D=64 float32"}


def main() -> int:
    import torch

    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    phase_env(t0)
    phase_build(t0)
    phase_kernel(t0)
    synth, launches, dec, fb = phase_slice(t0)
    phase_profile(t0, synth, SENTENCES[0], "one sentence")
    phase_profile(t0, synth, SENTENCES, "batch of 3")
    record = kernel_record(launches, dec, fb)
    say("done", t0)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
