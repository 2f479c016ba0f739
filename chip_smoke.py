#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``isp_tts_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one flushed line with its seconds, so a cut run shows
how far it got:

1. env     - Python, torch and CUDA versions; the card's name and power limit
             as ``nvidia-smi`` gives them.
2. build   - compiles every kernel of the paths from ``csrc/`` with nvcc,
             one process per library, all started together: the attention
             sources K1, K5a, K2 and K5b once per tile width (16, 32, 64 and
             128, ``-DATT_TILE_D``), K3 and K4 once; then, for each attention
             library, ptxas's registers and spills and the HMMA count of
             each kernel's SASS (a bf16 backward kernel that spills at a tile
             width up to 64 fails the run; at 128 its spills are printed).
3. kernel  - holds kernel K1 (folded-MQA attention forward) against its plain
             version on the card at the serving path's shapes, f32 and bf16,
             and times it beside one PyTorch call; then K1 at the tile edges
             (EDGE_CASES).
4. kernel  - the training path's kernels against their plain versions: K1
             with dropout; K2 (attention backward) in both TPU regimes (M
             320 and M 3072) against autograd through the plain K1 and
             against the plain backward on the kernel forward's saved o and
             lse (check_backward), graph-timed beside SDPA's backward, then
             at the tile edges (BWD_EDGE_CASES); K3 (MAS) for exact
             equality and K4 (banded CTC) loss and gradient, at the training
             shape, the widest shapes the wrappers take and the switch
             points of their paths (K3_CASES, K4_CASES).
5. kernel  - the per-head attention kernels K5a (forward) and K5b (backward)
             against their plain versions: the decoder's training shape in
             f32 and bf16 with and without dropout, 4 heads, causal with an
             offset, one shared key/value head (bf16 too), and M 3072; then
             K5a and K5b at the tile edges with H and with 1 key/value head.
   head-dims - K1/K2 and K5a/K5b (H and 1 key/value heads) at head dims 8,
             12, 16, 32, 96 and 128 (HEAD_DIMS), f32 and bf16, at one query
             against 65 keys, 63 x 65, 65 x 63, 320 x 320 and 65 x 1, causal
             at offsets, short key lengths, dropout (HEAD_DIM_SHAPES): the
             forward against its plain version, the backward against the
             plain backward on the kernel forward's o and lse and its slope
             gradients against float64; K2 at N = M = 3072 at head dims 32
             and 128; and every forward with dropout bit-equal to the head
             dim 64 kernel on the same numbers (the keep mask is D = 64's).
   slopes  - the f32 slope gradients of K5b (1 and H key/value heads) and
             K2 at B 4, N = M = 1024 over 16 draws of dL/do, each within
             1e-4 of the plain version's scale, beside both sides' distance
             from the same formula in float64.
   tp-heads - K1, K2a, K5a and K5b at the fine-tuning shape with dropout
             0.1, f32 and bf16: the whole call against its two head halves
             run as a model split runs them (the global head count and the
             half's first head in the dropout hash): each half's o, lse, dq
             and slope gradients equal the whole call's slices (K5b's dk and
             dv too; K2a's halves' dk and dv sum to the whole), within the
             kernel phases' bounds.
6. slice   - ``Synthesizer.from_pretrained`` on the committed 23M-parameter
             checkpoint, three sentences one at a time and then as one batch,
             with the launch counts zeroed just before and read just after;
             then the same model on the plain attention with the same noise
             and durations, held against the kernel path's mel.
7. profile - one sentence and the batch under torch.profiler: device busy
             time against wall time, and the kernels that take it.
8. vocoder - the committed Vocos vocoder (13.5M parameters) on the card
             against the same vocoder on the CPU, on phase 6's padded batch
             mel, f32; the matmul Griffin-Lim on the card against the CPU,
             same start phases, 32 iterations; each waveform's re-analysed
             mel against its input mel; the vocoder's and Griffin-Lim's
             times at batch 1, 256 frames. Then ``weights_dtype="bf16"``:
             the acoustic weights stored in bf16 (their bytes halve),
             finite mels of about the f32 weights' lengths.
9. serve   - ``Synthesizer.from_pretrained(ckpt, vocoder_path=...)`` after
   audio     ``warmup(audio=True)``: the three sentences one at a time, as one
             batch and through ``synthesize_long``, K1's launches zeroed just
             before and read just after; every waveform finite, in [-1, 1],
             dec_len x 256 samples; then one warm audio request under the
             profiler and the vocoder's share of its device time.
9a. serve-devices - ``Synthesizer.from_pretrained(ckpt, vocoder_path=...,
             devices=["cuda:0", "cuda:0"])``, two replicas on the one card,
             against one device on the three sentences, f32, both on the
             one device's durations: each replica's rows equal one device on
             them (SERVE_SHARD_BOUND), and the whole batch within
             SERVE_WHOLE_BOUNDS of the mel's max-abs and of the waveform;
             then one device's own gap between a batch and its shards over
             GAP_SEEDS (shard_gaps), which that mel bound rests on.
10. cli    - ``python -m isp_tts_tpu_torch.synthesize`` as a subprocess, with
             the vocoder and with Griffin-Lim: 22.05 kHz 16-bit mono WAVs of
             frames x 256 samples.
11. daemon - ``TTSServer`` on 127.0.0.1, warmed on its serving (batcher)
             thread before it serves, over the audio Synthesizer: two lone
             wav requests (the first within DAEMON_FIRST_REQUEST_FACTOR of
             the second), 8 concurrent wav requests, a mel, a pcm and a
             streamed long-form request, /healthz; all 200, the requests
             coalesce. Then ``dataset``: 512 + 64 seeded sentences turned
             into 22.05 kHz WAVs by the same Synthesizer and vocoder, with
             meta_train.csv and meta_valid.csv, in a temporary directory.
11a. export - ``export_serving`` of that audio Synthesizer at batch 1, text
             bucket 128, frame budget 1024 (``ARTIFACT_SHAPE``), with
             ``precompile``; loaded with nvcc refused, its embedded K1
             library loaded privately for its calls and the shared build
             directory left as it was. Its graph holds 25
             ``isp_tts.mqa_fwd`` nodes and one call launches K1 25 times and
             nothing else; its waveform against the live Synthesizer's at
             that shape for two (seed, duration_factor) pairs
             (VOCODER_WAVE_BOUND; bit-identity is reported); its warm call
             within ARTIFACT_WARM_FACTOR of the live one. The same export
             made on the CPU (platforms cpu and cuda), moved to the card by
             its loader, checked the same way; then the daemon with
             ``--artifact`` answers one wav request in a fresh subprocess
             with nvcc refused and an empty build directory, where only the
             embedded library can serve.
12. slice  - the multi-KV-head model: the same checkpoint with every
             attention layer's one key/value head replicated to all heads
             (it computes what the checkpoint computes), served the same way
             through ``Synthesizer(model)`` on K5a; its mel against its own
             plain path and against the one-KV-head model's mel on K1.
13. profile - one warm multi-KV-head request.
13a. export - the multi-KV-head model's mel artifact: 25
             ``isp_tts.flash_fwd`` nodes, 25 K5a launches a call, its mel
             against the live path's (MEL_BOUND).
13b. interop - the committed checkpoint written as a reference ``.pt`` and
             the committed vocoder as a torch Vocos ``.pt``, reloaded on the
             card: every tensor bit-equal, and the mel and waveform
             bit-equal to the ``.ckpt`` models read with the reference's
             semantics (erf GELU; Vocos's upper-only clip at log 100); then
             one training step of a trainer warm-started from the ``.pt``
             against one warm-started from the ``.ckpt``.
14. train  - fine-tunes the same checkpoint at full width with its own
             training setup (batch 32, text 48 x mel 320, bf16, dropout,
             AdamW): the batch is 32 sentences synthesized by the
             Synthesizer. (a) one step on the kernel path against the same
             step on the plain path in f32, and in bf16 the sum of
             BF16_DRAWS steps with their own seeds, both paths on the f32
             plain step's MAS alignment (beside a control: the plain path's
             bf16 step against its f32 step);
             (b) 30 bf16 steps, counts zeroed just before and read just
             after, finite metrics and a falling mel loss; (c) the
             aligner's durations sum to the mel lengths.
15. profile - one warm training step under torch.profiler.
15a. dist-one - an NCCL process group of world size 1 in this process: 3
             fine-tuning steps through the distributed trainer (the data
             group's bucketed all-reduce, rank 0's barriered save) against
             the plain trainer's 3 steps: bit-equal, or within rel 1e-6;
             the same K1-K4 launches; the two checkpoints' bytes.
15b. seq-stage - the seq and stage axes on one card: ring attention on a
             seq axis of size 1 against K1 on the same inputs at the
             fine-tuning shape (f32 and bf16, each with its bound, timed); the
             virtual ring of 2 and 4 ranks against the ring of one with
             dropout; the decoder stacked (pipeline: true) from the committed
             checkpoint, saved, reloaded stacked and translated back per layer
             bit-equal, served through ``Synthesizer.from_pretrained`` against
             the per-layer checkpoint (warm ms of each); 3 f32 steps with
             ``flash: ring`` on a size-1 seq axis against the kernel path
             (attention dropout off: the ring hashes another index than K1),
             loss and gradient norm within 5e-4 and step 1's gradients within
             3e-4 of each tensor's max-abs, and a planted ring whose slope
             gradient is dropped, which the gates must catch; then each recipe's
             setting (core, core_sp, core_pp on size-1 axes): one step's K1-K4
             launches, counts zeroed just before and read just after, host ms
             per bf16 step and peak memory.
15c. tf32  - ``precision: fp32`` from PyTorch's defaults: TF32 off and
             cuDNN deterministic inside the step, the defaults restored after
             it, two runs bit-equal; f32 ms per step in that scope, with
             TF32 off alone and with the defaults, interleaved.
15d. interface - the attention layer's interface at full width, on the
             committed checkpoint's decoder (6 layers x 384, 6 heads x 64)
             made causal, with one key/value head and with H (``to_kv``
             tiled): 256 tokens decoded through the layers' KV caches
             (K1 or K5a at N = 1, offset t - 1) against the same decode at
             ``flash: off`` (the plain versions; f32 within F32_BOUND, bf16
             within 2 ulps of the output's max-abs) and against the full
             causal call (f32 within 1e-4 of the output's max-abs, bf16
             within 2 ulps of it), the decode's launches (6 x 256) and ms
             per token; cross-attention at mel 320 / 1024 against text
             48 / 192 (offset M - N): K1/K5a held against their plain
             version in float64, K2/K5b against their plain versions and
             autograd, the slope gradients also against float64
             (check_forward, check_backward), then the layer's ``flash:
             on`` against ``flash: off`` (output, and the gradients of x,
             the context and the weights; the slopes' against the layer in
             float64), one launch each; an explicit causal attention mask
             (the plain masked path, no kernel) against the kernels'
             causal call. The decode's shapes are also tile-edge cases of
             the kernel phases (EDGE_CASES).
15e. batch-norm - the fine-tuning step with the aligner's ``normalization:
             batch``: 8 bf16 steps from the checkpoint's weights, finite and
             falling, K1-K4 launched, the running statistics moved, an
             evaluation step on them, the model saved and loaded bit-equal.
16. train  - the same for the multi-KV-head model on K5a/K5b, and, in f32
             with dropout off, its ``to_kv`` gradient summed over the heads
             against the one-KV-head model's, both models on the same K and
             V (K5a/K5b against K1/K2 on the model).
17. profile - one warm multi-KV-head training step.
18. stats  - ``python -m isp_tts_tpu_torch.train --compute-stats`` on that
             dataset (YIN and the front end on the card): finite statistics,
             pitch mean 40-800 Hz.
19. recipe - ``acoustic/core_fast`` at its widths (bf16, batch 32, fixed
             192 x 896, 8 steps a chunk), warm-started from the committed
             checkpoint, 16 steps, evaluating and saving every 8: once
             through the CLI (exit 0), once in process with the launch
             counts zeroed just before ``train()`` and read just after;
             finite losses, the mel loss of steps 9-16 below that of 1-8,
             finite MCD, durations summing to the mel lengths, the written
             checkpoint bit-equal to the model, the WAVs read by the native
             decoder; per-step host time, front end per batch, checkpoint
             save and load, peak memory.
20. resume - a second uninterrupted run (the control) and a run resumed
             from the first's step-8 checkpoint: steps 9-16 and the final
             parameters within twice the control (bit-equal if it is).
21. profile - one warm recipe training step under torch.profiler.
22. recipe-kernels - K1, K2, K3 and K4 graph-timed at the recipe's shape
             (B 32, text 192 x mel 896) beside their bounds, plain versions
             and library calls.
22a. head-split - ``acoustic/core_fast`` with its heads split through
             ``--set`` overrides (HEAD_SPLIT: encoder and decoder 12 heads
             x 32, predictor and feature embedding 2 heads x 128), from the
             random init: 16 bf16 steps of the recipe trainer on the dataset
             (finite, falling loss; K1/K2 16 launches a step, 12 at head dim
             32 and 4 at 128, K3 and K4 one; the checkpoint in the JAX
             format), then ``Synthesizer.from_pretrained`` of it (the three
             sentences alone and batched, 25 K1 launches a synthesis; the
             mel on the kernels within MEL_BOUND of the plain path's, f32,
             same noise and durations); then HEAD_SPLIT_MHA (H key/value
             heads, every layer 128 wide) through the Trainer, 4 steps and
             one synthesis on K5a/K5b at head dim 128. After the training,
             K1/K2 and K5a/K5b are held against their plain versions at
             the split's own shapes (B 32, N = M = 896 and 192 on one of
             its batches' lengths, 12 x 32, 2 x 128, and 3 x 128 and
             2 x 128 with H key/value heads; SPLIT_SHAPES). The kernel
             records then add K1, K2, K5a and K5b at the fine-tuning shape
             split as 12 x 32 and 3 x 128 (HEAD_DIM_SPLITS), each held
             against its plain version, with these launches, and K1/K5a at
             the serving shape (B 4, N = M = 1024, f32) at those splits.

23. wav-decode - the native C++ decoder's batch against the port's Python
             reader on 32 of the dataset's WAVs: bit-equal; ms per batch of
             32 for each.
24. gan-step - ``vocoder/vocos`` at its widths (generator 512 x 8, MPD
             periods 2-11 up to 1024 channels, three MRD resolutions, batch
             16 x 16384) on 128 of the dataset's utterances, warm-started
             from the committed vocoder: one f32 GAN step on the card against
             the same step on the CPU (GAN_LOSS_BOUND, GAN_PARAM_BOUND), then
             two bf16 steps finite; one warm bf16 step under the profiler.
25. gan-recipe - the same through the CLI (exit 0), then in process: 16
             steps, evaluating and saving every 8; finite losses, the
             discriminator's loss of steps 9-16 below that of 1-8, the
             evaluation mel L1 within GAN_MEL_FACTOR of the warm start's,
             the checkpoint bit-equal with moments for both branches, the
             WAVs read by the native decoder; host ms per step, peak
             memory, checkpoint save and load.
26. gan-resume - a control run and one resumed from step 8, as phase 20.

Then one JSON line with every kernel's numbers, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
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
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 and f64 (non-tensor)
# and bf16 dense tensor operations/s, and f32 products done as 3xTF32 on the
# tensor cores (three TF32 MMAs each, 495 TFLOP/s dense TF32 over 3)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12, "3xtf32": 495e12 / 3}


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


def graph_ms(fn, iters: int = 20, replays: int = 5, stream=None) -> float:
    """Mean device milliseconds of ``fn`` with the host out of the way:
    ``iters`` calls captured in one CUDA graph, replayed ``replays`` times
    between two events. A short kernel called eagerly is timed at the rate
    the host issues it (the wrappers' checks and ctypes call take tens of
    microseconds); the graph replays only the device work. ``stream``: the
    side stream to warm up and capture on (a backward runs on its forward's
    stream)."""
    import torch

    side = torch.cuda.Stream() if stream is None else stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    return ms


def library_bwd_ms(q, k, v, slopes, key_lens, scale, offset, causal, do, iters=10) -> float:
    """Device ms of the library backward (:func:`library_call` with ``do``):
    its forward recorded on a side stream and the autograd call captured on
    that stream in a CUDA graph (:func:`graph_ms`)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn = library_call(q, k, v, slopes, key_lens, scale, offset, causal, do=do)
    return graph_ms(fn, iters=iters, stream=side)


def mqa_inputs(B, N, M, H, dtype, symmetric, gen, kv_heads=None, D=64):
    """Unit-scale q/k/v at head dim ``D``, trained-like ALiBi slopes and
    ragged lengths; k/v (B, M, D), or (B, M, kv_heads, D) for the per-head
    kernels."""
    import torch

    from isp_tts_tpu_torch.nn.embeddings import alibi_slopes

    dev = "cuda"
    kv = (B, M, D) if kv_heads is None else (B, M, kv_heads, D)
    q = torch.randn((B, N, H, D), generator=gen, device=dev).to(dtype)
    k = torch.randn(kv, generator=gen, device=dev).to(dtype)
    v = torch.randn(kv, generator=gen, device=dev).to(dtype)
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


def bound_ms(nbytes: float, ops, dtype: str = "float32"):
    """(ms, 'bytes' | 'operations'): the larger of bytes over the HBM rate
    and operations over the peak rate of ``dtype`` (``ops`` a dict: the sum
    of each type's operations over its peak)."""
    ops = ops if isinstance(ops, dict) else {dtype: ops}
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = sum(n / PEAK_OPS_S[d] for d, n in ops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attention_pairs(key_lens, q_lens, causal=False, offset=0) -> int:
    """(live query, valid key) pairs of these lengths, per head."""
    pairs = 0
    for ql, kl in zip(q_lens.tolist(), key_lens.tolist()):
        if causal:
            pairs += sum(max(0, min(kl, n + offset + 1)) for n in range(ql))
        else:
            pairs += ql * kl
    return pairs


def attention_bound(q, k, key_lens, q_lens, causal=False, offset=0, backward=False):
    """(ms, 'bytes' | 'operations'): the least time for an attention
    forward's work on these inputs (K1, K5a), or with ``backward`` its
    backward's (K2, K5b) — each input read once, each output written once
    (k and v carry their Hkv heads: (B, M, D) or (B, M, Hkv, D)); 4*D
    operations per (live query row, valid key) pair forward (q.k, p.v),
    10*D backward (s, dp, dv, dk, dq). Both run f32 as 3xTF32 on the
    tensor cores."""
    B, N, H, D = q.shape
    rows, keys = (4, 4) if backward else (2, 2)  # q o (dO dq) | k v (dk dv)
    nbytes = (rows * q.numel() + keys * k.numel()) * q.element_size() + 4 * B * N * H
    ops = (10 if backward else 4) * D * H * attention_pairs(key_lens, q_lens, causal, offset)
    dtype = str(q.dtype).replace("torch.", "")
    return bound_ms(nbytes, ops, "3xtf32" if dtype == "float32" else dtype)


def library_call(q, k, v, slopes, key_lens, scale, offset=0, causal=False, do=None):
    """One PyTorch call for the same function, the bias and mask built
    beforehand: scaled_dot_product_attention with an additive ALiBi + mask.
    With ``do`` it is the backward instead: the gradients of that call's
    output, the bias a tensor that requires grad, against ``do``."""
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
    if k.dim() == 3:  # one key/value head
        k, v = k[:, :, None], v[:, :, None]
    kh = k.transpose(1, 2).expand(B, H, M, D).contiguous()
    vh = v.transpose(1, 2).expand(B, H, M, D).contiguous()
    if do is None:
        return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias,
                                                      scale=scale)
    inputs = [x.detach().contiguous().requires_grad_() for x in (qh, kh, vh, bias)]
    out = F.scaled_dot_product_attention(*inputs[:3], attn_mask=inputs[3], scale=scale)
    return lambda: torch.autograd.grad(out, inputs, do.transpose(1, 2), retain_graph=True)


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


#: the attention kernels' sources (the tensor-core tile cores: the forwards
#: K1, K5a and the backwards K2, K5b), each built once per tile width
ATTENTION_SOURCES = ("mqa_fwd", "flash_fwd", "mqa_bwd", "flash_bwd")


def attention_libraries() -> list[str]:
    """The attention sources' libraries, one per (source, tile width of
    ``HEAD_TILES``): ``mqa_fwd_d16`` .. ``flash_bwd_d128``."""
    from isp_tts_tpu_torch.ops.flash_attention import HEAD_TILES, kernel_library

    return [kernel_library(src, tile) for src in ATTENTION_SOURCES for tile in HEAD_TILES]


def sources() -> list[str]:
    """Every kernel library of the paths (``ops/cuda_build.py`` names)."""
    return attention_libraries() + ["mas", "ctc"]


def phase_build(t0):
    """Every library of :func:`sources`, one nvcc process each, all started
    together; each one's nvcc seconds and ptxas's register and spill lines."""
    from isp_tts_tpu_torch.ops import cuda_build

    t = time.perf_counter()
    cuda_build.build_all(sources())
    say("build", t0, f"{len(sources())} libraries built in {time.perf_counter() - t:.2f} s "
        f"({len(attention_libraries())} attention libraries: 4 sources x "
        f"{len(attention_libraries()) // 4} tile widths)")
    for name in sources():
        info = cuda_build.BUILD_INFO[name]
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        say("build", t0, f"{name} nvcc {info['seconds']:.2f}s; " + " | ".join(ptxas))


def cuobjdump_path() -> str:
    """The CUDA toolkit's cuobjdump, else the copy in Triton's package."""
    import shutil

    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(found).exists():
        return found
    try:
        import triton
    except ImportError:
        triton = None
    if triton is not None:
        bundled = Path(triton.__file__).parent / "backends/nvidia/bin/cuobjdump"
        if bundled.exists():
            return str(bundled)
    raise RuntimeError("no cuobjdump: neither the CUDA toolkit's nor Triton's")


#: the tile cores' kernels that run products, four instantiations in each
#: library: f32 and bf16, each at the full tile width (D == DT) and below it
PRODUCT_KERNELS = ("attention_fwd_kernel", "attention_dq_kernel", "attention_dkv_kernel")


def ptxas_usage(log: str) -> dict:
    """Kernel (mangled name) -> (registers, spill store bytes, spill load
    bytes), from ptxas -v's lines in an nvcc log."""
    usage, fn, spills = {}, None, (0, 0)
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn, spills = ln.split("'")[1], (0, 0)
        elif "spill stores" in ln and fn is not None:
            words = ln.replace(",", "").split()
            spills = (int(words[words.index("spill") - 2]), int(words[words.index("loads") - 3]))
        elif "Used" in ln and "registers" in ln and fn is not None:
            words = ln.replace(",", "").split()
            usage[fn] = (int(words[words.index("registers") - 1]),) + spills
    return usage


def full_width(mangled: str) -> bool:
    """Whether a tile-core kernel is its library's D == DT instantiation
    (the template's ``kFullD``, mangled ``Lb1E`` after the tile width)."""
    return "Lb1E" in mangled


def kernel_label(mangled: str) -> str:
    """A kernel's short name: its tile-core kernel (or the whole mangled
    name), its input type, and for a product kernel D == DT or D < DT."""
    names = PRODUCT_KERNELS + ("dkv_sum_kernel",)
    kind = next((n for n in names if n in mangled), mangled)
    width = ("" if kind not in PRODUCT_KERNELS
             else " D=DT" if full_width(mangled) else " D<DT")
    return (f"{kind.replace('attention_', '')} {'bf16' if 'bfloat16' in mangled else 'f32'}"
            + width)


def phase_sass(t0):
    """For each library of the tensor-core tile cores, at every tile width:
    the count of HMMA (tensor-core) instructions in each product kernel's
    SASS beside ptxas's registers and spills, and the dynamic shared memory
    per dtype as the library reports the size it launches with; raises if a
    product kernel has no HMMA, a backward bf16 kernel spills at a tile
    width up to 64 (at 128 its spills are printed), a library reports
    another tile width than its name, or no cuobjdump is found."""
    import ctypes

    from isp_tts_tpu_torch.ops import cuda_build

    tool = cuobjdump_path()
    # one cuobjdump a library, all started together
    dumps = {name: tempfile.TemporaryFile(mode="w+") for name in attention_libraries()}
    procs = {name: subprocess.Popen([tool, "--dump-sass", str(cuda_build.library_path(name))],
                                    stdout=out, text=True) for name, out in dumps.items()}
    try:
        for name, proc in procs.items():
            if proc.wait(timeout=300):
                raise AssertionError(f"{tool} --dump-sass {name} exited {proc.returncode}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, out in dumps.items():
        source, tile = name.rsplit("_d", 1)
        usage = ptxas_usage(cuda_build.BUILD_INFO[name]["log"])
        out.seek(0)
        sass = out.read()
        out.close()
        counts, fn = {}, None
        for ln in sass.splitlines():
            if "Function :" in ln:
                fn = ln.split("Function :", 1)[1].strip()
                counts[fn] = 0
            elif fn is not None and "HMMA" in ln:
                counts[fn] += 1
        kernels = {k: n for k, n in counts.items() if any(p in k for p in PRODUCT_KERNELS)}
        if len(kernels) != (4 if source.endswith("fwd") else 8) or min(kernels.values()) == 0:
            raise AssertionError(f"{name}: HMMA instructions per kernel {counts}")
        spilling = [k for k in kernels if source.endswith("bwd") and "bfloat16" in k
                    and sum(usage.get(k, (0, 0, 0))[1:]) > 0]
        if spilling and int(tile) <= 64:
            raise AssertionError(f"{name}: bf16 kernels spill: "
                                 + str({k: usage[k] for k in spilling}))
        lib = cuda_build.load(name)
        smem = getattr(lib, f"isp_{source}_smem_bytes")
        smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
        width = getattr(lib, f"isp_{source}_tile_d")()
        if width != int(tile):
            raise AssertionError(f"{name} reports tile width {width}")

        def label(k):
            regs = usage.get(k)
            return (f"{kernel_label(k)} HMMA {kernels[k]}"
                    + ("" if regs is None else f" registers {regs[0]} spill bytes "
                       f"{regs[1]}/{regs[2]}"))

        say("build", t0, f"{name} ({tool}): " + "; ".join(label(k) for k in sorted(kernels))
            + f"; dynamic shared memory f32 {smem(0)}, bf16 {smem(1)} bytes")


KERNEL_CASES = (  # B, N, M, H, dtype, symmetric, offset, causal
    [(B, N, N, H, "float32", True, 0, False)
     for H in (6, 4) for N in (128, 1024, 2048) for B in (1, 4)]
    + [(4, N, N, H, "bfloat16", True, 0, False) for H in (6, 4) for N in (128, 2048)]
    + [(2, 1024, 1024, 6, "float32", False, 0, False),  # asymmetric ALiBi
       (2, 96, 224, 6, "float32", False, 128, False),  # offset != 0
       (2, 1024, 1024, 4, "float32", True, 0, True)]  # causal
)


def check_forward(q, k, v, slopes, key_lens, q_lens, offset=0, causal=False, rate=0.0,
                  seed=None, exact=False):
    """K1 (k and v (B, M, D)) or K5a (k and v (B, M, Hkv, D)) against its
    plain version on the same inputs, at the scale D ** -0.5: o within the dtype's bound, lse within
    it relative to lse's size, the same dead rows (lse +inf), and under
    dropout the kept share of the keep mask within 0.01 of thresh/256.
    With ``exact`` the plain version runs in float64 on the same inputs
    (the kernel held to an exact answer: at offsets far from 0 the ALiBi
    bias reaches ~-1000, whose f32 rounding moves the f32 plain version as
    far as the kernel) and the f32 plain version's own o distance from it
    is read. Returns (name, o err, lse err, bound, kept share or None, the
    f32 plain version's o distance from float64 or None)."""
    import torch

    from isp_tts_tpu_torch.ops import flash_attention as fa

    mqa = k.dim() == 3
    name = "K1" if mqa else "K5a"
    fwd, plain = ((fa.mqa_fwd, fa.mqa_attention_reference) if mqa
                  else (fa.flash_fwd, fa.flash_attention_reference))
    seed = seed_tensor(0) if seed is None else seed
    args = (q, k, v, slopes, key_lens, q.shape[3] ** -0.5, offset, q_lens, causal, rate, seed)
    o, lse = fwd(*args)
    torch.cuda.synchronize()
    o_ref, lse_ref = plain(*args)
    plain_err = None
    if exact:
        o_f32 = o_ref.float()
        o_ref, lse_ref = plain(q.double(), k.double(), v.double(), slopes.double(), *args[4:])
        plain_err = (o_f32.double() - o_ref).abs().max().item()
        del o_f32
    live = torch.isfinite(lse_ref)
    if not torch.equal(torch.isfinite(lse), live):
        raise AssertionError(f"{name} lse marks other rows dead than the plain version")
    err = (o.double() - o_ref.double()).abs().max().item()
    lse_err = (lse[live].double() - lse_ref[live]).abs().max().item() if live.any() else 0.0
    lse_max = lse_ref[live].abs().max().item() if live.any() else 0.0
    bound = F32_BOUND if q.dtype == torch.float32 else BF16_BOUND
    if not (err <= bound and lse_err <= bound * (1 + lse_max)):
        raise AssertionError(f"{name} {tuple(q.shape)} {q.dtype} rate={rate} offset={offset} "
                             f"causal={causal} disagrees with its plain version"
                             f"{' in float64' if exact else ''}: o err "
                             f"{err:.3e}, lse err {lse_err:.3e}, bound {bound:.0e}")
    kept = None
    if rate:
        B, N, H, _ = q.shape
        M = k.shape[1]
        thresh = fa.dropout_thresh(rate)
        mask = (fa.mqa_keep_mask(B, N, H, M, seed, thresh) if mqa
                else fa.head_keep_mask(B, H, N, M, seed, thresh))
        kept = mask.float().mean().item()
        del mask
        if abs(kept - thresh / 256) > 0.01:
            raise AssertionError(f"{name} kept share {kept:.4f} vs {thresh / 256:.4f}")
    return name, err, lse_err, bound, kept, plain_err


def phase_kernel(t0):
    import torch

    from isp_tts_tpu_torch.ops.flash_attention import mqa_fwd

    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, N, M, H, dt, sym, offset, causal in KERNEL_CASES:
        dtype = getattr(torch, dt)
        q, k, v, slopes, key_lens, q_lens = mqa_inputs(B, N, M, H, dtype, sym, gen)
        _, err, lse_err, bound, _, _ = check_forward(q, k, v, slopes, key_lens, q_lens, offset,
                                                  causal)
        scale = 64 ** -0.5
        k_ms = graph_ms(lambda: mqa_fwd(q, k, v, slopes, key_lens, scale, offset,
                                        q_lens, causal))
        lib_ms = graph_ms(library_call(q, k, v, slopes, key_lens, scale, offset, causal))
        b_ms, _ = attention_bound(q, k, key_lens, q_lens, causal, offset)
        say("kernel", t0, f"K1 B={B} N={N} M={M} H={H} {dt} "
            f"{'sym' if sym else 'asym'} offset={offset} causal={int(causal)} "
            f"max_err={err:.3e} lse_err={lse_err:.3e} bound={bound:.0e} "
            f"kernel_ms={k_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.4f}")
        del q, k, v
    phase_edges(t0, gen)
    torch.cuda.empty_cache()


# The forward kernels' tile edges (64-row blocks, 16-row warps, 64-key
# tiles, 8- and 16-wide fragments): lengths that are not multiples of 8, 16
# or 64, 6 and 4 heads (K1's folded rows straddle queries inside a
# fragment), causal with offsets 128 and -5, M 3072, dropout 0.1; the
# KV-cache decode's shapes (one query against M cached keys, causal at
# offset M - 1); in every batch one row has key length 0 and one query
# length 0.
EDGE_CASES = (  # B, N, M, H, offset, causal, rate
    (4, 37, 45, 6, 0, False, 0.0), (4, 37, 45, 4, 0, True, 0.1),
    (32, 48, 48, 6, 0, False, 0.1), (32, 48, 48, 4, 0, False, 0.0),
    (4, 1024, 1024, 6, 0, False, 0.1), (4, 1024, 1024, 4, 0, True, 0.0),
    (4, 96, 224, 6, 128, True, 0.1), (4, 300, 300, 4, -5, True, 0.1),
    (3, 3072, 3072, 6, 0, False, 0.1),
    (4, 1, 256, 6, 255, True, 0.0), (4, 1, 17, 6, 16, True, 0.0),
)


def phase_edges(t0, gen, kv_heads=(None,)):
    """Every EDGE_CASES case in f32 and bf16 through :func:`check_forward`:
    K1 (``kv_heads`` None) or K5a with each given count of key/value heads
    (0 meaning H)."""
    import torch

    for B, N, M, H, offset, causal, rate in EDGE_CASES:
        for dt in ("float32", "bfloat16"):
            for hkv in kv_heads:
                kvh = None if hkv is None else (hkv or H)
                q, k, v, slopes, kl, ql = mqa_inputs(B, N, M, H, getattr(torch, dt), False,
                                                     gen, kv_heads=kvh)
                kl[1], ql[2] = 0, 0  # a row of dead queries, a row of none
                name, err, lse_err, bound, kept, _ = check_forward(
                    q, k, v, slopes, kl, ql, offset, causal, rate, seed_tensor(777))
                say("kernel", t0, f"{name} edge B={B} N={N} M={M} H={H}"
                    + ("" if kvh is None else f" Hkv={kvh}") + f" {dt} offset={offset} "
                    f"causal={int(causal)} dropout={rate} lengths k {kl.tolist()} q "
                    f"{ql.tolist()}: max_err={err:.3e} lse_err={lse_err:.3e} "
                    f"bound={bound:.0e}" + ("" if kept is None else f" kept={kept:.4f}"))
                del q, k, v
        torch.cuda.empty_cache()


# The backward kernels' tile edges (64-row and 64-key blocks, 16-row warps,
# 64-row tiles): EDGE_CASES and row and key counts of 1, 63, 64 and 65.
BWD_EDGE_CASES = EDGE_CASES + (  # B, N, M, H, offset, causal, rate
    (4, 1, 1, 6, 0, False, 0.1), (4, 63, 65, 6, 0, False, 0.1), (4, 64, 64, 4, -5, True, 0.1),
    (4, 65, 63, 6, 0, False, 0.0), (4, 1, 65, 4, 0, False, 0.1), (4, 65, 1, 6, 0, True, 0.1),
)


def phase_edges_bwd(t0, gen, kv_heads=(None,)):
    """Every BWD_EDGE_CASES case in f32 and bf16: the kernel backward
    against its plain version on the kernel forward's o and lse
    (:func:`check_backward` without autograd), K2 (``kv_heads`` None) or K5b
    with each given count of key/value heads (0 meaning H)."""
    import torch

    for B, N, M, H, offset, causal, rate in BWD_EDGE_CASES:
        for dt in ("float32", "bfloat16"):
            for hkv in kv_heads:
                kvh = None if hkv is None else (hkv or H)
                q, k, v, slopes, kl, ql = mqa_inputs(B, N, M, H, getattr(torch, dt), False,
                                                     gen, kv_heads=kvh)
                kl[1], ql[2] = 0, 0  # a row of dead queries, a row of none
                w = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
                name, _, errs, bound, _, _ = check_backward(q, k, v, slopes, kl, ql, w, offset,
                                                            causal, rate, seed_tensor(778),
                                                            autograd=False)
                say("kernel", t0, f"{name} edge B={B} N={N} M={M} H={H}"
                    + ("" if kvh is None else f" Hkv={kvh}") + f" {dt} offset={offset} "
                    f"causal={int(causal)} dropout={rate}: {grad_errs('vs plain backward', errs)}"
                    f" bound={bound:.0e}")
                del q, k, v, w
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- head dims
#: the ``head-dims`` phase's head dims: 8 and 16 (tile width 16; 8 fills the
#: k-step of 16 with zeros), 12 (zero-padded to 16 by the wrappers), 32, 96
#: (tile width 128 below its width) and 128
HEAD_DIMS = (8, 12, 16, 32, 96, 128)
#: (B, N, M, H, offset, causal, rate): one query against 65 keys (causal,
#: offset 64), 63 x 65 and 65 x 63 (tile edges) causal at offsets 3 and -5,
#: 320 x 320 (the dk/dv pass split in two: H 4 x 5 row tiles), 65 queries
#: against one key; in every batch one row has key length 0 and one query
#: length 0, the others short key lengths
HEAD_DIM_SHAPES = (
    (4, 1, 65, 4, 64, True, 0.1), (4, 63, 65, 4, 3, True, 0.1),
    (4, 65, 63, 3, -5, True, 0.1), (4, 320, 320, 4, 0, False, 0.1),
    (4, 65, 1, 3, 0, True, 0.0),
)
#: the long-key regime (K2b's TPU kernels, key-streamed above M 2048), K2 at
#: these head dims
HEAD_DIM_LONG, HEAD_DIM_LONG_DIMS = (1, 3072, 3072, 2, 0, False, 0.1), (32, 128)
#: the mask check's shape: dropout 0.1 over 320 x 320
HEAD_DIM_MASK_SHAPE = (4, 320, 320, 4, 0, False, 0.1)
#: the attention families: K1/K2 (one key/value head, folded rows), K5a/K5b
#: with H key/value heads (0) and with one (1)
FAMILIES = (None, 0, 1)


def family_label(kvh) -> str:
    return "K1/K2" if kvh is None else ("K5a/K5b Hkv=H" if kvh == 0 else "K5a/K5b Hkv=1")


def same_mask(D, dtype, kvh, gen) -> None:
    """The forward kernel at head dim ``D`` against the kernel at 64 on the
    same numbers, zero columns added to the narrower (``D`` < 64: the data
    padded to 64; ``D`` > 64: data of 64 columns padded to ``D``), both at
    one scale, with dropout 0.1: o (its first min(D, 64) columns) and lse
    bit-equal, so the keep mask, whose hash does not involve D, is the
    D = 64 kernel's bit for bit. Raises otherwise."""
    import torch
    import torch.nn.functional as F

    from isp_tts_tpu_torch.ops import flash_attention as fa

    B, N, M, H, offset, causal, rate = HEAD_DIM_MASK_SHAPE
    hkv = None if kvh is None else (kvh or H)
    fwd = fa.mqa_fwd if hkv is None else fa.flash_fwd
    narrow = min(D, 64)
    q, k, v, slopes, kl, ql = mqa_inputs(B, N, M, H, dtype, False, gen, kv_heads=hkv, D=narrow)
    wide = [F.pad(x, (0, max(D, 64) - narrow)).contiguous() for x in (q, k, v)]
    seed, scale = seed_tensor(64), narrow ** -0.5
    o_n, lse_n = fwd(q, k, v, slopes, kl, scale, offset, ql, causal, rate, seed)
    o_w, lse_w = fwd(*wide, slopes, kl, scale, offset, ql, causal, rate, seed)
    torch.cuda.synchronize()
    if not (torch.equal(o_n, o_w[..., :narrow]) and torch.equal(lse_n, lse_w)):
        o_err = (o_n.float() - o_w[..., :narrow].float()).abs().max().item()
        raise AssertionError(
            f"{family_label(kvh)} D={D} {dtype}: the forward at D {narrow} and at "
            f"{max(D, 64)} on the same numbers differ (o {o_err:.3e}, lse "
            f"{(lse_n - lse_w).abs().max().item():.3e}): not the D = 64 keep mask")


def phase_head_dims(t0):
    """K1/K2, K5a/K5b (Hkv = H and 1) at every head dim of HEAD_DIMS, f32 and
    bf16, forward and backward, at HEAD_DIM_SHAPES: the forward against its
    plain version (check_forward: 1e-4 f32, 2e-2 bf16), the backward against
    the plain backward on the kernel forward's o and lse (check_backward,
    K2_BOUNDS) and its slope gradients against the same formula in float64
    (SLOPES_F64_BOUNDS; not at M = 1, where they vanish); K2 also in the
    long-key regime (HEAD_DIM_LONG); then every (head dim, dtype, family)'s
    forward with dropout bit-equal to the D = 64 kernel's on the same
    numbers (:func:`same_mask`)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(18)
    for D in HEAD_DIMS:
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            for kvh in FAMILIES:
                worst = [0.0] * 8  # o, lse, dq, dk, dv, dslopes, dslopes vs f64 (kernel, plain)
                for B, N, M, H, offset, causal, rate in HEAD_DIM_SHAPES:
                    hkv = None if kvh is None else (kvh or H)
                    q, k, v, slopes, kl, ql = mqa_inputs(B, N, M, H, dtype, False, gen,
                                                         kv_heads=hkv, D=D)
                    kl[1], ql[2] = 0, 0  # a row of dead queries, a row of none
                    seed = seed_tensor(1800 + D)
                    _, err, lse_err, fbound, _, _ = check_forward(q, k, v, slopes, kl, ql,
                                                                  offset, causal, rate, seed)
                    w = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
                    _, _, errs, bbound, _, _ = check_backward(
                        q, k, v, slopes, kl, ql, w, offset, causal, rate, seed,
                        autograd=False, slopes_f64=M > 1)
                    worst = [max(a, b) for a, b in zip(worst, [err, lse_err] + errs + [0, 0])]
                    del q, k, v, w
                say("head-dims", t0, f"{family_label(kvh)} D={D} {dt} over "
                    f"{len(HEAD_DIM_SHAPES)} shapes: forward o {worst[0]:.3e} lse "
                    f"{worst[1]:.3e} (bound {fbound:.0e}); backward "
                    f"{grad_errs('vs plain backward', worst[2:6])} (bound {bbound:.0e}); "
                    f"dslopes vs float64 {worst[6]:.3e} (bound "
                    f"{SLOPES_F64_BOUNDS[dt]:.0e}; the plain backward {worst[7]:.3e})")
                same_mask(D, dtype, kvh, gen)
        torch.cuda.empty_cache()
    say("head-dims", t0, f"forward with dropout {HEAD_DIM_MASK_SHAPE[-1]} bit-equal to the "
        f"D = 64 kernel on the same numbers at every head dim, dtype and family: the keep "
        f"mask is the D = 64 mask")
    B, N, M, H, offset, causal, rate = HEAD_DIM_LONG
    for D in HEAD_DIM_LONG_DIMS:
        for dt in ("float32", "bfloat16"):
            q, k, v, slopes, kl, ql = mqa_inputs(B, N, M, H, getattr(torch, dt), False, gen, D=D)
            seed = seed_tensor(1818)
            _, err, lse_err, fbound, _, _ = check_forward(q, k, v, slopes, kl, ql, offset,
                                                          causal, rate, seed)
            w = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
            _, _, errs, bbound, _, _ = check_backward(q, k, v, slopes, kl, ql, w, offset,
                                                      causal, rate, seed, autograd=False)
            say("head-dims", t0, f"K1/K2 long keys B={B} N=M={N} H={H} D={D} {dt}: o "
                f"{err:.3e} lse {lse_err:.3e} (bound {fbound:.0e}); "
                f"{grad_errs('vs plain backward', errs)} (bound {bbound:.0e})")
            del q, k, v, w
            torch.cuda.empty_cache()


def set_flash(model, mode: str) -> None:
    from isp_tts_tpu_torch.nn.attention import Attention

    for m in model.modules():
        if isinstance(m, Attention):
            m.flash = mode


def multi_kv_head(cfg):
    """A model config with one key/value head per query head in every
    attention layer (``one_kv_head: false``); the widths stay."""
    if isinstance(cfg, dict):
        return {k: (dict(v, one_kv_head=False) if k == "attention" else multi_kv_head(v))
                for k, v in cfg.items()}
    return cfg


def replicate_kv_heads(flat: dict, heads: dict) -> dict:
    """One-KV-head parameters (JAX names and layout) for the multi-KV-head
    model: each ``to_kv`` kernel (dim, 2*D), K then V, becomes
    (dim, 2*H*D) with its K and V halves tiled H times (``heads``: layer
    prefix -> H), so the model computes what the checkpoint computes."""
    out = dict(flat)
    for key, w in flat.items():
        if key.endswith("attention.to_kv.kernel"):
            k, v = np.split(w, 2, axis=1)
            H = heads[key[: -len(".to_kv.kernel")]]
            out[key] = np.concatenate([k] * H + [v] * H, axis=1)
    return out


def attention_heads(model) -> dict:
    """layer prefix -> query heads, for every attention layer of a model."""
    from isp_tts_tpu_torch.nn.attention import Attention

    return {name: m.heads for name, m in model.named_modules() if isinstance(m, Attention)}


def mha_model():
    """The committed checkpoint as a multi-KV-head model, on the card, in
    eval mode: its config with ``one_kv_head: false`` in the encoder,
    decoder, predictor and feature embedding (6 x 384 with 6 heads x 64;
    3 x 256 and 1 x 256 with 4 heads), its weights with each layer's
    key/value head replicated."""
    from isp_tts_tpu_torch.checkpoint import load_checkpoint
    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig

    blob = load_checkpoint(CKPT)["model"]
    model = AcousticModel(build_config(AcousticModelConfig, multi_kv_head(blob["config"])))
    model.load_jax_state(replicate_kv_heads(blob["state"], attention_heads(model)))
    return model.to("cuda").eval()


def serve_requests(t0, synth, kernel: str) -> int:
    """The serving path: the three sentences one at a time, then as one
    batch, each request twice; launch counts zeroed just before and read
    just after. Checks the mels and that ``kernel`` launched and no other
    attention kernel did; returns its launches."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
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
    launches = {k: v for k, v in launch_counts().items() if v}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20

    budget = synth.config.frame_budgets[-1]
    mels = [m for out in outputs for m in out]
    for m in mels:
        if not (m.ndim == 2 and m.shape[1] == synth.model.mel_dim and 0 < m.shape[0] < budget
                and np.isfinite(m).all()):
            raise AssertionError(f"bad mel: shape {m.shape}, finite {np.isfinite(m).all()}")
    if set(launches) != {kernel}:
        raise AssertionError(f"the serving path should launch {kernel} alone: {launches}")
    say("slice", t0, "ms per request, first/second call (3 singles, then the batch "
        "of 3): " + ", ".join(f"{a:.1f}/{b:.1f}" for a, b in request_ms)
        + f"; frames {[m.shape[0] for m in mels]}; launches {launches} "
        f"({launches[kernel] / (2 * len(request_ms)):.1f} per synthesis); "
        f"peak memory {peak_mib:.1f} MiB")
    return launches[kernel]


def batch_draws(synth):
    """The three sentences as one padded batch, and flow noise from a seed."""
    import torch

    tokens, lens, fb, B = synth.prepare(SENTENCES)
    tok = torch.from_numpy(tokens).long().cuda()
    ln = torch.from_numpy(lens).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    noise = torch.randn((tok.shape[0], tok.shape[1], 3), generator=gen, device="cuda")
    return tok, ln, fb, B, noise


def kernel_vs_plain(t0, model, tok, ln, fb, B, noise, durations):
    """The model's mel on its kernels against the same model on the plain
    attention, same noise and durations; returns the kernel path's mel."""
    import torch

    mel_k, ad_k = model.infer(tok, ln, max_dec_len=fb, noise=noise,
                              duration_target=durations)
    set_flash(model, "off")
    try:
        mel_p, ad_p = model.infer(tok, ln, max_dec_len=fb, noise=noise,
                                  duration_target=durations)
    finally:
        set_flash(model, "auto")
    dec = ad_k.dec_lengths  # pad rows included: the decoder's calls see them
    mel_err = (mel_k - mel_p).abs().max().item()
    real = dec[:B]
    if not (torch.equal(dec, ad_p.dec_lengths) and (real > 0).all() and (real < fb).all()):
        raise AssertionError(f"dec_lengths {dec.tolist()} / {ad_p.dec_lengths.tolist()}, "
                             f"budget {fb}")
    if not (torch.isfinite(mel_k).all() and mel_err <= MEL_BOUND):
        raise AssertionError(f"kernel-path mel differs from the plain path by {mel_err:.3e}")
    say("slice", t0, f"kernel path vs plain path: mel max_err={mel_err:.3e} "
        f"bound={MEL_BOUND:.0e}, dec_lengths {real.tolist()} < budget {fb}")
    return mel_k


def phase_slice(t0):
    """The one-KV-head checkpoint served on K1. Returns the Synthesizer,
    K1's launches, and the batch, noise, durations and K1 mel that the
    multi-KV-head model is held to."""
    from isp_tts_tpu_torch.serving import Synthesizer

    synth = Synthesizer.from_pretrained(CKPT)
    say("slice", t0, f"loaded {CKPT.name} on {synth.device}: "
        f"{sum(p.numel() for p in synth.model.parameters())} parameters")
    launches = serve_requests(t0, synth, "K1 mqa_fwd")
    tok, ln, fb, B, noise = batch_draws(synth)
    _, ad = synth.model.infer(tok, ln, max_dec_len=fb, noise=noise)
    durations = ad.duration
    mel = kernel_vs_plain(t0, synth.model, tok, ln, fb, B, noise, durations)
    return synth, launches, (tok, ln, fb, B, noise, durations, mel)


def phase_slice_mha(t0, reference):
    """The multi-KV-head model served on K5a, held to its plain path and to
    the one-KV-head model's mel on K1 (``reference`` from phase_slice)."""
    from isp_tts_tpu_torch.serving import Synthesizer

    model = mha_model()
    synth = Synthesizer(model)
    heads = attention_heads(model)
    kv = {name: tuple(m.weight.shape) for name, m in model.named_modules()
          if name.endswith("layers.0.attention.to_kv")}
    say("slice", t0, f"multi-KV-head model from {CKPT.name}: "
        f"{sum(p.numel() for p in model.parameters())} parameters, {len(heads)} "
        f"attention layers, heads {sorted(set(heads.values()))}, to_kv weights {kv}")
    launches = serve_requests(t0, synth, "K5a flash_fwd")
    tok, ln, fb, B, noise, durations, mel_mqa = reference
    mel = kernel_vs_plain(t0, model, tok, ln, fb, B, noise, durations)
    err = (mel - mel_mqa).abs().max().item()
    if not err <= MEL_BOUND:
        raise AssertionError(f"multi-KV-head mel on K5a differs from the one-KV-head mel "
                             f"on K1 by {err:.3e}")
    say("slice", t0, f"multi-KV-head model on K5a vs the one-KV-head model on K1: mel "
        f"max_err={err:.3e} bound={MEL_BOUND:.0e}")
    return synth, launches


def hold_durations(synth, durations) -> None:
    """Every replica of ``synth`` infers on its rows of ``durations``
    (Bb, T), as the mel gates hold the durations."""
    n = len(synth.replicas)
    per = durations.shape[0] // n
    for i, (replica, dev) in enumerate(zip(synth.replicas, synth.devices)):
        rows = durations[i * per:(i + 1) * per].to(dev)
        infer = replica.infer
        replica.infer = (lambda *a, _infer=infer, _rows=rows, **k:
                         _infer(*a, duration_target=_rows, **k))


#: the Synthesizer over replicas against one device. Each replica's rows
#: against one device serving those rows alone (the same shapes, the same
#: kernels): equal but for this, the mel against its max-abs and the
#: waveform absolutely. Against one device serving the whole batch: the
#: mel against its max-abs within SERVE_WHOLE_BOUNDS["mel"], the waveform
#: within the vocoder's bound. A replica runs a share of the rows, and
#: cuBLAS picks other GEMM kernels for another row count, whose sums round
#: otherwise; the flow predictor and the pitch/energy embedding amplify that.
#: So the whole-batch mel bound sits just above one device's own gap between
#: a batch and its shards, which :func:`shard_gaps` reads in every run over
#: GAP_SEEDS: on an H100 (700 W) 64 readings (16 seeds; 3 and 8 sentences; 2
#: and 4 shards) spread 2.8e-6 to 5.87e-4, the gated draw (3 sentences, 2
#: shards, seed 0) 1.5e-4 (PERF.md section 6)
SERVE_SHARD_BOUND = 1e-6
SERVE_WHOLE_BOUNDS = {"mel": 7e-4, "wave": 1e-3}  # wave: the vocoder card-vs-CPU bound
GAP_SEEDS = range(16)


def one_device_references(one, texts, n, seed=0, audio=(False, True)):
    """``one`` (one device) on ``texts`` as one padded batch from
    ``seed``'s noise, on its own durations: the durations, and for each
    entry of ``audio`` the whole batch's output and that of its ``n`` equal
    shards each served alone (joined), as float32 numpy arrays."""
    import torch

    tokens, lens, fb, _ = one.prepare(texts)
    tok, ln = batch_tensors(tokens, lens)
    tok, ln = tok.to(one.device), ln.to(one.device)
    noise = one._noise(tokens.shape, seed)
    _, ad = one.model.infer(tok, ln, max_dec_len=fb, steps=one.config.steps, noise=noise)
    durations = ad.duration

    def run(rows, a):
        mel, _ = one.model.infer(tok[rows], ln[rows], max_dec_len=fb, steps=one.config.steps,
                                 noise=noise[rows], duration_target=durations[rows])
        return one._vocode(mel) if a else mel

    per = tokens.shape[0] // n
    shards = [slice(i * per, (i + 1) * per) for i in range(n)]
    shard = {a: torch.cat([run(r, a) for r in shards]).float().cpu().numpy() for a in audio}
    whole = {a: run(slice(None), a).float().cpu().numpy() for a in audio}
    return durations, shard, whole


def mel_rel_err(mels, ref) -> float:
    """The largest row error of ``mels`` against ``ref``'s rows, each
    against the reference row's max-abs."""
    return max(float(np.abs(m - ref[i, :len(m)]).max() / np.abs(ref[i]).max())
               for i, m in enumerate(mels))


def shard_gaps(one, texts, n, seeds=GAP_SEEDS) -> list[float]:
    """One device's own mel gap, per seed, between serving ``texts`` as one
    batch and as ``n`` shards, all on the whole batch's durations: what
    ``n`` replicas read against one device on the whole batch."""
    gaps = []
    for seed in seeds:
        _, shard, whole = one_device_references(one, texts, n, seed, audio=(False,))
        gaps.append(mel_rel_err(list(shard[False]), whole[False]))
    return gaps


def serve_over_devices(synth, one, texts) -> dict:
    """``synth`` (replicas over cards) against ``one`` (one device) on
    ``texts`` as one batch, f32, every call on the one device's durations:
    the replicas' mels and waveforms through the public calls, held to one
    device on each replica's rows and on the whole batch. Returns the
    errors, the frame counts and the replicas' K1 launches."""
    n = len(synth.devices)
    durations, shard, whole = one_device_references(one, texts, n)
    hold_durations(synth, durations)
    launch_counts(reset=True)
    mels, waves = synth(texts), synth.synthesize_audio(texts)
    launches = {k: v for k, v in launch_counts().items() if v}
    hop = synth._hop_length()
    frames = [m.shape[0] for m in mels]
    errs = {}
    for name, ref in (("shard", shard), ("whole", whole)):
        errs[name] = {
            "mel": mel_rel_err(mels, ref[False]),
            "wave": max(np.abs(w - ref[True][i, :len(w)]).max() for i, w in enumerate(waves))}
    same = all(np.array_equal(m, shard[False][i, :len(m)]) for i, m in enumerate(mels)) and \
        all(np.array_equal(w, shard[True][i, :len(w)]) for i, w in enumerate(waves))
    ok = (all(e <= SERVE_SHARD_BOUND for e in errs["shard"].values())
          and all(errs["whole"][k] <= SERVE_WHOLE_BOUNDS[k] for k in SERVE_WHOLE_BOUNDS)
          and [len(w) for w in waves] == [f * hop for f in frames]
          # CPU calls never count (a rehearsal on the CPU)
          and set(launches) == ({"K1 mqa_fwd"} if synth.device.type != "cpu" else set()))
    if not ok:
        raise AssertionError(f"{n} replicas against one device: errors {errs} (bounds "
                             f"{SERVE_SHARD_BOUND:.0e} on each replica's rows, "
                             f"{SERVE_WHOLE_BOUNDS} on the whole batch), frames {frames}, "
                             f"launches {launches}")
    return {"errs": errs, "bit_equal": same, "frames": frames, "launches": launches}


def phase_serve_devices(t0):
    """The Synthesizer over two replicas on the one card against one
    device (:func:`serve_over_devices`), on the three sentences; then one
    device's own batch-against-shards gaps (:func:`shard_gaps`) over
    GAP_SEEDS, two and four shards of the three sentences and two and four
    of eight training sentences, which SERVE_WHOLE_BOUNDS["mel"] rests on."""
    from isp_tts_tpu_torch.serving import Synthesizer

    one = Synthesizer.from_pretrained(CKPT, vocoder_path=VOCODER)
    two = Synthesizer.from_pretrained(CKPT, vocoder_path=VOCODER, devices=["cuda:0", "cuda:0"])
    r = serve_over_devices(two, one, SENTENCES)
    t = time.perf_counter()
    two(SENTENCES)
    mel_ms = 1e3 * (time.perf_counter() - t)
    say("serve-devices", t0, "Synthesizer(devices=['cuda:0', 'cuda:0']) against one device, 3 "
        "sentences, f32, the one device's durations: each replica's rows against one device "
        f"on them: mel rel {r['errs']['shard']['mel']:.3e}, wave {r['errs']['shard']['wave']:.3e}"
        f" (bound {SERVE_SHARD_BOUND:.0e}; bit-equal {r['bit_equal']}); the whole batch on one "
        f"device: mel rel {r['errs']['whole']['mel']:.3e}, wave {r['errs']['whole']['wave']:.3e}"
        f" (bounds {SERVE_WHOLE_BOUNDS}); frames {r['frames']}; launches {r['launches']}; a "
        f"warm mel request {mel_ms:.1f} ms")
    gaps = {f"{name} / {n}": shard_gaps(one, texts, n)
            for name, texts in (("3 sentences", SENTENCES), ("8 sentences", TRAIN_SENTENCES[:8]))
            for n in (2, 4)}
    worst = max(max(g) for g in gaps.values())
    say("serve-devices", t0, f"one device's mel gap, a batch against its shards, seeds "
        f"{GAP_SEEDS.start}-{GAP_SEEDS.stop - 1}: " + "; ".join(
            f"{k}: " + ", ".join(f"{g:.3e}" for g in v) for k, v in gaps.items())
        + f"; largest {worst:.3e} (the whole-batch bound {SERVE_WHOLE_BOUNDS['mel']:.0e})")
    if not worst <= SERVE_WHOLE_BOUNDS["mel"]:
        raise AssertionError(f"one device's batch-against-shards gap {worst:.3e} passed the "
                             f"whole-batch bound {SERVE_WHOLE_BOUNDS['mel']:.0e}")


def batch_tensors(tokens, lens):
    import torch

    return torch.from_numpy(tokens).long().cuda(), torch.from_numpy(lens).cuda()


def phase_profile(t0, run, label):
    """One warm call of ``run`` (a request, a training step) under
    torch.profiler: device busy time against its wall time, and the
    kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    rows = device_rows(prof)
    busy_ms = sum(r[0] for r in rows) / 1e3
    rows.sort(reverse=True)
    if busy_ms == 0:
        say("profile", t0, f"{label}: {wall_ms:.1f} ms under the profiler; device time "
            "not measured (the profiler saw no CUDA activity)")
        return 0.0
    top = "; ".join(f"{name[:60]} x{n} {us / 1e3:.3f} ms" for us, n, name in rows[:8])
    say("profile", t0, f"{label}: wall {wall_ms:.1f} ms under the profiler, device "
        f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%) in "
        f"{sum(r[1] for r in rows)} device calls; top: {top}")
    return busy_ms


def device_rows(prof) -> list[tuple]:
    """(device microseconds, calls, name) of a profile's device-side events
    (kernels, copies): a host op's own device total repeats the time of the
    kernels it launched, and so does a user-annotated range on the device
    timeline (the optimizer's step)."""
    return [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if "CUDA" in str(e.device_type) and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]




# ---------------------------------------------------------------- audio
VOCODER = ROOT / "docs/assets/scale_r5/vocoder_joint10k_r5.f16.ckpt"
# the committed vocoder on the card against the same vocoder on the CPU,
# f32, TF32 off: the waveform absolutely, the head output against its max-abs
VOCODER_WAVE_BOUND = 1e-3
VOCODER_HEAD_BOUND = 1e-4
# Griffin-Lim on the card against the CPU, same start phases, 32 iterations:
# the JAX package's bound between its two Griffin-Lim variants
GRIFFIN_LIM_BOUND = 2e-3
# mean |log-mel of the waveform - the mel it was made from| over a sentence's
# frames; the JAX package reads 0.29-0.38 (neural) and 0.44-0.48 (Griffin-Lim
# on the sentence's own frames) for this model on the CPU, and 0.226 for the
# vocoder on its own fine-tuning data
MEL_L1_BOUND = {"neural": 0.5, "griffin-lim": 0.6}


def mel_l1(audio, mel) -> float:
    from isp_tts_tpu_torch.ops.vocoder import log_mel_matmul

    return (log_mel_matmul(audio) - mel).abs().mean().item()


def phase_vocoder(t0, synth, reference):
    """The committed vocoder and the matmul Griffin-Lim on the card against
    the same on the CPU, on phase 6's padded batch mel; each waveform's
    re-analysed mel against the mel it was made from."""
    import torch

    from isp_tts_tpu_torch.models.vocoder import VocoderModel
    from isp_tts_tpu_torch.ops.vocoder import griffin_lim_matmul, mel_to_audio_tpu, mel_to_linear

    tok, ln, fb, B, noise, durations, _ = reference
    mel, ad = synth.model.infer(tok, ln, max_dec_len=fb, noise=noise, duration_target=durations)
    dec = ad.dec_lengths[:B].tolist()
    vocoder = VocoderModel.from_pretrained(VOCODER)
    cpu = VocoderModel.from_pretrained(VOCODER, device="cpu")
    say("vocoder", t0, f"loaded {VOCODER.name} on {next(vocoder.parameters()).device}: "
        f"{sum(p.numel() for p in vocoder.parameters())} parameters; mel {tuple(mel.shape)}")
    with torch.no_grad():
        head = vocoder.generator.spectrum(mel)
        head_cpu = cpu.generator.spectrum(mel.cpu())
    wave = vocoder.infer(mel)
    wave_cpu = cpu.infer(mel.cpu())
    head_err = (head.cpu() - head_cpu).abs().max().item() / head_cpu.abs().max().item()
    wave_err = (wave.cpu() - wave_cpu).abs().max().item()
    if not (torch.isfinite(wave).all() and wave.shape == (mel.shape[0], fb * 256)
            and wave_err <= VOCODER_WAVE_BOUND and head_err <= VOCODER_HEAD_BOUND):
        raise AssertionError(f"vocoder on the card vs the CPU: waveform {wave_err:.3e}, head "
                             f"{head_err:.3e} of max-abs, shape {tuple(wave.shape)}")
    say("vocoder", t0, f"card vs CPU: waveform max_err={wave_err:.3e} bound="
        f"{VOCODER_WAVE_BOUND:.0e}, head max_err={head_err:.3e} of max-abs bound="
        f"{VOCODER_HEAD_BOUND:.0e}")

    gen = torch.Generator().manual_seed(0)
    angles = torch.rand((B, 513, fb), generator=gen) * (2 * np.pi) - np.pi
    mag = mel_to_linear(mel[:B], 22050) ** 1.2
    gl = griffin_lim_matmul(mag, n_iter=32, angles=angles.cuda())
    gl_cpu = griffin_lim_matmul(mag.cpu(), n_iter=32, angles=angles)
    gl_err = (gl.cpu() - gl_cpu).abs().max().item()
    if not (torch.isfinite(gl).all() and gl_err <= GRIFFIN_LIM_BOUND):
        raise AssertionError(f"Griffin-Lim on the card vs the CPU: {gl_err:.3e}")
    say("vocoder", t0, f"griffin_lim_matmul card vs CPU, 32 iterations: max_err={gl_err:.3e} "
        f"bound={GRIFFIN_LIM_BOUND:.0e}")

    # the neural vocoder on the padded batch mel, as the Synthesizer runs
    # it; Griffin-Lim on each sentence's own frames, as the CLI runs it (the
    # padding's zero log-mel is loud, and 32 iterations spread it into the
    # tail: the JAX package reads 0.54-0.67 there on the padded mel)
    neural = torch.clamp(wave, -1, 1)
    waves = {"neural": [neural[i, : n * 256] for i, n in enumerate(dec)],
             "griffin-lim": [torch.clamp(mel_to_audio_tpu(mel[i:i + 1, :n]), -1, 1)[0]
                             for i, n in enumerate(dec)]}
    readings = {k: [mel_l1(w, mel[i, :n]) for i, (w, n) in enumerate(zip(ws, dec))]
                for k, ws in waves.items()}
    peaks = {k: [w.abs().max().item() for w in ws] for k, ws in waves.items()}
    for kind, l1 in readings.items():
        if not max(l1) <= MEL_L1_BOUND[kind]:
            raise AssertionError(f"{kind} waveforms re-analyse to mel L1 {l1}")
    say("vocoder", t0, "re-analysed mel L1 per sentence (frames "
        f"{dec}): neural {[round(x, 4) for x in readings['neural']]} bound "
        f"{MEL_L1_BOUND['neural']}, Griffin-Lim {[round(x, 4) for x in readings['griffin-lim']]} "
        f"bound {MEL_L1_BOUND['griffin-lim']}; peak |x| neural "
        f"{[round(x, 3) for x in peaks['neural']]}, Griffin-Lim "
        f"{[round(x, 3) for x in peaks['griffin-lim']]}")

    one = mel[:1, :256].contiguous()
    voc_ms = cuda_ms(lambda: vocoder.infer(one), iters=20)
    gl_ms = cuda_ms(lambda: mel_to_audio_tpu(one), iters=3, warmup=1)
    say("vocoder", t0, f"batch 1, 256 frames, f32: vocoder {voc_ms:.3f} ms, matmul "
        f"Griffin-Lim (32 iterations) {gl_ms:.3f} ms (CUDA events, eager)")


def phase_serve_audio(t0):
    """``Synthesizer.from_pretrained(CKPT, vocoder_path=VOCODER)`` after
    ``warmup(audio=True)``: the
    three sentences one at a time, as one batch and as one long-form text,
    each twice, K1's launches zeroed just before and read just after; every
    waveform finite, in [-1, 1], dec_len x 256 samples long. Returns the
    Synthesizer and K1's launches."""
    import torch

    from isp_tts_tpu_torch.serving import Synthesizer

    synth = Synthesizer.from_pretrained(CKPT, vocoder_path=VOCODER)
    t = time.perf_counter()
    synth.warmup(batch_sizes=(1, len(SENTENCES)), audio=True)
    say("serve audio", t0, f"warmup(audio=True) over {len(synth.config.text_buckets)} text "
        f"buckets x {len(synth.config.frame_budgets)} frame budgets x batch buckets 1 and 4: "
        f"{time.perf_counter() - t:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    request_ms, outputs = [], []
    calls = [(synth.synthesize_audio, s) for s in SENTENCES]
    calls += [(synth.synthesize_audio, SENTENCES), (synth.synthesize_long, " ".join(SENTENCES))]
    for fn, text in calls:
        pair = []
        for _ in range(2):
            t = time.perf_counter()
            out = fn(text)  # numpy on return: the device is done
            pair.append(1e3 * (time.perf_counter() - t))
        outputs.append(out)
        request_ms.append(pair)
    launches = {k: v for k, v in launch_counts().items() if v}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if set(launches) != {"K1 mqa_fwd"}:
        raise AssertionError(f"the audio path should launch K1 alone: {launches}")

    # the mel path with the same draws (a batch shape has its own noise)
    frames = [synth(s)[0].shape[0] for s in SENTENCES]
    batch_frames = [m.shape[0] for m in synth(SENTENCES)]
    singles, batch, long = outputs[:3], outputs[3], outputs[4]
    pause = int(0.25 * synth.sample_rate)
    for got, n in [(w[0], f) for w, f in zip(singles, frames)] + list(zip(batch, batch_frames)):
        if not (got.shape == (n * 256,) and np.isfinite(got).all() and np.abs(got).max() <= 1.0):
            raise AssertionError(f"bad waveform: {got.shape} for {n} frames")
    if long.shape != (sum(w.size for w in batch) + 2 * pause,):
        raise AssertionError(f"long-form waveform of {long.size} samples")
    say("serve audio", t0, "ms per request, first/second call (3 singles, the batch of 3, "
        "synthesize_long of 3): " + ", ".join(f"{a:.1f}/{b:.1f}" for a, b in request_ms)
        + f"; frames {frames} alone, {batch_frames} in the batch; samples "
        f"{[w.size for w in batch]}, long-form {long.size}; "
        f"launches {launches} ({launches['K1 mqa_fwd'] / (2 * len(calls)):.1f} per call); "
        f"peak memory {peak_mib:.1f} MiB")
    return synth, launches["K1 mqa_fwd"]


def phase_serve_bf16(t0, reference: list[np.ndarray]):
    """``weights_dtype="bf16"``: the acoustic model's weights stored in bf16
    on the card (their bytes halve) and computed in f32 as flax does; the
    three sentences' mels finite, their frame counts near the f32 model's
    (``reference``), K1 launched."""
    import torch

    from isp_tts_tpu_torch.serving import Synthesizer, SynthesizerConfig

    full = Synthesizer.from_pretrained(CKPT)
    f32_bytes = sum(p.numel() * p.element_size() for p in full.model.parameters())
    del full
    synth = Synthesizer.from_pretrained(CKPT, SynthesizerConfig(weights_dtype="bf16"))
    params = list(synth.model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params)
    launch_counts(reset=True)
    mels = synth(SENTENCES)
    launches = launch_counts()["K1 mqa_fwd"]
    if not (all(p.dtype == torch.bfloat16 for p in params) and 2 * nbytes == f32_bytes):
        raise AssertionError(f"bf16 weights take {nbytes} bytes against {f32_bytes} in f32")
    frames = [m.shape[0] for m in mels]
    ref = [m.shape[0] for m in reference]
    if not (all(np.isfinite(m).all() for m in mels) and launches
            and all(abs(a - b) <= 0.05 * b for a, b in zip(frames, ref))):
        raise AssertionError(f"bf16 weights: frames {frames} against {ref}, K1 {launches}")
    gap = max(float(np.abs(a[:min(len(a), len(b))] - b[:min(len(a), len(b))]).max())
              for a, b in zip(mels, reference))
    say("serve bf16", t0, f"acoustic weights {nbytes / 2**20:.1f} MiB in bf16 against "
        f"{f32_bytes / 2**20:.1f} MiB in f32; frames {frames} (f32 weights {ref}); mel max "
        f"|bf16 weights - f32 weights| {gap:.3f} over the common frames (not a gate: bf16 "
        f"rounding of the weights); K1 launches {launches}")


def phase_profile_audio(t0, synth):
    """One warm audio request under the profiler, then the vocoder alone on
    that request's padded mel: the vocoder's share of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    busy_ms = phase_profile(t0, lambda: synth.synthesize_audio(SENTENCES[0]),
                            "one sentence, audio")
    mel, _, _ = synth._synthesize_mel(SENTENCES[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        synth.vocoder.infer(mel)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    vocoder_ms = sum(r[0] for r in rows) / 1e3
    share = (f"{100 * vocoder_ms / busy_ms:.1f}% of the request's device time" if busy_ms
             else "share not measured")
    say("profile", t0, f"the vocoder alone on the request's padded mel {tuple(mel.shape)}: "
        f"device busy {vocoder_ms:.3f} ms in {sum(r[1] for r in rows)} device calls, {share}")


def phase_cli(t0):
    """``python -m isp_tts_tpu_torch.synthesize`` as a subprocess, with the
    vocoder and with Griffin-Lim: each writes a 22.05 kHz 16-bit mono WAV of
    frames x 256 samples, read back with ``wave``."""
    import re
    import tempfile
    import wave

    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_smoke_cli_") as tmp:
        for label, extra in (("vocoder", ["--vocoder", str(VOCODER)]), ("griffin-lim", [])):
            out = Path(tmp) / f"{label}.wav"
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "isp_tts_tpu_torch.synthesize", "--checkpoint",
                 str(CKPT), "--text", SENTENCES[0], "--output", str(out)] + extra,
                cwd=ROOT, capture_output=True, text=True, timeout=300)
            seconds = time.perf_counter() - t
            if proc.returncode != 0:
                raise AssertionError(f"synthesize ({label}) exited {proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            found = re.search(r"acoustic: (\d+) frames", proc.stderr)
            if found is None:
                raise AssertionError(f"synthesize ({label}) logged no frame count")
            frames = int(found.group(1))
            with wave.open(str(out), "rb") as w:
                params = (w.getframerate(), w.getsampwidth(), w.getnchannels(), w.getnframes())
                pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
            if params != (22050, 2, 1, frames * 256) or not np.abs(pcm).max() > 0:
                raise AssertionError(f"synthesize ({label}) wrote {params} for {frames} frames")
            say("cli", t0, f"{label}: {frames} frames -> {params[3]} samples at {params[0]} Hz, "
                f"16-bit mono, peak {np.abs(pcm).max() / 32767:.3f}; process {seconds:.1f} s")


DAEMON_WAV_REQUESTS = 8
#: the first request after a warm start against the second: at most this factor
DAEMON_FIRST_REQUEST_FACTOR = 2.0


def phase_daemon(t0, synth):
    """``TTSServer`` on 127.0.0.1, port 0, over the warmed audio Synthesizer:
    8 concurrent wav requests, one mel, one pcm, one streamed long-form
    request and /healthz; every answer 200, every WAV parses, and the
    concurrent requests coalesce (max_coalesced > 1)."""
    import io
    import threading
    import urllib.request
    import wave

    from isp_tts_tpu_torch.serving_server import ServerConfig, TTSServer

    server = TTSServer(synth, host="127.0.0.1", port=0,
                       config=ServerConfig(max_batch=DAEMON_WAV_REQUESTS, max_wait_ms=20.0,
                                           request_timeout_s=120.0))
    # --warmup's path: the serving (batcher) thread warms before the socket serves
    port = server.start(warmup=lambda: synth.warmup(batch_sizes=(1, DAEMON_WAV_REQUESTS),
                                                     audio=True))

    def post(payload, path="/synthesize"):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
            return resp.status, resp.headers.get("Content-Type"), body, \
                1e3 * (time.perf_counter() - t)

    try:
        # /healthz first: the client's own first urlopen and the HTTP
        # server's first handler, no device work
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            resp.read()
        # two lone requests: the batcher thread's first device calls
        lone_ms = [post({"text": SENTENCES[0], "format": "wav"})[3] for _ in range(2)]
        results: dict[int, tuple] = {}
        errors: list[BaseException] = []

        def call(i):
            try:
                results[i] = post({"text": SENTENCES[i % len(SENTENCES)], "format": "wav",
                                   "seed": 0})
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(DAEMON_WAV_REQUESTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        if errors or len(results) != DAEMON_WAV_REQUESTS:
            raise AssertionError(f"concurrent wav requests failed: {errors!r}")
        for i, (status, ctype, body, _) in sorted(results.items()):
            with wave.open(io.BytesIO(body)) as w:
                params = (w.getframerate(), w.getsampwidth(), w.getnchannels())
                n = w.getnframes()
            if status != 200 or ctype != "audio/wav" or params != (22050, 2, 1) or n % 256:
                raise AssertionError(f"wav request {i}: {status} {ctype} {params} {n}")
        singles = {"mel": post({"text": SENTENCES[0], "format": "mel"}),
                   "pcm": post({"text": SENTENCES[1], "format": "pcm"}),
                   "long": post({"text": " ".join(SENTENCES)}, path="/synthesize_long")}
        mel = np.load(io.BytesIO(singles["mel"][2]))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as resp:
            health = (resp.status, json.loads(resp.read()))
        stats = dict(server.stats)
    finally:
        server.stop()
    bad = {k: v[:2] for k, v in singles.items() if v[0] != 200}
    if bad or health[0] != 200 or not health[1]["ok"]:
        raise AssertionError(f"daemon answers: {bad}, healthz {health}")
    if not (mel.ndim == 2 and mel.shape[1] == 80 and np.isfinite(mel).all()):
        raise AssertionError(f"mel request gave {mel.shape}")
    if not (len(singles["pcm"][2]) % 512 == 0 and singles["long"][1].startswith("audio/L16")
            and len(singles["long"][2]) > 2 * 2 * int(0.25 * 22050)):
        raise AssertionError("pcm or long-form answers have the wrong size or type")
    if not stats["max_coalesced"] > 1 or stats["errors"]:
        raise AssertionError(f"daemon stats {stats}")
    if not lone_ms[0] <= DAEMON_FIRST_REQUEST_FACTOR * lone_ms[1]:
        raise AssertionError(f"the first request after warmup took {lone_ms[0]:.1f} ms, the "
                             f"second {lone_ms[1]:.1f} ms (bound {DAEMON_FIRST_REQUEST_FACTOR}x)")
    say("daemon", t0, f"two lone wav requests after start (warmed on the batcher thread), "
        f"ms: {lone_ms[0]:.1f}, {lone_ms[1]:.1f} (bound {DAEMON_FIRST_REQUEST_FACTOR}x); {DAEMON_WAV_REQUESTS} concurrent wav requests, ms: "
        + ", ".join(f"{results[i][3]:.1f}" for i in sorted(results))
        + "; mel {:.1f}, pcm {:.1f}, streamed long-form {:.1f} ({} bytes); ".format(
            singles["mel"][3], singles["pcm"][3], singles["long"][3], len(singles["long"][2]))
        + f"stats {stats}")


# ------------------------------------------------------- export and interop
#: the artifact's one shape: batch 1, text bucket 128, frame budget 1024
ARTIFACT_SHAPE = (1, 128, 1024)
#: the artifact's warm request against the live Synthesizer's at that shape
ARTIFACT_WARM_FACTOR = 2.0
ARTIFACT_CALLS = 5
#: (seed, duration_factor) of the artifact-vs-live comparisons
ARTIFACT_DRAWS = ((0, 1.0), (3, 1.2))


def artifact_live(synth):
    """A Synthesizer over ``synth``'s model and vocoder at the artifact's one
    shape: the live path an artifact call must reproduce."""
    from isp_tts_tpu_torch.serving import Synthesizer, SynthesizerConfig

    B, TB, FB = ARTIFACT_SHAPE
    return Synthesizer(synth.model, SynthesizerConfig(
        text_buckets=(TB,), frame_budgets=(FB,), batch_buckets=(B,)), vocoder=synth.vocoder)


def median_ms(fn, calls: int = ARTIFACT_CALLS) -> float:
    times = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()  # numpy on return: the device is done
        times.append(1e3 * (time.perf_counter() - t))
    return float(np.median(times))


def check_artifact(t0, label, ex, live, kernel, op):
    """One artifact on the card: its graph's registered attention nodes,
    its launches over one call (``kernel`` alone, one per node), its output
    against the live Synthesizer's for the same seeds and controls, and its
    warm time beside the live one's. Returns (launches, first-call ms)."""
    audio = ex.meta["output"] == "audio"
    run = (lambda s, **kw: ex(s, **kw)[0])
    live_run = ((lambda s, **kw: live.synthesize_audio(s, **kw)[0]) if audio
                else (lambda s, **kw: live(s, **kw)[0]))
    nodes = ex.kernel_nodes
    launch_counts(reset=True)
    t = time.perf_counter()
    run(SENTENCES[0])
    first_ms = 1e3 * (time.perf_counter() - t)
    launches = {k: v for k, v in launch_counts().items() if v}
    if nodes != {op: 25} or launches != {kernel: 25}:
        raise AssertionError(f"{label}: graph nodes {nodes}, launches over one call "
                             f"{launches}; want 25 of {op} / {kernel}")
    errs, equal = [], True
    for seed, df in ARTIFACT_DRAWS:
        got = run(SENTENCES[1], seed=seed, duration_factor=df)
        want = live_run(SENTENCES[1], seed=seed, duration_factor=df)
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"{label}: artifact output {got.shape}, live {want.shape}")
        errs.append(float(np.abs(got - want).max()))
        equal = equal and bool(np.array_equal(got, want))
    bound = VOCODER_WAVE_BOUND if audio else MEL_BOUND
    if not max(errs) <= bound:
        raise AssertionError(f"{label}: artifact vs live max_err {errs} > {bound:.0e}")
    warm = median_ms(lambda: run(SENTENCES[0]))
    live_run(SENTENCES[0])  # the live path's first call at this shape
    live_warm = median_ms(lambda: live_run(SENTENCES[0]))
    if not warm <= ARTIFACT_WARM_FACTOR * live_warm:
        raise AssertionError(f"{label}: warm artifact call {warm:.2f} ms > "
                             f"{ARTIFACT_WARM_FACTOR}x the live {live_warm:.2f} ms")
    say("export", t0, f"{label}: graph nodes {nodes}, launches over one call {launches}; "
        f"vs live (seed, duration_factor) {list(ARTIFACT_DRAWS)}: max_err {errs} "
        f"(bound {bound:.0e}, bit-identical {equal}); first call {first_ms:.1f} ms, warm "
        f"{warm:.2f} ms (median of {ARTIFACT_CALLS}) vs live warm {live_warm:.2f} ms "
        f"(bound {ARTIFACT_WARM_FACTOR}x)")
    return launches[kernel], first_ms


@contextlib.contextmanager
def no_nvcc():
    """Inside the block any kernel build raises: what runs there loads
    libraries that exist."""
    from isp_tts_tpu_torch.ops import cuda_build

    def refuse():
        raise AssertionError("nvcc was called")

    orig = cuda_build.nvcc_path
    cuda_build.nvcc_path = refuse
    try:
        yield
    finally:
        cuda_build.nvcc_path = orig


def phase_export(t0, synth, work: Path) -> int:
    """``export_serving`` of the audio Synthesizer (the committed checkpoint
    and vocoder) at ARTIFACT_SHAPE on the card with ``precompile``, loaded
    with nvcc refused: its embedded K1 library is loaded privately and
    serves its calls, and the shared build directory is left as it was.
    Then the same export made on the CPU with platforms cpu and cuda, moved
    to the card by its loader; then the daemon with ``--artifact`` in a
    fresh subprocess with nvcc refused and an empty build directory, where
    only the embedded library can serve. Returns the artifact's K1
    launches."""
    from isp_tts_tpu_torch.export import ExportedSynthesizer, export_serving
    from isp_tts_tpu_torch.ops import cuda_build
    from isp_tts_tpu_torch.ops.flash_attention import kernel_library
    from isp_tts_tpu_torch.serving import Synthesizer, SynthesizerConfig

    B, TB, FB = ARTIFACT_SHAPE
    live = artifact_live(synth)
    path = work / "audio.zip"
    t = time.perf_counter()
    meta = export_serving(live, path, TB, FB, batch=B, platforms=("cuda",), precompile=True)
    export_s = time.perf_counter() - t
    shared = {p.name: p.read_bytes() for p in cuda_build.BUILD_DIR.glob("*.so")}
    t = time.perf_counter()
    with no_nvcc():
        ex = ExportedSynthesizer(path)
    load_s = time.perf_counter() - t
    k1_lib = kernel_library("mqa_fwd", 64)
    own = ex._libs.get(k1_lib)
    if set(ex._libs) != {k1_lib} or own._handle == cuda_build.load(k1_lib)._handle:
        raise AssertionError(f"the artifact's embedded libraries {ex._libs} are not its own")
    say("export", t0, f"audio artifact {TB} x {FB} x batch {B}: export {export_s:.2f} s, "
        f"{path.stat().st_size / 1e6:.1f} MB (embedded kernels {meta['precompiled']}), "
        f"load {load_s:.2f} s with nvcc refused: its embedded K1 library loaded privately")
    with no_nvcc():
        launches, _ = check_artifact(t0, "audio artifact", ex, live, "K1 mqa_fwd",
                                     "isp_tts.mqa_fwd.default")
    if {p.name: p.read_bytes() for p in cuda_build.BUILD_DIR.glob("*.so")} != shared:
        raise AssertionError("loading and calling the artifact changed the shared build "
                             "directory")
    del ex

    cpu = Synthesizer.from_pretrained(CKPT, SynthesizerConfig(
        text_buckets=(TB,), frame_budgets=(FB,), batch_buckets=(B,)),
        vocoder_path=VOCODER, device="cpu")
    cpu_path = work / "audio_cpu.zip"
    t = time.perf_counter()
    export_serving(cpu, cpu_path, TB, FB, batch=B, platforms=("cpu", "cuda"))
    export_s = time.perf_counter() - t
    del cpu
    t = time.perf_counter()
    moved = ExportedSynthesizer(cpu_path)
    say("export", t0, f"the same exported on the CPU (platforms cpu, cuda): export "
        f"{export_s:.2f} s, load on the card (move_to_device_pass) "
        f"{time.perf_counter() - t:.2f} s")
    check_artifact(t0, "CPU-exported audio artifact on the card", moved, live, "K1 mqa_fwd",
                   "isp_tts.mqa_fwd.default")
    del moved
    phase_artifact_daemon(t0, path, work / "empty_build")
    return launches


#: runs the daemon in a fresh process whose kernel builds raise and whose
#: build directory is argv[1] (empty): only an artifact's embedded libraries
#: can serve its launches
NO_BUILD_DAEMON = """
import sys
from pathlib import Path
from isp_tts_tpu_torch.ops import cuda_build
def refuse():
    raise RuntimeError("nvcc refused")
cuda_build.nvcc_path = refuse
cuda_build.BUILD_DIR = Path(sys.argv[1])
from isp_tts_tpu_torch.serving_server import main
main(sys.argv[2:])
"""


def phase_artifact_daemon(t0, path: Path, build_dir: Path) -> None:
    """The daemon's ``--artifact`` (``serving_server.main``) in a fresh
    subprocess with nvcc refused and the empty ``build_dir`` as its build
    directory: /healthz, then one wav request, 200 and a 22.05 kHz WAV of a
    multiple of 256 samples, and ``build_dir`` still empty; the process is
    stopped after."""
    import io
    import socket
    import urllib.request
    import wave

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t = time.perf_counter()
    build_dir.mkdir(parents=True, exist_ok=True)
    if any(build_dir.iterdir()):
        raise AssertionError(f"{build_dir} is not empty")
    proc = subprocess.Popen([sys.executable, "-c", NO_BUILD_DAEMON, str(build_dir),
                             "--artifact", str(path), "--port", str(port), "--warmup"],
                            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    try:
        while True:
            if proc.poll() is not None:
                raise AssertionError(f"the artifact daemon exited {proc.returncode}: "
                                     f"{proc.stderr.read()[-2000:]}")
            if time.perf_counter() - t > 180:
                raise AssertionError("the artifact daemon did not answer /healthz in 180 s")
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                            timeout=5) as resp:
                    if resp.status == 200:
                        break
            except OSError:
                time.sleep(0.5)
        up_s = time.perf_counter() - t
        req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize",
                                     data=json.dumps({"text": SENTENCES[0],
                                                      "format": "wav"}).encode(),
                                     headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, ctype, body = resp.status, resp.headers.get("Content-Type"), resp.read()
        ms = 1e3 * (time.perf_counter() - t)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    with wave.open(io.BytesIO(body)) as w:
        params = (w.getframerate(), w.getsampwidth(), w.getnchannels())
        n = w.getnframes()
    if status != 200 or ctype != "audio/wav" or params != (22050, 2, 1) or not 0 < n \
            or n % 256:
        raise AssertionError(f"artifact daemon answer: {status} {ctype} {params} {n}")
    if any(build_dir.iterdir()):
        raise AssertionError(f"the artifact daemon wrote {list(build_dir.iterdir())}")
    say("export", t0, f"daemon --artifact (fresh subprocess, nvcc refused, empty build "
        f"directory: the embedded K1 library served): /healthz after {up_s:.1f} s, one wav "
        f"request {ms:.1f} ms, {n} samples; build directory still empty")


def phase_export_mha(t0, synth, work: Path) -> int:
    """The multi-KV-head model's mel artifact: K5a's nodes and launches, and
    its mel against the live path's. Returns its K5a launches."""
    from isp_tts_tpu_torch.export import ExportedSynthesizer, export_serving

    B, TB, FB = ARTIFACT_SHAPE
    live = artifact_live(synth)
    path = work / "mha.zip"
    t = time.perf_counter()
    export_serving(live, path, TB, FB, batch=B)
    export_s = time.perf_counter() - t
    ex = ExportedSynthesizer(path)
    say("export", t0, f"multi-KV-head mel artifact: export {export_s:.2f} s, "
        f"{path.stat().st_size / 1e6:.1f} MB")
    launches, _ = check_artifact(t0, "multi-KV-head mel artifact", ex, live, "K5a flash_fwd",
                                 "isp_tts.flash_fwd.default")
    path.unlink()
    return launches


def reference_semantics(cls, blob: dict, convert):
    """A model rebuilt from a ``.ckpt``'s config as a reference file's
    reader sees it (``convert`` maps the config), with the ``.ckpt``'s
    weights, on the card."""
    from isp_tts_tpu_torch.config import build_config

    model = cls(build_config(cls.Config, convert(blob["config"])))
    model.load_jax_state(blob["state"])
    return model.cuda().eval()


def phase_interop(t0, experiment, batch, reference, work: Path) -> None:
    """The committed checkpoint written as a reference ``.pt`` and the
    committed vocoder as a torch Vocos ``.pt``, both reloaded on the card:
    every tensor bit-equal to the ``.ckpt`` model's, and the outputs
    bit-equal to the ``.ckpt`` models read with the reference's semantics
    (erf GELU; Vocos's upper-only magnitude clip at log 100), on the slice's
    batch; then one training step of the trainer warm-started from the
    ``.pt`` against one warm-started from the ``.ckpt``."""
    import torch

    from isp_tts_tpu_torch.checkpoint import load_checkpoint, save_torch_checkpoint
    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.models.acoustic.interop import (export_torch_config,
                                                           import_torch_config)
    from isp_tts_tpu_torch.models.acoustic.loss import AcousticLossConfig, AcousticModelLoss
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel
    from isp_tts_tpu_torch.models.vocoder import VocoderModel
    from isp_tts_tpu_torch.models.vocoder.interop import save_torch_vocoder
    from isp_tts_tpu_torch.training.trainer import Trainer
    from isp_tts_tpu_torch.training.trainer_config import TrainerConfig

    tok, ln, fb, B, noise, _, _ = reference
    ckpt_model = AcousticModel.from_pretrained(CKPT)
    pt = work / "acoustic.pt"
    t = time.perf_counter()
    save_torch_checkpoint(ckpt_model, pt)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    pt_model = AcousticModel.from_pretrained(pt)
    load_s = time.perf_counter() - t
    own = ckpt_model.state_dict()
    same = [torch.equal(v, own[k]) for k, v in pt_model.state_dict().items()]
    blob = load_checkpoint(CKPT)["model"]
    exact = reference_semantics(AcousticModel, blob,
                                lambda c: import_torch_config(export_torch_config(c)))
    mel_pt, ad_pt = pt_model.infer(tok, ln, max_dec_len=fb, noise=noise)
    mel_ex, ad_ex = exact.infer(tok, ln, max_dec_len=fb, noise=noise)
    mel_ck, _ = ckpt_model.infer(tok, ln, max_dec_len=fb, noise=noise)
    if not (len(same) == len(own) and all(same) and torch.equal(mel_pt, mel_ex)
            and torch.equal(ad_pt.dec_lengths, ad_ex.dec_lengths)):
        raise AssertionError(f"reference .pt: {sum(same)} of {len(own)} tensors bit-equal; "
                             f"mel max_err {(mel_pt - mel_ex).abs().max().item():.3e}")
    say("interop", t0, f"reference .pt of {CKPT.name}: {pt.stat().st_size / 1e6:.1f} MB, "
        f"save {save_s:.2f} s, load on the card {load_s:.2f} s; {len(own)} tensors "
        f"bit-equal; mel on the slice batch bit-equal to the .ckpt model with erf GELU; "
        f"against the .ckpt model's own tanh GELU max_err "
        f"{(mel_pt - mel_ck).abs().max().item():.3e} (not a gate)")
    del exact, pt_model

    voc = VocoderModel.from_pretrained(VOCODER)
    vpt = work / "vocos.pt"
    save_torch_vocoder(voc, vpt)
    t = time.perf_counter()
    voc_pt = VocoderModel.from_pretrained(vpt)
    load_s = time.perf_counter() - t
    gen = voc.generator.state_dict()
    same = [torch.equal(v, gen[k]) for k, v in voc_pt.generator.state_dict().items()]
    vblob = load_checkpoint(VOCODER)["model"]
    voc_exact = reference_semantics(VocoderModel, vblob, lambda c: dict(c, generator=dict(
        c["generator"], gelu="exact", min_log_mag=None, max_log_mag=float(np.log(100.0)))))
    wav_pt, wav_ex = voc_pt.infer(mel_ck), voc_exact.infer(mel_ck)
    if not (len(same) == len(gen) and all(same) and torch.equal(wav_pt, wav_ex)):
        raise AssertionError(f"Vocos .pt: {sum(same)} of {len(gen)} generator tensors "
                             f"bit-equal; wave max_err {(wav_pt - wav_ex).abs().max().item():.3e}")
    wav_ck = voc.infer(mel_ck)
    say("interop", t0, f"Vocos .pt of {VOCODER.name}: {vpt.stat().st_size / 1e6:.1f} MB, load "
        f"on the card {load_s:.2f} s; {len(gen)} generator tensors bit-equal; waveform "
        f"bit-equal to the .ckpt vocoder with erf GELU and the upper-only clip; against its "
        f"own tanh GELU and clip max_err {(wav_pt - wav_ck).abs().max().item():.3e} "
        f"(not a gate)")
    del voc, voc_pt, voc_exact, ckpt_model

    results = {}
    for src in (CKPT, pt):
        torch.manual_seed(0)
        model = AcousticModel(build_config(AcousticModel.Config, blob["config"]))
        cfg = build_config(TrainerConfig, experiment["trainer"])
        cfg.resume_from_checkpoint, cfg.warm_start = str(src), True
        trainer = Trainer(model, AcousticModelLoss(build_config(
            AcousticLossConfig, experiment["criterion"])), cfg,
            generator=torch.Generator(device="cuda").manual_seed(7))
        loaded = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        metrics = trainer.train([batch], 1)
        results[src.suffix] = loaded, metrics
        del trainer, model
    (ck_state, ck_metrics), (pt_state, pt_metrics) = results[".ckpt"], results[".pt"]
    same = all(torch.equal(v, ck_state[k]) for k, v in pt_state.items())
    ck_loss, pt_loss = ck_metrics[-1]["loss"], pt_metrics[-1]["loss"]
    if not (same and np.isfinite(pt_loss)
            and abs(pt_loss - ck_loss) <= STEP_LOSS_BOUND * abs(ck_loss)):
        raise AssertionError(f"warm start from .pt: weights equal {same}, step loss "
                             f"{pt_loss} vs {ck_loss} from the .ckpt")
    say("interop", t0, f"trainer warm-started from the .pt: weights bit-equal to the .ckpt "
        f"warm start; one step's loss {pt_loss:.6f} vs {ck_loss:.6f} (equal "
        f"{pt_loss == ck_loss}, bound {STEP_LOSS_BOUND:.0e} relative)")
    torch.cuda.empty_cache()

# ---------------------------------------------------------------- training
# K2 against autograd through the plain K1: f32 sums in another order (the
# JAX package's bound for its kernel against its reference); bf16 gradients
# are rounded to 8 mantissa bits
K2_BOUNDS = {"float32": 1e-4, "bfloat16": 2e-2}
# the kernels' slope gradients against their formula in float64 on the same
# o and lse at the cross-attention offsets (:func:`check_backward`): K2/K5b
# read 1.2e-6-2.1e-6 in f32 and 7.0e-7-2.3e-6 in bf16 on an H100
SLOPES_F64_BOUNDS = {"float32": 1e-5, "bfloat16": 1e-5}
# a cross-attention layer's slope gradient on the kernels against the layer
# in float64 (:func:`cross_check`): 3.4e-6-5.6e-5 in f32, 1.7e-3-8.9e-3 in
# bf16 (the plain path's own 1.2e-5-3.6e-5 and 1.6e-3-1.3e-2) on an H100
LAYER_SLOPES_F64_BOUNDS = {"float32": 2e-4, "bfloat16": 3e-2}
# K4 against its plain version: both run the state recursion in f64, the
# kernel's transcendental tails in f32, the plain version's in f64
K4_LOSS_BOUND = 1e-5
K4_GRAD_BOUND = 1e-4
# one training step, kernel path against plain path (same weights,
# generators, dropout masks and noise). In f32 (TF32 off) the two differ
# only in the order of f32 sums: the step's own bounds, loss terms relative
# and every parameter's gradient against its max-abs.
STEP_LOSS_BOUND = 1e-3
STEP_GRAD_BOUND = 2e-2
# In bf16, the checkpoint's precision, the loss terms and the gradient norm
# keep those bounds. Single parameters' gradients do not: the two paths
# round attention outputs and gradients to bf16 at different points, a few
# tokens' MAS durations flip, and a gradient that is a sum with cancellation
# (the ALiBi log-slopes) moves by a large share of its max-abs. The limits
# for the whole gradient are set from readings on an H100 (700 W), between
# the kernel path's distance from the plain path and the control, bf16
# rounding alone (the plain path's bf16 step against its f32 step): near
# the geometric mean of the worst reading and the smallest control.
# First readings (f32 residual stream): top-level module gradient norms
# within 3.2e-3 and a gradient cosine of 0.99968, control 2.3e-2 and
# 0.9849: limits 1e-2 and 0.998. With the residual stream in bf16, as the
# JAX policy runs it, module norms read 8.5e-3 (one-KV-head model) and
# 1.0e-2 (multi-KV-head), cosines 0.99950 and 0.99972, controls 2.9e-2 and
# 3.5e-2, 0.9836 and 0.9784: the module limit is set again by the same
# rule to sqrt(1.0e-2 * 2.9e-2) = 1.7e-2; the cosine limit holds.
# Those readings were single steps, and a single bf16 step is chaotic: a
# one-ulp change in a few attention outputs flips later roundings through
# the bf16 residual stream, and a flipped MAS duration moves the duration
# targets, so two bf16 steps that differ only there move by a large share
# of the control, whatever the forward's accuracy. So the gate holds both
# bf16 paths to the f32 plain step's MAS alignment and compares the sums of
# BF16_DRAWS steps, each pair with its own generator seed (dropout masks,
# flow noise): the chaos of each draw is independent and shrinks in the
# sum, a fault of the kernels adds up. On an H100 (700 W), three batches:
# the tensor-core forwards read module norms 3.4e-3 to 8.8e-3 (one draw:
# up to 2.5e-2); on one batch the CUDA-core forwards they replaced 4.3e-3
# and 7.6e-3, attention outputs scaled by 1.01 2.6e-2 and 5.0e-2
# (tools/torch_fwd_study.py gates).
BF16_STEP_BOUNDS = {"loss": STEP_LOSS_BOUND, "norm": STEP_GRAD_BOUND, "module": 1.7e-2,
                    "cosine": 0.998}
BF16_DRAWS = 8
TRAIN_STEPS = 30
BATCH, TEXT_LEN, MEL_LEN = 32, 48, 320  # the checkpoint's own collation
TRAIN_SENTENCES = [
    "The box was thrown beside the truck.", "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.", "Four hours of steady work faced us.",
    "A large size in stockings is hard.", "The hogs were fed chopped corn.",
    "Help the woman get back to her feet.", "A pot of tea helps to pass the evening.",
    "Smoky fires lack flame and heat.", "The soft cushion broke the fall.",
    "The salt breeze came across the sea.", "The girl at the booth sold fifty bonds.",
    "The small pup gnawed a hole in the sock.", "The fish twisted and turned.",
    "Press the pants and sew a button.", "The swan dive was far short of perfect.",
    "The beauty of the view stunned the boy.", "Two blue fish swam in the tank.",
    "Her purse was full of useless trash.", "The colt reared and threw the rider.",
    "It snowed, rained, and hailed.", "Read verse out loud for pleasure.",
    "Hoist the load to your left shoulder.", "Take the winding path to reach the lake.",
    "Note closely the size of the gas tank.", "Wipe the grease off his dirty face.",
    "Mend the coat before you go out.", "The wrist was badly strained.",
    "The stray cat gave birth to kittens.", "The lazy cow lay in the cool grass.",
    "Lift the square stone over the fence.", "The rope will bind the seven books.",
    "The friendly gang left the store.", "Feel the heat of the weak dying flame.",
    "A pink shell was found on the beach.", "The sky that morning was clear.",
    "A stiff cord will do to fasten it.", "The wide road shimmered in the sun.",
    "The ship was torn apart on the reef.", "Sickness kept him home the third week.",
    "The term ended in late June.", "Bail the boat to stop it from sinking.",
    "Fill the ink jar with sticky glue.", "He ate four extra eggs for breakfast.",
    "We find joy in the simplest things.", "Type out three lists of orders.",
    "The mute muffled the high tones.", "The crunch of feet in the snow.",
]
K2_CASES = (  # B, N, M, H, dtype, rate, offset, causal
    [(32, 320, 320, H, "float32", rate, 0, False) for H in (6, 4) for rate in (0.0, 0.1)]
    + [(32, 320, 320, 6, "bfloat16", 0.1, 0, False),
       (2, 3072, 3072, 6, "float32", 0.1, 0, False),  # K2b's regime, M > 2048
       (4, 320, 320, 4, "float32", 0.1, 0, True),  # causal
       (4, 96, 224, 6, "float32", 0.1, 128, False)]  # offset
)


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def seed_tensor(value: int):
    import torch

    return torch.tensor([value], dtype=torch.int32, device="cuda")


def attention_grads(fn, q, k, v, slopes, key_lens, q_lens, rate, offset, causal, seed, w):
    """(dq, dk, dv, dslopes) of sum(fn(q, k, v, slopes, ...) * w), where
    ``fn`` is a differentiable attention: a kernel pair's autograd function
    or a plain version under autograd."""
    import torch

    args = [x.detach().clone().requires_grad_() for x in (q, k, v, slopes)]
    o = fn(*args, key_lens, q.shape[3] ** -0.5, offset, q_lens, causal, rate, seed)
    torch.autograd.backward(o, w)
    return [a.grad for a in args]


def mas_inputs(B, M, T, gen):
    """Aligner-like log-attention (a diagonal trend) and ragged lengths with
    mel_len >= text_len; row 0 full."""
    import torch

    i = torch.arange(M, device="cuda")[:, None] / M
    j = torch.arange(T, device="cuda")[None, :] / T
    logits = torch.randn((B, M, T), generator=gen, device="cuda") - 8.0 * (i - j) ** 2
    tl = torch.randint(max(T // 2, 1), T + 1, (B,), generator=gen, device="cuda",
                       dtype=torch.int32)
    ml = torch.randint(M // 2, M + 1, (B,), generator=gen, device="cuda", dtype=torch.int32)
    tl[0], ml[0] = T, M
    return logits.log_softmax(-1).contiguous(), tl, torch.maximum(ml, tl)


def ctc_inputs(B, M, T, gen):
    """The attention loss's input: a blank column of log-prob -1 in front of
    aligner-like logits, log-softmaxed over T+1."""
    import torch.nn.functional as F

    logits, tl, ml = mas_inputs(B, M, T, gen)
    return F.pad(logits, (1, 0), value=-1.0).log_softmax(-1).contiguous(), tl, ml


def mas_bound(la, tl, ml):
    """K3's bound: the valid map entries read once, the one-hot written once;
    a max, an add and a compare an entry."""
    B, M, T = la.shape
    valid = int((tl.long().clamp(0, T) * ml.long().clamp(0, M)).sum())
    return bound_ms(4 * valid + 4 * la.numel() + 8 * B, 3 * valid)


def ctc_frames(lp, ml) -> int:
    return int(ml.long().clamp(0, lp.shape[1]).sum())


def ctc_fwd_bound(lp, tl, ml):
    """K4 forward's bound: the map's valid frames read once, the f64 alphas
    written once; a (frame, state) takes a 2-way and a 3-way lse and two
    adds: 12 f64 operations (max, min, subtract, add) and 9 f32 (exp, log,
    add)."""
    B, _, W = lp.shape
    cells = ctc_frames(lp, ml) * W
    return bound_ms(20 * cells + 20 * B, {"float64": 12 * cells, "float32": 9 * cells})


def ctc_bwd_bound(lp, tl, ml):
    """K4 backward's bound: the map's valid frames and the alphas read once,
    the gradient written once; a (frame, state) takes the two occupancies,
    a 2-way and a 3-way lse and two adds: 18 f64 operations and 14 f32."""
    B, M, W = lp.shape
    cells = ctc_frames(lp, ml) * W
    return bound_ms(20 * cells + 4 * B * M * W + 24 * B,
                    {"float64": 18 * cells, "float32": 14 * cells})


def k4_pair(lp, tl, ml, g, plain=False):
    """(neg_logp, dlogprobs): K4's forward and backward, or its plain
    version (autograd through the float64 recursion)."""
    import torch

    from isp_tts_tpu_torch.ops import ctc

    if plain:
        x = lp.detach().double().requires_grad_()
        neg = ctc.ordered_ctc_neg_logp_reference(x, tl, ml)
        (dlp,) = torch.autograd.grad((neg * g.double()).sum(), x)
        return neg.detach().float(), dlp.float()
    neg, ab, al, logz = ctc.ctc_fwd(lp, tl, ml)
    return neg, ctc.ctc_bwd(lp, ab, al, logz, g, tl, ml)


def check_backward(q, k, v, slopes, key_lens, q_lens, w, offset=0, causal=False, rate=0.0,
                   seed=None, autograd=True, slopes_f64=False):
    """K2 (k and v (B, M, D)) or K5b (k and v (B, M, Hkv, D)) against its
    plain versions at the scale D ** -0.5, gradients against ``w`` = dL/do, relative to each
    reference's max-abs:
    - with ``autograd``, the kernel pair's autograd function against
      autograd through the plain forward: dq, dk, dv and dslopes. In bf16
      ds takes delta = rowsum(dO * O) on the o the forward saved in bf16, as
      the TPU kernels' residual is, which moves dslopes by 8e-4 to 6e-3
      against autograd through an f32 o on an H100
      (tests/test_torch_port_attention_bwd_bf16.py);
    - always, the kernel backward against the plain backward fed the kernel
      forward's saved o and lse: all four, one launch.
    With ``slopes_f64`` the slope gradients are held besides to the same
    formula in float64 (``tools/torch_bwd_seeds.py:f64_backward``), the
    kernel's distance from it within SLOPES_F64_BOUNDS; the kernel's and
    the plain backward's distances are appended to the plain-backward
    errors.
    Raises past the dtype's bound (K2_BOUNDS). Returns (name, autograd
    errors or None, plain-backward errors, bound, o, lse)."""
    import torch

    from isp_tts_tpu_torch.ops import flash_attention as fa

    mqa = k.dim() == 3
    name = "K2" if mqa else "K5b"
    attn, fwd, bwd, plain_fwd, plain_bwd = (
        (fa.mqa_attention, fa.mqa_fwd, fa.mqa_bwd, fa.mqa_attention_reference,
         fa.mqa_bwd_reference) if mqa else
        (fa.flash_attention, fa.flash_fwd, fa.flash_bwd, fa.flash_attention_reference,
         fa.flash_bwd_reference))
    seed = seed_tensor(0) if seed is None else seed
    bf16 = q.dtype == torch.bfloat16
    bound = K2_BOUNDS["bfloat16" if bf16 else "float32"]
    where = (f"{name} {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} rate={rate} "
             f"offset={offset} causal={causal}")
    auto = None
    if autograd:
        got = attention_grads(attn, q, k, v, slopes, key_lens, q_lens, rate, offset, causal,
                              seed, w)
        torch.cuda.synchronize()
        ref = attention_grads(lambda *a: plain_fwd(*a)[0], q, k, v, slopes, key_lens, q_lens,
                              rate, offset, causal, seed, w)
        auto = [rel_err(a, b) for a, b in zip(got, ref)]
        if not max(auto) <= bound:
            raise AssertionError(f"{where}: against autograd through the plain forward, "
                                 f"relative errors dq/dk/dv/dslopes {auto} > {bound:.0e}")
        del got, ref
    scale = q.shape[3] ** -0.5
    o, lse = fwd(q, k, v, slopes, key_lens, scale, offset, q_lens, causal, rate, seed)
    args = (q, k, v, slopes, key_lens, q_lens, seed, o, lse, w, scale, offset, causal, rate)
    before = bwd.launches
    got = bwd(*args)
    torch.cuda.synchronize()
    if bwd.launches != before + 1:
        raise AssertionError(f"{where}: {bwd.launches - before} launches")
    ref = plain_bwd(*args)
    if k.shape[1] == 1:
        # one key: p = 1 and ds = dp - delta = 0 in exact arithmetic, so dq,
        # dk and dslopes are rounding noise on both sides, held to the bound
        # on the scale of dv, the gradient that does not vanish (dslopes =
        # sum ds * dist on that scale times the largest distance)
        dv_max = ref[2].float().abs().max().clamp_min(1e-30)
        scales = [dv_max, dv_max, dv_max, dv_max * (q.shape[1] + abs(offset))]
        errs = [((a.float() - b.float()).abs().max() / (
            b.float().abs().max().clamp_min(1e-30) if i == 2 else scales[i])).item()
            for i, (a, b) in enumerate(zip(got, ref))]
    else:
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
    if not max(errs) <= bound:
        raise AssertionError(f"{where}: against the plain backward on the same o and lse, "
                             f"relative errors dq/dk/dv/dslopes {errs} > {bound:.0e}")
    if slopes_f64:
        sys.path.insert(0, str(ROOT / "tools"))
        from torch_bwd_seeds import f64_backward

        exact = f64_backward(q, k, v, slopes, key_lens, seed, o, lse, w, scale, offset,
                             causal, rate, not mqa)[3]
        errs += [rel_err(got[3], exact), rel_err(ref[3], exact)]
        f64_bound = SLOPES_F64_BOUNDS["bfloat16" if bf16 else "float32"]
        if not errs[4] <= f64_bound:
            raise AssertionError(f"{where}: dslopes {errs[4]:.3e} from float64 > "
                                 f"{f64_bound:.0e} (the plain backward {errs[5]:.3e})")
    return name, auto, errs, bound, o, lse


def grad_errs(tag: str, errs) -> str:
    return f"{tag} " + " ".join(f"{n}={e:.2e}" for n, e in zip(("dq", "dk", "dv", "dslopes"),
                                                                errs))


# K3 (B, M, T, a row of NEG_INF logits): the training shape and B 64, M 1024,
# T 192; T = 1, 32, 33 (one and two column blocks a lane), 256 and 257 (one
# warp, two), 6144 (24 warps, the widest the wrapper takes; choice bits in
# global memory), M 12000 (the bits past shared memory at a narrow T)
K3_CASES = [(32, 320, 48, False), (64, 1024, 192, False), (32, 320, 48, True),
            (8, 320, 1, False), (8, 320, 32, False), (8, 320, 33, False),
            (8, 320, 256, False), (8, 320, 257, False), (2, 1024, 6144, False),
            (2, 12000, 33, False)]
# K4 (B, M, T), W = T + 1 states, a warp per 32: the training shape and B 64,
# M 1024, T 192; W = 2, 33 (one warp, two), 256 and 257 (8 and 9 warps: the
# staging ring of 16 frames and of 8), 1024 (32 warps, the ring of 4; the
# widest the wrapper takes)
K4_CASES = [(32, 320, 48), (64, 1024, 192), (8, 320, 1), (8, 320, 32), (8, 320, 255),
            (8, 320, 256), (4, 1024, 1023)]


def phase_kernel_train(t0):
    """K1 with dropout, K2, K3 and K4 against their plain versions."""
    import torch

    from isp_tts_tpu_torch.ops import mas
    from isp_tts_tpu_torch.ops.flash_attention import (dropout_thresh, mqa_bwd,
                                                       mqa_bwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(3)
    scale = 64 ** -0.5
    for dt in ("float32", "bfloat16"):
        for rate in (0.1, 0.3):
            q, k, v, slopes, kl, ql = mqa_inputs(8, 320, 320, 6, getattr(torch, dt), True, gen)
            seed = seed_tensor(1234 + int(rate * 10))
            _, err, _, bound, kept, _ = check_forward(q, k, v, slopes, kl, ql, 0, False, rate,
                                                   seed)
            thresh = dropout_thresh(rate)
            say("kernel", t0, f"K1 dropout={rate} B=8 N=M=320 H=6 {dt} max_err={err:.3e} "
                f"bound={bound:.0e} kept={kept:.4f} thresh/256={thresh / 256:.4f}")

    for B, N, M, H, dt, rate, offset, causal in K2_CASES:
        q, k, v, slopes, kl, ql = mqa_inputs(B, N, M, H, getattr(torch, dt), False, gen)
        w = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        seed = seed_tensor(99)
        _, auto, errs, bound, o, lse = check_backward(q, k, v, slopes, kl, ql, w, offset,
                                                      causal, rate, seed)
        k_ms = graph_ms(lambda: mqa_bwd(q, k, v, slopes, kl, ql, seed, o, lse, w, scale,
                                        offset, causal, rate), iters=10)
        p_ms = cuda_ms(lambda: mqa_bwd_reference(q, k, v, slopes, kl, ql, seed, o, lse, w,
                                                 scale, offset, causal, rate), iters=3)
        l_ms = library_bwd_ms(q, k, v, slopes, kl, scale, offset, causal, w)
        b_ms, b_by = attention_bound(q, k, kl, ql, causal, offset, backward=True)
        say("kernel", t0, f"K2 B={B} N={N} M={M} H={H} {dt} dropout={rate} offset={offset} "
            f"causal={int(causal)} {grad_errs('vs autograd', auto)}"
            + f"; {grad_errs('vs plain backward', errs)} bound={bound:.0e} kernel_ms={k_ms:.4f} "
            f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by})")
        del q, k, v, o, lse
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    phase_edges_bwd(t0, gen, kv_heads=(None,))

    for B, M, T, neg_row in K3_CASES:
        la, tl, ml = mas_inputs(B, M, T, gen)
        if neg_row:
            la[1, 10] = -1e9  # a frame whose logits all sit at the DP's NEG_INF
        got = mas.monotonic_alignment_search(la, tl, ml)
        torch.cuda.synchronize()
        ref = mas.monotonic_alignment_search_reference(la, tl, ml)
        rows = ml.clamp(max=M).float()
        if not (torch.equal(got, ref) and torch.equal(got.sum(dim=(1, 2)), rows)):
            raise AssertionError(f"K3 B={B} M={M} T={T}: {(got != ref).sum().item()} "
                                 "elements differ from the plain version")
        say("kernel", t0, f"K3 B={B} M={M} T={T}{' NEG_INF row' if neg_row else ''}: "
            "equal to the plain version, durations sum to mel_len")
        del la, got, ref
    torch.cuda.empty_cache()

    for B, M, T in K4_CASES:
        lp, tl, ml = ctc_inputs(B, M, T, gen)
        g = torch.rand((B,), generator=gen, device="cuda")
        neg, dlp = k4_pair(lp, tl, ml, g)
        torch.cuda.synchronize()
        neg_r, dlp_r = k4_pair(lp, tl, ml, g, plain=True)
        loss_err, grad_err = rel_err(neg, neg_r), rel_err(dlp, dlp_r)
        if not (loss_err <= K4_LOSS_BOUND and grad_err <= K4_GRAD_BOUND):
            raise AssertionError(f"K4 B={B} M={M} T={T}: loss {loss_err:.3e} "
                                 f"(bound {K4_LOSS_BOUND:.0e}), gradient {grad_err:.3e} "
                                 f"(bound {K4_GRAD_BOUND:.0e})")
        say("kernel", t0, f"K4 B={B} M={M} T+1={T + 1} loss rel_err={loss_err:.2e} "
            f"bound={K4_LOSS_BOUND:.0e} grad rel_err={grad_err:.2e} bound={K4_GRAD_BOUND:.0e}")


def phase_tp_heads(t0):
    """K1/K2a and K5a/K5b at the fine-tuning shape (B 32, N = M = 320, 6
    heads, dropout 0.1), f32 and bf16: the whole call, then each half of
    its heads as a model split runs it (``head0``, ``heads_total`` in the
    dropout hash), held to the whole call's slices within the kernel
    phases' bounds (bit-equality reported)."""
    import torch

    from isp_tts_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(11)
    scale, rate, H = 64 ** -0.5, 0.1, 6
    for dt in ("float32", "bfloat16"):
        for kv in (None, H):
            mqa = kv is None
            fwd, bwd = (fa.mqa_fwd, fa.mqa_bwd) if mqa else (fa.flash_fwd, fa.flash_bwd)
            q, k, v, slopes, kl, ql = mqa_inputs(BATCH, MEL_LEN, MEL_LEN, H, getattr(torch, dt),
                                                 False, gen, kv_heads=kv)
            w = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
            seed = seed_tensor(4321)
            o, lse = fwd(q, k, v, slopes, kl, scale, 0, ql, False, rate, seed)
            dq, dk, dv, dsl = bwd(q, k, v, slopes, kl, ql, seed, o, lse, w, scale, 0, False,
                                  rate)
            # lse as (B, N, H) for both families
            lse_h = lse.reshape(BATCH, MEL_LEN, H) if mqa else lse.transpose(1, 2)
            f_bound = F32_BOUND if dt == "float32" else BF16_BOUND
            b_bound = K2_BOUNDS[dt]
            errs, exact, dk_sum, dv_sum = {}, True, torch.zeros_like(dk), torch.zeros_like(dv)
            before = (fwd.launches, bwd.launches)
            for h0 in (0, H // 2):
                hs = slice(h0, h0 + H // 2)
                kk, vv = (k, v) if mqa else (k[:, :, hs].contiguous(), v[:, :, hs].contiguous())
                args = (q[:, :, hs].contiguous(), kk, vv, slopes[:, hs].contiguous(), kl)
                o_p, lse_p = fwd(*args, scale, 0, ql, False, rate, seed, 0, h0, H)
                g = bwd(*args, ql, seed, o_p, lse_p, w[:, :, hs].contiguous(), scale, 0, False,
                        rate, 0, h0, H)
                lse_p = lse_p.reshape(BATCH, MEL_LEN, -1) if mqa else lse_p.transpose(1, 2)
                live = torch.isfinite(lse_h[:, :, hs])
                if not torch.equal(torch.isfinite(lse_p), live):
                    raise AssertionError(f"tp-heads {dt} heads {hs}: other dead rows")
                pairs = {"o": (o_p, o[:, :, hs]), "lse": (lse_p[live], lse_h[:, :, hs][live]),
                         "dq": (g[0], dq[:, :, hs]), "dslopes": (g[3], dsl[:, hs])}
                if not mqa:
                    pairs.update(dk=(g[1], dk[:, :, hs]), dv=(g[2], dv[:, :, hs]))
                else:
                    dk_sum += g[1].float()
                    dv_sum += g[2].float()
                for name, (a, b) in pairs.items():
                    errs[name] = max(errs.get(name, 0.0), rel_err(a, b))
                    exact = exact and torch.equal(a, b)
            if mqa:
                errs["dk sum"], errs["dv sum"] = rel_err(dk_sum, dk), rel_err(dv_sum, dv)
            torch.cuda.synchronize()
            launched = (fwd.launches - before[0], bwd.launches - before[1])
            bad = {n: e for n, e in errs.items()
                   if e > (f_bound if n in ("o", "lse") else b_bound)}
            name = "K1/K2a" if mqa else "K5a/K5b"
            if bad or launched != (2, 2):
                raise AssertionError(f"tp-heads {name} {dt}: halves against the whole call "
                                     f"{errs} past the bounds {f_bound:.0e} / {b_bound:.0e} "
                                     f"(forward / backward); launches {launched}")
            say("tp-heads", t0, f"{name} B={BATCH} N=M={MEL_LEN} H={H} {dt} dropout={rate}: "
                "two head halves (head0 0 and 3 of 6) against the whole call, relative "
                + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
                + f"; bounds {f_bound:.0e} / {b_bound:.0e}; slices bit-equal {exact}")
            del q, k, v, o, lse, dq, dk, dv, w
            torch.cuda.empty_cache()


K5_CASES = (  # B, N, M, H, Hkv, dtype, rate, offset, causal
    [(32, 320, 320, 6, 6, dt, rate, 0, False)
     for dt in ("float32", "bfloat16") for rate in (0.0, 0.1)]
    + [(32, 320, 320, 4, 4, "float32", 0.1, 0, False),  # the predictor's heads
       (4, 96, 224, 6, 6, "float32", 0.1, 128, True),  # causal, offset 128
       (32, 320, 320, 6, 1, "float32", 0.1, 0, False),  # one shared key/value head
       (2, 3072, 3072, 6, 6, "float32", 0.1, 0, False),  # long sequences
       (4, 1024, 1024, 6, 1, "bfloat16", 0.1, 0, False),  # bf16, one key/value head
       (4, 300, 300, 4, 1, "bfloat16", 0.1, -5, True)]
)


def phase_kernel_mha(t0):
    """K5a and K5b against their plain versions (the backward as
    :func:`check_backward` holds it), with ragged lengths and one key length
    of 0, and the kept share under dropout; each case timed beside its
    plain version, one PyTorch call and its bound; then K5a and K5b at the
    tile edges with H and with 1 key/value head."""
    import torch

    from isp_tts_tpu_torch.ops.flash_attention import (dropout_thresh,
                                                       flash_attention_reference,
                                                       flash_bwd, flash_bwd_reference,
                                                       flash_fwd)

    gen = torch.Generator(device="cuda").manual_seed(13)
    scale = 64 ** -0.5
    for B, N, M, H, Hkv, dt, rate, offset, causal in K5_CASES:
        dtype = getattr(torch, dt)
        q, k, v, slopes, kl, ql = mqa_inputs(B, N, M, H, dtype, False, gen, kv_heads=Hkv)
        if B > 2:
            kl[1] = 0  # a row with no key: every query row of it is dead
        seed = seed_tensor(4321)
        _, err, lse_err, bound, share, _ = check_forward(q, k, v, slopes, kl, ql, offset, causal,
                                                      rate, seed)
        kept = ""
        if rate:
            thresh = dropout_thresh(rate)
            kept = f" kept={share:.4f} thresh/256={thresh / 256:.4f}"
        w = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        _, auto, errs, b_bound, o, lse = check_backward(q, k, v, slopes, kl, ql, w, offset,
                                                        causal, rate, seed)
        big = N > 1024
        f_ms = graph_ms(lambda: flash_fwd(q, k, v, slopes, kl, scale, offset, ql, causal,
                                          rate, seed), iters=10)
        b_ms = graph_ms(lambda: flash_bwd(q, k, v, slopes, kl, ql, seed, o, lse, w, scale,
                                          offset, causal, rate), iters=10)
        fp_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, slopes, kl, scale, offset,
                                                          ql, causal, rate, seed),
                        iters=2 if big else 5, warmup=1)
        bp_ms = cuda_ms(lambda: flash_bwd_reference(q, k, v, slopes, kl, ql, seed, o, lse, w,
                                                    scale, offset, causal, rate),
                        iters=2 if big else 5, warmup=1)
        fl_ms = graph_ms(library_call(q, k, v, slopes, kl, scale, offset, causal), iters=5)
        bl_ms = library_bwd_ms(q, k, v, slopes, kl, scale, offset, causal, w,
                               iters=3 if big else 10)
        fb = attention_bound(q, k, kl, ql, causal, offset)
        bb = attention_bound(q, k, kl, ql, causal, offset, backward=True)
        say("kernel", t0, f"K5 B={B} N={N} M={M} H={H} Hkv={Hkv} {dt} dropout={rate} "
            f"offset={offset} causal={int(causal)}: K5a max_err={err:.3e} "
            f"lse_err={lse_err:.3e} bound={bound:.0e}{kept}; K5b "
            f"{grad_errs('vs autograd', auto)}"
            + f"; {grad_errs('vs plain backward', errs)} bound={b_bound:.0e}; K5a kernel_ms="
            f"{f_ms:.4f} plain_ms={fp_ms:.4f} library_ms={fl_ms:.4f} bound_ms={fb[0]:.4f} "
            f"({fb[1]}); K5b kernel_ms={b_ms:.4f} plain_ms={bp_ms:.4f} library_ms="
            f"{bl_ms:.4f} bound_ms={bb[0]:.4f} ({bb[1]})")
        del q, k, v, o, lse, w
        torch.cuda.empty_cache()
    phase_edges(t0, gen, kv_heads=(0, 1))
    phase_edges_bwd(t0, gen, kv_heads=(0, 1))


def training_batch(synth, gen):
    """The fixed fine-tuning batch, made on the card by the Synthesizer:
    the first 32 sentences of the pool with at most 48 tokens whose mel
    fits 320 frames (none is cut), their mels, frame counts and speakers,
    and dense pitch/energy targets: the per-token predictions repeated over
    the predicted durations. Returns (batch, token durations, sentences)."""
    import torch

    from isp_tts_tpu_torch.models.acoustic.adaptor import length_regulate_hard

    encoded = [(s, synth.text_provider(s)) for s in TRAIN_SENTENCES]
    encoded = [(s, e) for s, e in encoded if e.size <= TEXT_LEN]
    P = len(encoded)
    tokens = torch.zeros((P, TEXT_LEN), dtype=torch.long)
    lens = torch.zeros((P,), dtype=torch.int32)
    for i, (_, e) in enumerate(encoded):
        tokens[i, : e.size] = torch.from_numpy(e)
        lens[i] = e.size
    tokens, lens = tokens.cuda(), lens.cuda()
    speaker = (torch.arange(P, device="cuda") % synth.model.speaker_embedding.num_embeddings)
    noise = torch.randn((P, TEXT_LEN, 3), generator=gen, device="cuda")
    mel, ad = synth.model.infer(tokens, lens, max_dec_len=MEL_LEN, steps=synth.config.steps,
                                speaker=speaker, noise=noise)
    dec = ad.dec_lengths
    keep = [i for i in range(P) if 0 < int(dec[i]) < MEL_LEN][:BATCH]
    if len(keep) < BATCH:
        raise AssertionError(f"only {len(keep)} of {P} sentences fit {MEL_LEN} frames")
    idx = torch.tensor(keep, device="cuda")

    def dense(x):
        return length_regulate_hard(x[..., None], ad.duration, MEL_LEN)[0][..., 0]

    batch = {"text_vector": tokens[idx], "text_vector_len": lens[idx], "mel": mel[idx],
             "mel_len": dec[idx].to(torch.int32), "pitch": dense(ad.pitch)[idx],
             "energy": dense(ad.energy)[idx], "speaker": speaker[idx]}
    return batch, ad.duration[idx], [encoded[i][0] for i in keep]


def make_trainer(experiment: dict, plain: bool, seed: int, precision: str | None = None,
                 mha: bool = False):
    """The checkpoint fine-tuned with its own trainer and loss settings, on
    the kernel path or (``plain``) on every kernel's plain version: einsum
    attention, the plain MAS DP and the plain CTC scan. With ``mha`` the
    model is the multi-KV-head one (:func:`mha_model`)."""
    import torch

    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.models.acoustic.loss import AcousticLossConfig, AcousticModelLoss
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel
    from isp_tts_tpu_torch.training.trainer import Trainer
    from isp_tts_tpu_torch.training.trainer_config import TrainerConfig

    model = mha_model() if mha else AcousticModel.from_pretrained(CKPT)
    loss_cfg = build_config(AcousticLossConfig, experiment["criterion"])
    if plain:
        set_flash(model, "off")
        model.aligner.config.mas_impl = "scan"
        loss_cfg.attention_loss.ctc_impl = "scan"
    cfg = build_config(TrainerConfig, experiment["trainer"])
    if precision is not None:
        cfg.precision = precision
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return Trainer(model, AcousticModelLoss(loss_cfg), cfg, generator=gen)


def step_result(trainer, batch) -> dict:
    """One step's loss terms, gradient norm, (clipped) gradients and the
    aligner's MAS alignment and durations."""
    out = []
    hook = trainer.model.aligner.register_forward_hook(lambda m, i, o: out.append(o))
    _, losses, norm = trainer.compute_gradients(batch)
    hook.remove()
    return {"loss": {k: v.item() for k, v in losses.items()}, "norm": norm.item(),
            "grads": {n: p.grad.clone() for n, p in trainer.model.named_parameters()},
            "hard": out[0].attn_hard.detach(), "durations": out[0].attn_hard_duration.detach()}


@contextlib.contextmanager
def pinned_alignment(hard):
    """Inside the block the aligner's MAS (K3 or the plain DP, whichever
    the model runs) still runs, but the aligner takes ``hard`` as its
    alignment. MAS is a discrete argmax: a one-ulp change in its input can
    move a token's duration by a frame, which moves the duration targets
    and so the loss terms far more than the rounding that caused it."""
    from isp_tts_tpu_torch.models.acoustic import aligner

    saved = aligner.monotonic_alignment_search, aligner.monotonic_alignment_search_reference

    def pin(mas):
        def call(log_attn, text_lens, mel_lens):
            return hard.to(mas(log_attn, text_lens, mel_lens).dtype)
        return call

    aligner.monotonic_alignment_search, aligner.monotonic_alignment_search_reference = (
        pin(saved[0]), pin(saved[1]))
    try:
        yield
    finally:
        aligner.monotonic_alignment_search, aligner.monotonic_alignment_search_reference = saved


def summed(results: list[dict]) -> dict:
    """Several steps' results summed: loss terms, norms and gradients; the
    MAS durations side by side."""
    import torch

    return {"loss": {k: sum(r["loss"][k] for r in results) for k in results[0]["loss"]},
            "norm": sum(r["norm"] for r in results),
            "grads": {n: sum(r["grads"][n] for r in results) for n in results[0]["grads"]},
            "durations": torch.stack([r["durations"] for r in results])}


def step_diff(got: dict, ref: dict) -> dict:
    """``got`` against ``ref``: each loss term and the gradient norm
    (relative), each parameter's gradient against its max-abs (the worst
    one, and how many are within STEP_GRAD_BOUND), each top-level module's
    gradient norm (relative), the cosine between the whole gradients, and
    how many tokens' MAS durations differ."""
    loss = {k: abs(got["loss"][k] - v) / max(abs(v), 1e-12) for k, v in ref["loss"].items()}
    grads, sq, dot = {}, {}, 0.0
    for name, g in ref["grads"].items():
        mine, g = got["grads"][name].double(), g.double()
        scale = g.abs().max().item()
        grads[name] = (mine - g).abs().max().item() / scale if scale else 0.0
        top = sq.setdefault(name.split(".")[0], [0.0, 0.0])
        top[0] += mine.square().sum().item()
        top[1] += g.square().sum().item()
        dot += (mine * g).sum().item()
    worst = max(grads, key=grads.get)
    modules = {k: abs(a ** 0.5 - b ** 0.5) / b ** 0.5 if b else 0.0 for k, (a, b) in sq.items()}
    total = [sum(v[i] for v in sq.values()) for i in (0, 1)]
    return {"loss": loss, "norm": abs(got["norm"] - ref["norm"]) / ref["norm"],
            "worst": (worst, grads[worst]),
            "within": (sum(e <= STEP_GRAD_BOUND for e in grads.values()), len(grads)),
            "module": modules, "cosine": dot / (total[0] * total[1]) ** 0.5,
            "durations": int((got["durations"] != ref["durations"]).sum())}


def describe(errs: dict) -> str:
    return ("loss terms " + ", ".join(f"{k}={v:.1e}" for k, v in errs["loss"].items())
            + f"; grad norm {errs['norm']:.1e}; {errs['within'][0]} of {errs['within'][1]} "
            f"parameter gradients within {STEP_GRAD_BOUND:.0e} of their max-abs, worst "
            f"{errs['worst'][0]} {errs['worst'][1]:.1e}; module grad norms "
            + ", ".join(f"{k}={v:.2e}" for k, v in errs["module"].items())
            + f"; gradient cosine {errs['cosine']:.6f}; {errs['durations']} token "
            "durations differ")


def bf16_misses(errs: dict) -> list[str]:
    """The bf16 step's readings that are outside BF16_STEP_BOUNDS."""
    b = BF16_STEP_BOUNDS
    return ([f"loss {k} {v:.1e}" for k, v in errs["loss"].items() if v > b["loss"]]
            + ([f"grad norm {errs['norm']:.1e}"] if errs["norm"] > b["norm"] else [])
            + [f"module {k} {v:.1e}" for k, v in errs["module"].items() if v > b["module"]]
            + ([f"cosine {errs['cosine']:.6f}"] if errs["cosine"] < b["cosine"] else []))


def launch_counts(reset: bool = False) -> dict:
    from isp_tts_tpu_torch.ops import ctc, mas
    from isp_tts_tpu_torch.ops.flash_attention import flash_bwd, flash_fwd, mqa_bwd, mqa_fwd

    fns = {"K1 mqa_fwd": mqa_fwd, "K2 mqa_bwd": mqa_bwd,
           "K3 mas": mas.monotonic_alignment_search, "K4 ctc_fwd": ctc.ctc_fwd,
           "K4 ctc_bwd": ctc.ctc_bwd, "K5a flash_fwd": flash_fwd,
           "K5b flash_bwd": flash_bwd}
    if reset:
        for fn in fns.values():
            fn.launches = 0
    return {name: fn.launches for name, fn in fns.items()}


def phase_batch(t0, synth):
    """The fixed fine-tuning batch and the checkpoint's experiment config."""
    import torch

    from isp_tts_tpu_torch.checkpoint import load_checkpoint

    experiment = load_checkpoint(CKPT)["experiment"]["config"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch, durations, _ = training_batch(synth, gen)
    say("train", t0, f"batch of {BATCH} sentences ({len(TRAIN_SENTENCES)} in the pool): "
        f"tokens {batch['text_vector_len'].tolist()}, frames {batch['mel_len'].tolist()}")
    cfg = experiment["trainer"]
    say("train", t0, f"trainer: precision {cfg['precision']}, batch {cfg['batch_size']}, "
        f"optimization {cfg['optimization']}")
    return experiment, batch, durations


#: each path's attention kernels; the other path's must not launch on it
PATH_KERNELS = {False: ("K1 mqa_fwd", "K2 mqa_bwd"), True: ("K5a flash_fwd", "K5b flash_bwd")}


def bf16_step_readings(experiment, batch, mha=False, draws=BF16_DRAWS) -> dict:
    """The training step on the kernel path and on the plain path, same
    weights and batch, each pair with the same generator seed (dropout
    masks and flow noise): "f32", one f32 step against the other (seed 7);
    "bf16", the sum of ``draws`` bf16 steps (seeds 7, 8, ...) against the
    plain path's sum, every bf16 step on the f32 plain step's MAS alignment
    (:func:`pinned_alignment`); "bf16_sums", the same for the first 1, 2,
    ... draws; "control", the plain path's bf16 step against its f32 step
    (seed 7, same alignment), bf16 rounding alone."""
    def step(plain, precision, seed):
        return step_result(make_trainer(experiment, plain, seed, precision, mha=mha), batch)

    f32 = {plain: step(plain, "fp32", 7) for plain in (False, True)}
    with pinned_alignment(f32[True]["hard"]):
        bf16 = {plain: [step(plain, "bf16", 7 + i) for i in range(draws)]
                for plain in (False, True)}
    sums = [step_diff(summed(bf16[False][:k]), summed(bf16[True][:k]))
            for k in range(1, draws + 1)]
    return {"f32": step_diff(f32[False], f32[True]), "bf16": sums[-1], "bf16_sums": sums,
            "control": step_diff(bf16[True][0], f32[True])}


def phase_train(t0, experiment, batch, durations, mha=False):
    """The training path of the one-KV-head checkpoint (K1, K2) or, with
    ``mha``, of the multi-KV-head model (K5a, K5b); K3 and K4 on both."""
    import torch

    label = "train-mha" if mha else "train"
    # (a) one step, kernel path against plain path, in f32 and in bf16
    r = bf16_step_readings(experiment, batch, mha)
    errs = r["f32"]
    if not (max(errs["loss"].values()) <= STEP_LOSS_BOUND and errs["norm"] <= STEP_GRAD_BOUND
            and errs["worst"][1] <= STEP_GRAD_BOUND):
        raise AssertionError(f"kernel path vs plain path, f32 step: {errs}")
    say(label, t0, f"(a) one f32 step, kernel path vs plain path: {describe(errs)}; "
        f"bounds {STEP_LOSS_BOUND:.0e} / {STEP_GRAD_BOUND:.0e}")
    pinned = "on the f32 plain step's MAS alignment"
    say(label, t0, f"(a) control: one bf16 step vs the f32 step, plain path, {pinned}: "
        f"{describe(r['control'])}")
    say(label, t0, f"(a) one bf16 step, kernel path vs plain path, {pinned} (one draw, not "
        f"a gate): {describe(r['bf16_sums'][0])}")
    errs = r["bf16"]
    say(label, t0, f"(a) {BF16_DRAWS} bf16 steps (generator seeds 7-{6 + BF16_DRAWS}) summed, "
        f"kernel path vs plain path, {pinned}: {describe(errs)}; bounds {BF16_STEP_BOUNDS}")
    if bf16_misses(errs):
        raise AssertionError(f"kernel path vs plain path, bf16 step: {bf16_misses(errs)}")
    del r
    torch.cuda.empty_cache()

    # (b) the main path: 30 steps, counts zeroed just before, read just after
    kernel = make_trainer(experiment, False, 7, mha=mha)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    history, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        history += kernel.train([batch], 1)  # metrics come back as floats: synced
        step_ms.append(1e3 * (time.perf_counter() - t))
    launches = launch_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    mel = [h["model/mel_loss"] for h in history]
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"a metric went non-finite: {history}")
    if not np.mean(mel[-5:]) < np.mean(mel[:5]):
        raise AssertionError(f"mel loss did not fall: {mel}")
    path = PATH_KERNELS[mha] + ("K3 mas", "K4 ctc_fwd", "K4 ctc_bwd")
    if min(launches[k] for k in path) == 0 or any(launches[k] for k in PATH_KERNELS[not mha]):
        raise AssertionError(f"the training path should launch {path} and no other "
                             f"attention kernel: {launches}")
    warm = step_ms[5:]
    say(label, t0, f"(b) {TRAIN_STEPS} steps: mel_loss first 5 mean {np.mean(mel[:5]):.5f}, "
        f"last 5 mean {np.mean(mel[-5:]):.5f}; per step: "
        + ", ".join(f"{k}={history[-1][k]:.4f}" for k in history[-1]))
    say(label, t0, f"ms per step (steps 6-{TRAIN_STEPS}, host clock, synced) mean "
        f"{np.mean(warm):.1f} min {np.min(warm):.1f} max {np.max(warm):.1f}; first "
        f"{step_ms[0]:.1f}; peak memory {peak_mib:.1f} MiB; launches {launches}, per step "
        + str({k: v / TRAIN_STEPS for k, v in launches.items()}))

    # (c) MAS durations from the aligner
    outputs, _ = kernel.eval_step(batch)
    hard = outputs.aligner_output.attn_hard_duration
    ml = batch["mel_len"].float()
    if not torch.equal(hard.sum(dim=1), ml):
        raise AssertionError(f"durations sum to {hard.sum(dim=1).tolist()}, mel_len "
                             f"{ml.tolist()}")
    mask = torch.arange(TEXT_LEN, device="cuda")[None] < batch["text_vector_len"][:, None]
    gap = ((hard - durations).abs() * mask).sum() / mask.sum()
    say(label, t0, f"(c) MAS durations sum to mel_len in all {BATCH} rows; mean |MAS - "
        f"Synthesizer duration| {gap.item():.2f} frames per token (not a gate)")
    return kernel, launches


#: the distributed trainer at world size 1 against the plain trainer: equal,
#: or (a sum in another order) within this, relative
DIST_ONE_BOUND = 1e-6
DIST_ONE_STEPS = 3


def phase_dist_one(t0, experiment, batch):
    """An NCCL process group of world size 1, started in this process: the
    fine-tuning steps through the distributed trainer (the data group's
    bucketed all-reduce, rank 0's barriered save) against the same steps
    of the plain trainer, the K1-K4 launches alike."""
    import torch
    import torch.distributed as dist

    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.models.acoustic.loss import AcousticLossConfig, AcousticModelLoss
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel
    from isp_tts_tpu_torch.parallel.mesh import init_distributed
    from isp_tts_tpu_torch.training.trainer import Trainer
    from isp_tts_tpu_torch.training.trainer_config import TrainerConfig

    work = Path(tempfile.mkdtemp(dir=ROOT, prefix="_smoke_dist_"))
    runs = {}
    try:
        for distributed in (False, True):
            if distributed:
                init_distributed("nccl", init_method=f"file://{work / 'store'}", world_size=1,
                                 rank=0, local_rank=0)
            cfg = build_config(TrainerConfig, experiment["trainer"])
            cfg.output_dir = str(work)
            trainer = Trainer(AcousticModel.from_pretrained(CKPT), AcousticModelLoss(
                build_config(AcousticLossConfig, experiment["criterion"])), cfg,
                generator=torch.Generator(device="cuda").manual_seed(7))
            groups = dict(trainer.parallel_ctx.groups)
            launch_counts(reset=True)
            history = trainer.train([batch], DIST_ONE_STEPS)
            launches = launch_counts()
            name = f"checkpoint_{'dist' if distributed else 'plain'}.ckpt"
            trainer._save_checkpoint(name)
            params = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
            ckpt = (Path(trainer.run_dir) / name).read_bytes()
            runs[distributed] = (history, params, launches, ckpt, groups)
            del trainer
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(work, ignore_errors=True)
    (h0, p0, l0, f0, _), (h1, p1, l1, f1, groups) = runs[False], runs[True]
    metric_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(h1, h0)
                     for k in b)
    param_err = max(rel_err(p1[n], p0[n]) for n in p0)
    equal = metric_err == 0 and all(torch.equal(p1[n], p0[n]) for n in p0)
    same_file = f0 == f1
    path = ("K1 mqa_fwd", "K2 mqa_bwd", "K3 mas", "K4 ctc_fwd", "K4 ctc_bwd")
    if not (set(groups) == {"data"} and (equal or max(metric_err, param_err) <= DIST_ONE_BOUND)
            and l0 == l1 and min(l1[k] for k in path) > 0):
        raise AssertionError(f"world-size-1 NCCL trainer against the plain trainer: groups "
                             f"{sorted(groups)}, metrics {metric_err:.3e}, parameters "
                             f"{param_err:.3e} (bound {DIST_ONE_BOUND:.0e}), launches {l1} "
                             f"vs {l0}")
    say("dist-one", t0, f"{DIST_ONE_STEPS} fine-tuning steps through an NCCL process group of "
        f"world size 1 against the plain trainer: bit-equal {equal} (metrics rel "
        f"{metric_err:.3e}, parameters rel {param_err:.3e}, bound {DIST_ONE_BOUND:.0e}); "
        f"checkpoints byte-equal {same_file}; launches {l1} in both; losses "
        + ", ".join(f"{h['loss']:.6f}" for h in h1))


#: f32 fine-tuning steps with flash: ring on a size-1 seq axis against the
#: kernel path, loss and gradient norm relative: above the sound runs'
#: largest reading (7.6e-5 on the card); a ring whose slope gradient is
#: dropped reads 9.2e-5 there, so the gradient gate below is the one that
#: catches it (the planted run prints both)
RING_STEP_BOUND = 5e-4
#: the first of those steps' gradients, each tensor's gap relative to its
#: max-abs on the kernel path: the sound ring reads 3.5e-5 on the card, the
#: planted one 1.0 on the slopes
RING_GRAD_BOUND = 3e-4
SEQ_STAGE_STEPS = 3
#: the virtual ring of 2 and 4 ranks against the ring of one, f32, with dropout
VIRTUAL_RING_BOUND = 1e-5
SEQ_STAGE_TIMED = 5
#: the bf16 ring against K1: 2 bf16 ulps (2 x 2^-8) of the output's max-abs
RING_BF16_ULPS = 2 * 2.0 ** -8


def stacked_config(config: dict) -> dict:
    """A model config with the decoder's layer stack stored stacked."""
    return dict(config, decoder=dict(config["decoder"], pipeline=True))


def stacked_model(path=None):
    """The committed checkpoint (or ``path``'s) with a stacked decoder, its
    per-layer weights translated, on the card in train mode."""
    from isp_tts_tpu_torch.checkpoint import load_checkpoint
    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig

    blob = load_checkpoint(path or CKPT)["model"]
    model = AcousticModel(build_config(AcousticModelConfig, stacked_config(blob["config"])))
    model.load_jax_state(blob["state"])
    return model.cuda()


def recipe_trainer_on(model, experiment: dict, precision: str | None = None, seed: int = 7,
                      **ctx):
    """The fine-tuning trainer over ``model`` (``ctx``: parallel-context
    fields of its one-process layout, such as a size-1 seq axis)."""
    import dataclasses

    import torch

    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.models.acoustic.loss import AcousticLossConfig, AcousticModelLoss
    from isp_tts_tpu_torch.training.trainer import Trainer
    from isp_tts_tpu_torch.training.trainer_config import TrainerConfig

    cfg = build_config(TrainerConfig, experiment["trainer"])
    if precision is not None:
        cfg.precision = precision
    trainer = Trainer(model, AcousticModelLoss(build_config(AcousticLossConfig,
                                                            experiment["criterion"])), cfg,
                      generator=torch.Generator(device="cuda").manual_seed(seed))
    if ctx:
        trainer.parallel_ctx = dataclasses.replace(trainer.parallel_ctx, **ctx)
    return trainer


def ring_model():
    """The committed checkpoint with ``flash: ring`` in the encoder and the
    decoder (acoustic/core_sp's setting)."""
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel

    model = AcousticModel.from_pretrained(CKPT)
    set_flash(model.encoder, "ring")
    set_flash(model.decoder, "ring")
    return model


@contextlib.contextmanager
def planted_slope_fault(on: bool):
    """With ``on``, every ring attention runs with its ALiBi slopes
    detached: a ring whose slope gradient is lost, for the gates to catch."""
    import isp_tts_tpu_torch.nn.attention as attention

    ring = attention.ring_attention
    if on:
        attention.ring_attention = (lambda q, k, v, slopes, *a, **kw:
                                    ring(q, k, v, slopes.detach(), *a, **kw))
    try:
        yield
    finally:
        attention.ring_attention = ring


def phase_seq_stage(t0, experiment, batch):
    """The seq and stage axes on one card: the ring on a size-1 seq axis
    against K1, the virtual ring, the stacked decoder and its checkpoint,
    f32 ring steps against the kernel path, and each recipe setting's
    launches, host ms per step and peak memory."""
    import torch

    from isp_tts_tpu_torch.checkpoint import load_checkpoint
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel
    from isp_tts_tpu_torch.nn.attention import Attention
    from isp_tts_tpu_torch.ops import flash_attention as fa
    from isp_tts_tpu_torch.ops.ring_attention import ring_attention, ring_attention_virtual
    from isp_tts_tpu_torch.serving import Synthesizer

    gen = torch.Generator(device="cuda").manual_seed(31)
    B, N, H, scale = BATCH, MEL_LEN, 6, 64 ** -0.5
    for dtype in ("float32", "bfloat16"):
        q, k, v, slopes, key_lens, q_lens = mqa_inputs(B, N, N, H, getattr(torch, dtype),
                                                        False, gen)
        k3, v3 = k[:, :, None], v[:, :, None]

        def ring():
            return ring_attention(q, k3, v3, slopes, key_lens, scale, q_lens=q_lens)

        def k1():
            return fa.mqa_fwd(q, k, v, slopes, key_lens, scale, 0, q_lens, False, 0.0,
                              seed_tensor(0))[0]

        ref = k1().float()
        err = (ring().float() - ref).abs().max().item()
        # bf16: both round o to bf16 after their own sums, up to 2 bf16
        # ulps apart at the largest output
        bound = F32_BOUND if dtype == "float32" else RING_BF16_ULPS * ref.abs().max().item()
        ring_ms, k1_ms = cuda_ms(ring, iters=10), cuda_ms(k1, iters=10)
        say("seq-stage", t0, f"ring attention on a seq axis of size 1 against K1, B {B} x N "
            f"{N} x {H} heads, {dtype}: o max err {err:.3e} (bound {bound:.2e}); ring "
            f"{ring_ms:.4f} ms (einsum chunk products), K1 {k1_ms:.4f} ms")
        if not err <= bound:
            raise AssertionError(f"the ring against K1 in {dtype}: {err:.3e}")
    q, k, v, slopes, key_lens, q_lens = mqa_inputs(B, N, N, H, torch.float32, False, gen)
    k3, v3 = k[:, :, None], v[:, :, None]
    drop = dict(q_lens=q_lens, dropout_rate=0.1, seed=seed_tensor(5), remat=False)
    one = ring_attention(q, k3, v3, slopes, key_lens, scale, **drop)
    errs = {S: (ring_attention_virtual(q, k3, v3, slopes, key_lens, scale, shards=S, **drop)
                - one).abs().max().item() / one.abs().max().item() for S in (2, 4)}
    say("seq-stage", t0, f"virtual ring of 2 and 4 ranks against the ring of one, f32, "
        f"dropout 0.1: rel err {errs} (bound {VIRTUAL_RING_BOUND:.0e})")
    if max(errs.values()) > VIRTUAL_RING_BOUND:
        raise AssertionError(f"the virtual ring moved: {errs}")
    del q, k, v, k3, v3, one

    work = Path(tempfile.mkdtemp(dir=ROOT, prefix="_smoke_stack_"))
    try:
        stacked = stacked_model().eval()
        path = work / "stacked.ckpt"
        stacked.save_pretrained(path)
        saved = load_checkpoint(path)["model"]["state"]
        committed = load_checkpoint(CKPT)["model"]["state"]
        per_layer = AcousticModel.from_pretrained(CKPT)
        per_layer.load_jax_state(saved)
        back = per_layer.jax_state()
        reloaded = AcousticModel.from_pretrained(path).jax_state()
        ok = (set(back) == set(committed) and all(np.array_equal(back[n], committed[n])
                                                  for n in committed)
              and all(np.array_equal(reloaded[n], saved[n]) for n in saved))
        synths = [Synthesizer.from_pretrained(p) for p in (CKPT, path)]
        mels = [synth(SENTENCES) for synth in synths]
        if [m.shape for m in mels[0]] != [m.shape for m in mels[1]]:
            raise AssertionError("the stacked checkpoint serves other frame counts")
        mel_err = max(float(np.abs(b - a).max() / np.abs(a).max()) for a, b in zip(*mels))
        warm = []
        for synth in synths:  # warm: each has served the sentences once above
            t = time.perf_counter()
            synth(SENTENCES)
            warm.append(1e3 * (time.perf_counter() - t))
        say("seq-stage", t0, f"stacked decoder checkpoint ({sum('.stack.' in n for n in saved)} "
            f"stacked tensors) saved, reloaded stacked and translated per-layer: bit-equal "
            f"{ok}; Synthesizer.from_pretrained on it (the local stacked path) against the "
            f"per-layer checkpoint on {len(SENTENCES)} sentences: mel rel err {mel_err:.3e} "
            f"(bound {MEL_BOUND:.0e}); warm ms stacked {warm[1]:.2f}, per-layer {warm[0]:.2f}")
        if not ok or mel_err > MEL_BOUND:
            raise AssertionError("the stacked checkpoint does not carry the per-layer one")
        del stacked, per_layer, mels, synths
    finally:
        shutil.rmtree(work, ignore_errors=True)

    hist, grads = {}, {}
    for name, model, ctx in (("kernels", AcousticModel.from_pretrained(CKPT), {}),
                             ("ring", ring_model(), {"seq_axis": "seq"}),
                             ("planted", ring_model(), {"seq_axis": "seq"})):
        for m in model.modules():  # the ring hashes another index than K1: no attention dropout
            if isinstance(m, Attention):
                m.dropout.rate = 0.0
        trainer = recipe_trainer_on(model.train(), experiment, "fp32", **ctx)
        with planted_slope_fault(name == "planted"):
            hist[name] = trainer.train([batch], 1)
            grads[name] = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                           if p.grad is not None}
            hist[name] += trainer.train([batch], SEQ_STAGE_STEPS - 1)
        del trainer, model

    def step_gaps(run):
        return [max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                    for k in ("loss", "stats/grad_norm"))
                for a, b in zip(hist[run], hist["kernels"])]

    def grad_gap(run):
        return max((((grads[run][n] - g).abs().max()
                     / g.abs().max().clamp_min(1e-30)).item(), n)
                   for n, g in grads["kernels"].items())

    gaps, grad_err = step_gaps("ring"), grad_gap("ring")
    fault_gaps, fault_grad = step_gaps("planted"), grad_gap("planted")
    say("seq-stage", t0, f"{SEQ_STAGE_STEPS} f32 fine-tuning steps, attention dropout off, "
        f"flash: ring on a size-1 seq axis (encoder and decoder) against the kernel path: "
        f"largest relative loss / gradient-norm gap per step {[f'{g:.3e}' for g in gaps]} "
        f"(bound {RING_STEP_BOUND:.0e}); step 1's largest gradient gap {grad_err[0]:.3e} of "
        f"its tensor's max-abs ({grad_err[1]}; bound {RING_GRAD_BOUND:.0e}); losses ring "
        + ", ".join(f"{h['loss']:.6f}" for h in hist["ring"]) + ", kernels "
        + ", ".join(f"{h['loss']:.6f}" for h in hist["kernels"]))
    say("seq-stage", t0, f"planted fault, the ring's slope gradient dropped: loss / gradient-"
        f"norm gap per step {[f'{g:.3e}' for g in fault_gaps]}, step 1's largest gradient gap "
        f"{fault_grad[0]:.3e} ({fault_grad[1]}): caught "
        f"{max(fault_gaps) > RING_STEP_BOUND or fault_grad[0] > RING_GRAD_BOUND}")
    if max(gaps) > RING_STEP_BOUND or grad_err[0] > RING_GRAD_BOUND:
        raise AssertionError(f"ring steps against the kernel path: {gaps}, {grad_err}")
    if not fault_grad[0] > RING_GRAD_BOUND:
        raise AssertionError(f"the gradient gate misses a dropped slope gradient: {fault_grad}")

    settings = (("acoustic/core", lambda: AcousticModel.from_pretrained(CKPT).train(), {}),
                ("acoustic/core_sp", lambda: ring_model().train(), {"seq_axis": "seq"}),
                ("acoustic/core_pp", lambda: stacked_model().train(),
                 {"stage_axis": "stage", "n_micro": 4}))
    readings = {}
    for recipe, build, ctx in settings:
        trainer = recipe_trainer_on(build(), experiment, **ctx)
        trainer.train([batch], 2)
        torch.cuda.synchronize()
        launch_counts(reset=True)
        trainer.train([batch], 1)
        launches = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(SEQ_STAGE_TIMED):
            t = time.perf_counter()
            trainer.train([batch], 1)  # the metrics come back as floats: synced
            ms.append(1e3 * (time.perf_counter() - t))
        peak = torch.cuda.max_memory_allocated() / 2**20
        readings[recipe] = {"launches": launches, "ms": ms, "peak_mib": peak}
        say("seq-stage", t0, f"{recipe}'s attention and layer-stack setting on one card "
            f"({ctx or 'no axes'}), bf16 step of the fine-tuning batch: launches in one step "
            f"{launches}; host ms per step {[round(x, 2) for x in ms]} (median "
            f"{np.median(ms):.2f}); peak memory {peak:.0f} MiB")
        path = ("K1 mqa_fwd", "K2 mqa_bwd", "K3 mas", "K4 ctc_fwd", "K4 ctc_bwd")
        if min(launches[k] for k in path) == 0:
            raise AssertionError(f"{recipe}: a kernel of the path did not launch: {launches}")
        del trainer
        torch.cuda.empty_cache()
    return readings


#: fp32 steps run with TF32 off and cuDNN's deterministic algorithms
#: (Trainer.precision_scope): two runs of the same steps are bit-equal on the
#: card, and the process's settings come back after
TF32_STEPS = 2


def tf32_settings() -> tuple:
    import torch

    b = torch.backends
    return b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic


def phase_tf32(t0, experiment, batch):
    """``precision: fp32`` on the card, from PyTorch's defaults (cuDNN's
    TF32 on, cuBLAS's off, cuDNN free to pick any algorithm): TF32 off and
    deterministic cuDNN inside the step, the defaults back after it, two
    runs bit-equal; f32 ms per step in the fp32 scope, with TF32 off alone
    and with the defaults, interleaved."""
    import torch

    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel

    backends = torch.backends
    smoke_settings = tf32_settings()
    defaults = (True, False, False)
    seen: list = []
    runs = []
    try:
        (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
         backends.cudnn.deterministic) = defaults
        for _ in range(2):
            trainer = recipe_trainer_on(AcousticModel.from_pretrained(CKPT).train(),
                                        experiment, "fp32")
            hook = trainer.model.register_forward_pre_hook(
                lambda m, a: seen.append(tf32_settings()))
            history = trainer.train([batch], TF32_STEPS)
            hook.remove()
            runs.append((history, {n: p.detach().clone()
                                   for n, p in trainer.model.named_parameters()}))
            del trainer
        after = tf32_settings()
        equal = runs[0][0] == runs[1][0] and all(torch.equal(runs[0][1][n], runs[1][1][n])
                                                 for n in runs[0][1])
        gap = max(rel_err(runs[0][1][n], runs[1][1][n]) for n in runs[0][1])
        @contextlib.contextmanager
        def tf32_off_only():
            saved = tf32_settings()
            backends.cudnn.allow_tf32 = backends.cuda.matmul.allow_tf32 = False
            try:
                yield
            finally:
                (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
                 backends.cudnn.deterministic) = saved

        trainers = {}
        for label, scope in (("fp32 scope", None), ("TF32 off only", tf32_off_only),
                             ("defaults", contextlib.nullcontext)):
            trainer = recipe_trainer_on(AcousticModel.from_pretrained(CKPT).train(),
                                        experiment, "fp32")
            if scope is not None:
                trainer.precision_scope = scope
            trainer.train([batch], 2)
            trainers[label] = trainer
        times = {label: [] for label in trainers}
        for _ in range(SEQ_STAGE_TIMED):  # interleaved: the host's drift falls on each alike
            for label, trainer in trainers.items():
                t = time.perf_counter()
                trainer.train([batch], 1)
                times[label].append(1e3 * (time.perf_counter() - t))
        del trainers, trainer
    finally:
        (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
         backends.cudnn.deterministic) = smoke_settings
    say("tf32", t0, f"precision fp32 from PyTorch's defaults {defaults} (cuDNN TF32, cuBLAS "
        f"TF32, cuDNN deterministic): inside the step {sorted(set(seen))}, after {after}; two "
        f"runs of {TF32_STEPS} steps bit-equal {equal} (parameters rel {gap:.3e}); f32 host ms "
        f"per step, interleaved: "
        + "; ".join(f"{label} {[round(x, 2) for x in ms]} (median {np.median(ms):.2f})"
                    for label, ms in times.items()))
    if set(seen) != {(False, False, True)} or after != defaults or not equal:
        raise AssertionError("fp32 steps: TF32 not off inside, not restored, or not repeatable")
    return times


#: the multi-KV-head step's to_kv gradient, summed over its head blocks,
#: against the one-KV-head step's: f32 sums in another order (K5b sums dk/dv
#: per head then over heads, K2 over folded rows and splits). With both
#: models on the same K and V (kv_grad_errors' pin) it reads 6e-7 to 1.2e-6
#: on an H100 over three batches; with each model's own to_kv GEMM, 8.5e-6
#: to 1.3e-4 for the same kernels (tools/torch_fwd_study.py gates)
#: the interface phase: tokens decoded through the KV cache, the batch, and
#: the cross-attention shapes (B, mel frames N, text tokens M)
DECODE_TOKENS, DECODE_BATCH = 256, 4
CROSS_SHAPES = ((8, 320, 48), (4, 1024, 192))


def bf16_ulps(scale: float, ulps: int = 2) -> float:
    """``ulps`` bf16 ulps at the binade of ``scale`` (8 significant bits)."""
    import math

    return ulps * 2.0 ** (math.floor(math.log2(max(scale, 1e-30))) - 7)


def causal_decoder(mha: bool):
    """The committed checkpoint's decoder (6 layers x 384, 6 heads x 64),
    every layer causal, on the card in eval mode: one key/value head, or
    with ``mha`` one a query head (its ``to_kv`` tiled: :func:`mha_model`)."""
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel
    from isp_tts_tpu_torch.nn.attention import Attention

    model = mha_model() if mha else AcousticModel.from_pretrained(CKPT)
    for m in model.decoder.modules():
        if isinstance(m, Attention):
            m.causal = True
    return model.decoder


def decode_tokens(dec, x) -> tuple:
    """x (B, T, dim) decoded one token a call through the layers' KV
    caches: (the outputs (B, T, dim) f32, host ms a token, the launch
    counts of the decode, zeroed just before it and read just after)."""
    import torch

    torch.cuda.synchronize()
    launch_counts(reset=True)
    t = time.perf_counter()
    cache, outs = None, []
    for i in range(x.shape[1]):
        step = dec(x[:, i:i + 1], cache=cache, return_cache=True)
        cache = step.cache
        outs.append(step.out)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t) / x.shape[1]
    return torch.cat(outs, dim=1).float(), ms, launch_counts()


def decode_check(t0, dec, kernel: str, dtype) -> None:
    """DECODE_TOKENS tokens decoded one a call through the layers' KV
    caches (K1 or K5a at N = 1, M = t, offset t - 1, causal):
    - against the same decode with the layers at ``flash: off`` (the
      kernel's plain version at each call's shapes, no launch): f32 within
      F32_BOUND, bf16 (under autocast) within 2 ulps of the output's scale
      (BF16_BOUND is less than one ulp of a decoder output ~5);
    - against the full causal call through the same kernel: f32 within
      1e-4 of the output's max-abs, bf16 within 2 ulps of it;
    - the decode's launches, counts zeroed just before and read just
      after: the kernel 6 x DECODE_TOKENS times, no other attention kernel."""
    import torch

    from isp_tts_tpu_torch.nn.attention import Attention

    label = "bf16" if dtype == torch.bfloat16 else "f32"
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((DECODE_BATCH, DECODE_TOKENS, dec.emb_dim), generator=gen, device="cuda")
    depth = len(dec.layers)
    layers = [m for m in dec.modules() if isinstance(m, Attention)]
    modes = [m.flash for m in layers]
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16,
                                         enabled=dtype == torch.bfloat16):
        full = dec(x).float()
        inc, ms, launches = decode_tokens(dec, x)
        set_flash(dec, "off")
        try:
            plain, plain_ms, plain_launches = decode_tokens(dec, x)
        finally:
            for m, mode in zip(layers, modes):
                m.flash = mode
    scale = full.abs().max().item()
    err = (inc - full).abs().max().item()
    plain_err = (inc - plain).abs().max().item()
    bound = 1e-4 * scale if dtype == torch.float32 else bf16_ulps(scale)
    plain_bound = F32_BOUND if dtype == torch.float32 else bf16_ulps(scale)
    want = depth * DECODE_TOKENS
    others = {k: v for k, v in launches.items() if k != kernel and k.startswith(("K1", "K2",
                                                                                  "K5"))}
    say("interface", t0, f"decode {kernel} {label}: {DECODE_TOKENS} tokens x B {DECODE_BATCH} "
        f"through {depth} layers' caches vs the same decode at flash off (plain version, "
        f"{sum(plain_launches.values())} launches, {plain_ms:.3f} ms per token): max_err "
        f"{plain_err:.3e} (bound {plain_bound:.3e}); vs the full causal call: max_err "
        f"{err:.3e} (scale {scale:.3f}, bound {bound:.3e}); launches {launches[kernel]} (want "
        f"{want}); {ms:.3f} ms per token (host clock, synced)")
    if not (np.isfinite(plain_err) and plain_err <= plain_bound):
        raise AssertionError(f"decode {kernel} {label} vs its plain version: {plain_err:.3e} "
                             f"> {plain_bound:.3e}")
    if not (np.isfinite(err) and err <= bound):
        raise AssertionError(f"decode {kernel} {label}: {err:.3e} > {bound:.3e}")
    if launches[kernel] != want or any(others.values()) or any(plain_launches.values()):
        raise AssertionError(f"decode {kernel} {label}: launches {launches}, want {want}; "
                             f"at flash off {plain_launches}")
    del full, inc, plain


def cross_check(t0, layer, kernel: str, B, N, M, dtype) -> None:
    """Cross-attention of ``layer`` (non-causal, its own weights, x (B, N)
    against a context (B, M), ragged ``mask`` and ``context_mask``) under
    ``flash: on`` (K1/K2 or K5a/K5b at offset M - N) against ``flash:
    off`` (their plain versions): the output and the gradients of x, the
    context and every weight but the slopes within the edge phases' bounds
    (F32_BOUND, BF16_BOUND on the output; K2_BOUNDS on gradients, relative
    to each one's max-abs). The slopes' gradient is held instead against
    the same layer at ``flash: off`` in float64 (its plain versions in
    float64), within LAYER_SLOPES_F64_BOUNDS: it is a sum with cancellation
    of ds times distances, on which the f32 paths each read up to ~6e-5
    from float64 and so up to ~9e-5 from each other, and in bf16 both take
    delta on an o rounded to bf16; the ``off`` path's distance from float64
    is read. The ``on`` call launches each kernel once, the ``off`` calls
    none."""
    import copy

    import torch

    gen = torch.Generator(device="cuda").manual_seed(N + M)
    dim = layer.to_q.in_features
    x = torch.randn((B, N, dim), generator=gen, device="cuda")
    ctx = torch.randn((B, M, dim), generator=gen, device="cuda")
    w = torch.randn((B, N, dim), generator=gen, device="cuda")
    mask = torch.arange(N, device="cuda")[None] < torch.randint(
        N // 2, N + 1, (B,), generator=gen, device="cuda")[:, None]
    cmask = torch.arange(M, device="cuda")[None] < torch.randint(
        M // 2, M + 1, (B,), generator=gen, device="cuda")[:, None]
    mask[0], cmask[0] = True, True
    bf16 = dtype == torch.bfloat16
    results = {}
    for mode in ("on", "off", "f64"):
        run = layer
        if mode == "f64":
            run = copy.deepcopy(layer).double()
        run.flash = "off" if mode == "f64" else mode
        run.zero_grad(set_to_none=True)
        wide = torch.float64 if mode == "f64" else torch.float32
        xi, ci = (t.to(wide, copy=True).requires_grad_() for t in (x, ctx))
        launch_counts(reset=True)
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=bf16 and mode != "f64"):
            out = run(xi, mask=mask, context=ci, context_mask=cmask)
        (out.to(wide) * w.to(wide)).sum().backward()
        torch.cuda.synchronize()
        grads = {"x": xi.grad, "context": ci.grad,
                 **{n: p.grad for n, p in run.named_parameters()}}
        results[mode] = (out.float().detach(), grads, launch_counts())
        del run
    layer.flash = "auto"
    out_err = (results["on"][0] - results["off"][0]).abs().max().item()
    errs = {n: rel_err(g, results["off"][1][n]) for n, g in results["on"][1].items()}
    slope_err = errs.pop("rel_pos.log_slopes")
    exact = results["f64"][1]["rel_pos.log_slopes"]
    slope_f64 = rel_err(results["on"][1]["rel_pos.log_slopes"], exact)
    plain_f64 = rel_err(results["off"][1]["rel_pos.log_slopes"], exact)
    worst = max(errs, key=errs.get)
    grad_err = errs[worst]
    out_bound = BF16_BOUND if bf16 else F32_BOUND
    grad_bound = K2_BOUNDS["bfloat16" if bf16 else "float32"]
    slope_bound = LAYER_SLOPES_F64_BOUNDS["bfloat16" if bf16 else "float32"]
    launches = results["on"][2]
    fwd, bwd = PATH_KERNELS[kernel == "K5a flash_fwd"]
    say("interface", t0, f"cross-attention {fwd.split()[0]}/{bwd.split()[0]} "
        f"{'bf16' if bf16 else 'f32'} B {B} x mel {N} vs text {M} (offset {M - N}), flash on "
        f"vs off: out max_err {out_err:.3e} (bound {out_bound:.0e}), gradients of x, "
        f"context, weights max rel {grad_err:.3e} ({worst}; bound {grad_bound:.0e}), slopes "
        f"{slope_err:.3e} (read); slopes' gradient from the float64 layer: on {slope_f64:.3e} "
        f"(bound {slope_bound:.0e}), off {plain_f64:.3e} (read); launches {fwd} "
        f"{launches[fwd]}, {bwd} {launches[bwd]}; plain path launched "
        f"{sum(results['off'][2].values()) + sum(results['f64'][2].values())}")
    if not (out_err <= out_bound and grad_err <= grad_bound and slope_f64 <= slope_bound):
        raise AssertionError(f"cross-attention {kernel} on vs off: {out_err:.3e}, "
                             f"{grad_err:.3e}; slopes from float64 {slope_f64:.3e}")
    if (launches[fwd] != 1 or launches[bwd] != 1 or sum(results["off"][2].values())
            or sum(results["f64"][2].values())):
        raise AssertionError(f"cross-attention launches: on {launches}, off "
                             f"{results['off'][2]}, float64 {results['f64'][2]}")


def phase_interface(t0):
    """The attention layer's interface at full width, one key/value head
    (K1/K2) and H (K5a/K5b): the KV-cache decode, cross-attention under
    ``flash: on`` (the kernels held against their plain versions at offset
    M - N, forward and backward), and the plain masked path of an explicit
    attention mask."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    for mha in (False, True):
        dec = causal_decoder(mha)
        kernel = PATH_KERNELS[mha][0]
        for dtype in (torch.float32, torch.bfloat16):
            decode_check(t0, dec, kernel, dtype)
        # the kernels alone at the cross-attention shapes, against their plain versions
        for B, N, M in CROSS_SHAPES:
            for dt in ("float32", "bfloat16"):
                q, k, v, slopes, kl, ql = mqa_inputs(B, N, M, 6, getattr(torch, dt), False, gen,
                                                     kv_heads=6 if mha else None)
                name, err, lse_err, bound, _, plain_err = check_forward(
                    q, k, v, slopes, kl, ql, M - N, False, 0.1, seed_tensor(5), exact=True)
                w = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
                bname, auto, errs, bbound, _, _ = check_backward(
                    q, k, v, slopes, kl, ql, w, M - N, False, 0.1, seed_tensor(6),
                    slopes_f64=True)
                say("interface", t0, f"{name}/{bname} cross B={B} N={N} M={M} offset={M - N} "
                    f"{dt} dropout=0.1: vs the plain forward in float64 o max_err {err:.3e} "
                    f"lse_err {lse_err:.3e} (bound {bound:.0e}; the plain forward in f32 "
                    f"{plain_err:.3e}); {grad_errs('vs autograd', auto)}; "
                    f"{grad_errs('vs plain backward', errs)} (bound {bbound:.0e}); dslopes "
                    f"from float64: kernel {errs[4]:.3e} (bound "
                    f"{SLOPES_F64_BOUNDS[dt]:.0e}), plain {errs[5]:.3e}")
                del q, k, v, w
        layer = dec.layers[0].attention.train()
        layer.causal = False
        layer.dropout.rate = 0.0
        for B, N, M in CROSS_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                cross_check(t0, layer, kernel, B, N, M, dtype)
        # an explicit attention mask runs the plain masked path: a causal
        # mask given as one equals the kernels' causal call
        layer.eval()
        x = torch.randn((4, 320, layer.to_q.in_features), generator=gen, device="cuda")
        mask = torch.arange(320, device="cuda")[None] < torch.tensor([320, 250, 180, 300],
                                                                     device="cuda")[:, None]
        with torch.no_grad():
            launch_counts(reset=True)
            masked = layer(x, mask=mask, attention_mask=torch.ones(
                (320, 320), dtype=torch.bool, device="cuda").tril())
            plain_launches = sum(launch_counts().values())
            layer.causal = True
            ref = layer(x, mask=mask)
        err = rel_err(masked, ref)
        say("interface", t0, f"explicit causal attention_mask (plain masked path, "
            f"{plain_launches} kernel launches) vs {kernel.split()[0]} causal, f32 B 4 x 320: "
            f"max rel {err:.3e} (bound {F32_BOUND:.0e})")
        if err > F32_BOUND or plain_launches:
            raise AssertionError(f"explicit mask path: {err:.3e}, launches {plain_launches}")
        del dec, layer
        torch.cuda.empty_cache()


BN_STEPS = 8


def phase_batch_norm(t0, experiment, batch):
    """The fine-tuning step with the aligner's ``normalization: batch``
    (the committed checkpoint's weights; each norm's running statistics
    from their init): BN_STEPS bf16 steps, finite and falling, K1-K4
    launched, the running statistics moved; an evaluation step on them;
    the model saved and loaded bit-equal, statistics included."""
    import torch

    from isp_tts_tpu_torch.checkpoint import load_checkpoint
    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
    from isp_tts_tpu_torch.nn.norms import MaskedBatchNorm1d

    blob = load_checkpoint(CKPT)["model"]
    cfg = dict(blob["config"], aligner=dict(blob["config"]["aligner"], normalization="batch"))
    model = AcousticModel(build_config(AcousticModelConfig, cfg))
    model.load_params(blob["state"])
    trainer = recipe_trainer_on(model.cuda(), experiment, precision="bf16")
    norms = {n: m for n, m in model.named_modules() if isinstance(m, MaskedBatchNorm1d)}
    if len(norms) != 3:
        raise AssertionError(f"the aligner holds {len(norms)} batch norms, not 3")
    init = {n: (m.mean.clone(), m.var.clone()) for n, m in norms.items()}
    torch.cuda.synchronize()
    launch_counts(reset=True)
    t = time.perf_counter()
    history = trainer.train([batch], BN_STEPS)
    step_ms = 1e3 * (time.perf_counter() - t) / BN_STEPS
    launches = launch_counts()
    mel = [h["model/mel_loss"] for h in history]
    loss = [h["loss"] for h in history]
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"batch-norm: a metric went non-finite: {history}")
    if not (np.mean(mel[-3:]) < np.mean(mel[:3]) and loss[-1] < loss[0]):
        raise AssertionError(f"batch-norm: the losses did not fall: loss {loss}, mel {mel}")
    path = ("K1 mqa_fwd", "K2 mqa_bwd", "K3 mas", "K4 ctc_fwd", "K4 ctc_bwd")
    if min(launches[k] for k in path) == 0:
        raise AssertionError(f"batch-norm: the step should launch {path}: {launches}")
    moved = {n: max((m.mean - init[n][0]).abs().max().item(),
                    (m.var - init[n][1]).abs().max().item()) for n, m in norms.items()}
    if not all(v > 0 and np.isfinite(v) for v in moved.values()):
        raise AssertionError(f"batch-norm: running statistics did not move: {moved}")
    outputs, metrics = trainer.eval_step(batch)
    if not all(np.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"batch-norm: eval step on the running statistics: {metrics}")
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_smoke_bn_") as tmp:
        ckpt = Path(tmp) / "bn.ckpt"
        model.save_pretrained(ckpt)
        back = AcousticModel.from_pretrained(ckpt)
        mine, theirs = model.state_dict(), back.state_dict()
        unequal = [k for k in mine if not torch.equal(mine[k], theirs[k])]
    if unequal or set(mine) != set(theirs):
        raise AssertionError(f"batch-norm: save/load not bit-equal: {unequal[:5]}")
    say("batch-norm", t0, f"{BN_STEPS} bf16 steps with the aligner's batch norm: loss "
        f"{loss[0]:.5f} -> {loss[-1]:.5f}, mel_loss first 3 mean {np.mean(mel[:3]):.5f} last 3 "
        f"{np.mean(mel[-3:]):.5f}; {step_ms:.1f} ms per step (host clock, first step "
        f"included); launches {launches}; running statistics moved by up to "
        + ", ".join(f"{n.split('aligner.')[-1]} {v:.3e}" for n, v in moved.items())
        + f"; eval loss {float(metrics['loss']):.5f}; saved and loaded bit-equal "
        f"({len(mine)} tensors, {2 * len(norms)} of them running statistics)")
    del trainer, model, back, outputs
    torch.cuda.empty_cache()


KV_GRAD_BOUND = 1e-4


def kv_grad_errors(experiment, batch, pin: bool = True):
    """One f32 step with dropout off and no clip, kernel path, of the
    one-KV-head checkpoint and then of the multi-KV-head model. Returns
    each layer's ``to_kv`` gradient of the multi-KV-head step, summed over
    its H head blocks (K then V), against the one-KV-head step's, every
    other gradient's error, the loss terms' and how many token durations
    differ.

    With ``pin`` the multi-KV-head layers take as the value of their
    ``to_kv`` output the one-KV-head step's, tiled over the heads, while
    their gradient flows through their own ``to_kv``: the two ``to_kv``
    GEMMs (2*D and 2*H*D outputs) round K and V differently, and the
    backward kernels, which recompute p from the forward's lse with their
    own f32 logits, turn a one-ulp change of K into a different rounding
    pattern of dS, whose row sums the keys' common component carries into
    dq. Pinned, both steps see the same K and V, and what is compared is
    the kernels' own difference: K5a/K5b on H equal heads against K1/K2."""
    import torch

    from isp_tts_tpu_torch.nn.attention import Attention
    from isp_tts_tpu_torch.nn.layers import FastDropout

    class Pin(torch.autograd.Function):
        """The value of ``value``, the gradient of ``x``."""

        @staticmethod
        def forward(ctx, x, value):
            return value.clone()

        @staticmethod
        def backward(ctx, grad):
            return grad, None

    kv, results, heads = {}, {}, None
    for mha in (False, True):
        trainer = make_trainer(experiment, False, 7, "fp32", mha=mha)
        for m in trainer.model.modules():
            if isinstance(m, FastDropout):
                m.rate = 0.0
        trainer.config.optimization.grad_clip_norm = None  # the norms differ
        hooks = []
        for name, m in trainer.model.named_modules():
            if not isinstance(m, Attention):
                continue
            if not mha:
                hooks.append(m.to_kv.register_forward_hook(
                    lambda mod, i, o, name=name: kv.setdefault(name, []).append(o.detach())))
            elif pin:
                def tiled(mod, i, o, name=name, H=m.heads):
                    k, v = kv[name].pop(0).chunk(2, dim=-1)
                    return Pin.apply(o, torch.cat([k] * H + [v] * H, dim=-1))
                hooks.append(m.to_kv.register_forward_hook(tiled))
        if mha:
            heads = attention_heads(trainer.model)
        results[mha] = step_result(trainer, batch)
        for h in hooks:
            h.remove()
        del trainer
        if mha and pin and any(kv.values()):
            raise AssertionError("a pinned to_kv output was not taken: "
                                 + str({k: len(v) for k, v in kv.items() if v}))
    kv_err, other_err = {}, {}
    for name, g in results[True]["grads"].items():
        ref = results[False]["grads"][name]
        if name.endswith("to_kv.weight"):  # (2*H*D, dim): K heads, then V heads
            H = heads[name[: -len(".to_kv.weight")]]
            g = g.reshape(2, H, -1, g.shape[-1]).sum(dim=1).reshape(ref.shape)
            kv_err[name] = rel_err(g, ref)
        else:
            other_err[name] = rel_err(g, ref)
    loss = {k: abs(results[True]["loss"][k] - v) / max(abs(v), 1e-12)
            for k, v in results[False]["loss"].items()}
    moved = int((results[True]["durations"] != results[False]["durations"]).sum())
    return kv_err, other_err, loss, moved


def phase_kv_grad(t0, experiment, batch):
    """The multi-KV-head to_kv gradient check (:func:`kv_grad_errors`, K and
    V pinned): K5a/K5b against K1/K2 on the model."""
    import torch

    kv_err, other_err, loss, moved = kv_grad_errors(experiment, batch)
    worst = max(kv_err, key=kv_err.get)
    other = max(other_err, key=other_err.get)
    say("train-mha", t0, f"f32 step, dropout off, multi-KV-head vs one-KV-head model on "
        f"the kernel path, both on the one-KV-head step's K and V: to_kv gradients summed "
        f"over heads within {kv_err[worst]:.2e} of their max-abs in {len(kv_err)} layers "
        f"(worst {worst}), bound {KV_GRAD_BOUND:.0e}; other gradients worst {other} "
        f"{other_err[other]:.2e}; loss terms " + ", ".join(f"{k}={v:.1e}" for k, v in loss.items())
        + f"; {moved} token durations differ")
    if len(kv_err) != 16 or kv_err[worst] > KV_GRAD_BOUND:
        raise AssertionError(f"multi-KV-head to_kv gradients: {kv_err}")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- records
def kernel_records(batch, launches, serve_launches, mha_launches, mha_serve_launches,
                   audio_launches, artifact_launches, mha_artifact_launches):
    """Every kernel's numbers at the training path's shapes: the decoder's
    attention (B 32, N = M = 320, H 6, bf16, dropout 0.1, the batch's frame
    counts; K5a/K5b with 6 key/value heads), the aligner's MAS and the
    attention loss's CTC (B 32, M 320, T 48, the batch's lengths); K5a also
    at the serving decoder's shape (B 4, N = M = 1024, H 6, f32, ragged).
    ``launches`` are the one-KV-head training run's counts (K1-K4),
    ``mha_launches`` the multi-KV-head run's (K5a, K5b); K1 also carries
    the mel and the audio serving runs' counts, K1 and K5a those of one
    call of their exported artifacts."""
    import torch

    from isp_tts_tpu_torch.ops.flash_attention import (mqa_attention_reference, mqa_bwd,
                                                       mqa_bwd_reference, mqa_fwd)

    gen = torch.Generator(device="cuda").manual_seed(11)
    B, N, H, rate, scale = BATCH, MEL_LEN, 6, 0.1, 64 ** -0.5
    q, k, v, slopes, _, _ = mqa_inputs(B, N, N, H, torch.bfloat16, True, gen)
    lens = batch["mel_len"].contiguous()
    seed = seed_tensor(2024)
    o, lse = mqa_fwd(q, k, v, slopes, lens, scale, 0, lens, False, rate, seed)
    o_ref, _ = mqa_attention_reference(q, k, v, slopes, lens, scale, 0, lens, False, rate, seed)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    grads = mqa_bwd(q, k, v, slopes, lens, lens, seed, o, lse, do, scale, 0, False, rate)
    grads_ref = mqa_bwd_reference(q, k, v, slopes, lens, lens, seed, o, lse, do, scale, 0,
                                  False, rate)
    k1_bound = attention_bound(q, k, lens, lens)
    k2_bound = attention_bound(q, k, lens, lens, backward=True)
    k2_lib = library_bwd_ms(q, k, v, slopes, lens, scale, 0, False, do)
    shape = f"B={B} N=M={N} H={H} D=64 bfloat16 dropout={rate}"
    serving = serving_times(mqa_fwd, gen, kv_heads=None)
    records = [
        {"name": "K1 mqa_fwd", "route": "cuda", "source": "isp_tts_tpu_torch/csrc/mqa_fwd.cu",
         "replaces": "isp_tts_tpu/ops/flash_attention.py:736", "launches": launches["K1 mqa_fwd"],
         "launches_serving": serve_launches, "launches_serving_audio": audio_launches,
         "launches_artifact": artifact_launches, "design": FWD_DESIGN,
         "max_abs_err": (o.float() - o_ref.float()).abs().max().item(),
         "ms": graph_ms(lambda: mqa_fwd(q, k, v, slopes, lens, scale, 0, lens, False, rate,
                                        seed)),
         "plain_ms": cuda_ms(lambda: mqa_attention_reference(q, k, v, slopes, lens, scale, 0,
                                                             lens, False, rate, seed),
                             iters=5),
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": graph_ms(library_call(q, k, v, slopes, lens, scale)), "shape": shape,
         **serving},
        {"name": "K2 mqa_bwd", "route": "cuda", "source": "isp_tts_tpu_torch/csrc/mqa_bwd.cu",
         "replaces": "isp_tts_tpu/ops/flash_attention.py:998 (K2a), :836 + :927 (K2b)",
         "launches": launches["K2 mqa_bwd"], "design": BWD_DESIGN,
         "max_abs_err": max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(grads, grads_ref)),
         "ms": graph_ms(lambda: mqa_bwd(q, k, v, slopes, lens, lens, seed, o, lse, do, scale,
                                        0, False, rate)),
         "plain_ms": cuda_ms(lambda: mqa_bwd_reference(q, k, v, slopes, lens, lens, seed, o,
                                                       lse, do, scale, 0, False, rate),
                             iters=5),
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1], "library_ms": k2_lib,
         "shape": shape},
    ]
    torch.cuda.empty_cache()
    records += k5_records(batch, mha_launches, mha_serve_launches, mha_artifact_launches)
    records += dp_records(batch, launches, gen)
    return records


def dp_records(batch, launches, gen):
    """K3's, K4 forward's and K4 backward's records at the training path's
    shape (B 32, M 320, T 48, the batch's lengths): graph-timed device time,
    the plain versions and ``F.ctc_loss`` eager; ptxas's registers and spill
    bytes of the instantiation this shape runs (K4 with its 16-frame ring, K3
    with two column blocks on one warp)."""
    import torch
    import torch.nn.functional as F

    from isp_tts_tpu_torch.ops import ctc, cuda_build, mas

    def ptxas(source, kernel):
        """Registers and spill bytes of the instantiation whose mangled name
        holds ``kernel`` (none when this run found the library built)."""
        usage = ptxas_usage(cuda_build.BUILD_INFO[source]["log"])
        regs = next((u for k, u in usage.items() if kernel in k), None)
        return {} if regs is None else {"registers": regs[0], "spill_bytes": regs[1] + regs[2]}

    B, M, T = BATCH, MEL_LEN, TEXT_LEN
    la, _, _ = mas_inputs(B, M, T, gen)
    tl, ml = batch["text_vector_len"].contiguous(), batch["mel_len"].contiguous()
    got = mas.monotonic_alignment_search(la, tl, ml)
    ref = mas.monotonic_alignment_search_reference(la, tl, ml)
    k3_bound = mas_bound(la, tl, ml)
    records = [
        {"name": "K3 mas", "route": "cuda", "source": "isp_tts_tpu_torch/csrc/mas.cu",
         "replaces": "isp_tts_tpu/ops/mas_pallas.py:44 + :66", "launches": launches["K3 mas"],
         "design": DP_DESIGN, "max_abs_err": (got - ref).abs().max().item(),
         "ms": graph_ms(lambda: mas.monotonic_alignment_search(la, tl, ml)),
         "plain_ms": cuda_ms(lambda: mas.monotonic_alignment_search_reference(la, tl, ml),
                             iters=3, warmup=1),
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "library_ms": None,
         "shape": f"B={B} M={M} T={T} float32", **ptxas("mas", "mas_kernelILi2ELi1E")}]

    lp, _, _ = ctc_inputs(B, M, T, gen)
    g = torch.rand((B,), generator=gen, device="cuda")
    neg, ab, al, logz = ctc.ctc_fwd(lp, tl, ml)
    dlp = ctc.ctc_bwd(lp, ab, al, logz, g, tl, ml)
    x = lp.detach().double().requires_grad_()
    neg_r = ctc.ordered_ctc_neg_logp_reference(x, tl, ml)
    (dlp_r,) = torch.autograd.grad((neg_r * g.double()).sum(), x, retain_graph=True)
    fb, bb = ctc_fwd_bound(lp, tl, ml), ctc_bwd_bound(lp, tl, ml)
    labels = torch.arange(1, T + 1, device="cuda").repeat(B, 1)
    xl = lp.detach().requires_grad_()

    def library(backward):
        """F.ctc_loss (and its backward), timed eagerly: it copies the
        lengths to the host, which a CUDA graph cannot capture."""
        def call():
            loss = F.ctc_loss(xl.transpose(0, 1), labels, ml.long(), tl.long(), blank=0,
                              reduction="sum", zero_infinity=True)
            if backward:
                torch.autograd.grad(loss, xl)
        return cuda_ms(call)

    shape = f"B={B} M={M} T+1={T + 1} float32"
    library_label = "F.ctc_loss, eager"
    records += [
        {"name": "K4 ctc_fwd", "route": "cuda", "source": "isp_tts_tpu_torch/csrc/ctc.cu",
         "replaces": "isp_tts_tpu/ops/ctc_pallas.py:77", "launches": launches["K4 ctc_fwd"],
         "design": DP_DESIGN, "max_abs_err": (neg - neg_r.detach().float()).abs().max().item(),
         "ms": graph_ms(lambda: ctc.ctc_fwd(lp, tl, ml)),
         "plain_ms": cuda_ms(lambda: ctc.ordered_ctc_neg_logp_reference(lp.double(), tl, ml),
                             iters=3, warmup=1),
         "bound_ms": fb[0], "bound_by": fb[1], "library_ms": library(False),
         "library": library_label, "shape": shape, **ptxas("ctc", "ctc_fwd_kernelILi16E")},
        {"name": "K4 ctc_bwd", "route": "cuda", "source": "isp_tts_tpu_torch/csrc/ctc.cu",
         "replaces": "isp_tts_tpu/ops/ctc_pallas.py:114", "launches": launches["K4 ctc_bwd"],
         "design": DP_DESIGN, "max_abs_err": (dlp - dlp_r.float()).abs().max().item(),
         "ms": graph_ms(lambda: ctc.ctc_bwd(lp, ab, al, logz, g, tl, ml)),
         # the plain backward: autograd through the f64 recursion, its
         # forward already taken
         "plain_ms": cuda_ms(lambda: torch.autograd.grad((neg_r * g.double()).sum(), x,
                                                         retain_graph=True),
                             iters=3, warmup=1),
         "bound_ms": bb[0], "bound_by": bb[1], "library_ms": library(True),
         "library": library_label + ", forward + backward (no call computes the backward "
                                    "alone)", "shape": shape,
         **ptxas("ctc", "ctc_bwd_kernelILi16E")},
    ]
    return records


#: the DP kernels' design, named in their records
DP_DESIGN = ("warp-resident rows (K4 one column a lane, K3 up to 8), neighbours by shuffle, "
             "map staged by cp.async (csrc/dp_common.cuh)")


def k5_records(batch, launches, serve_launches, artifact_launches):
    """K5a's and K5b's records (see :func:`kernel_records`)."""
    import torch

    from isp_tts_tpu_torch.ops.flash_attention import (flash_attention_reference, flash_bwd,
                                                       flash_bwd_reference, flash_fwd)

    gen = torch.Generator(device="cuda").manual_seed(12)
    B, N, H, rate, scale = BATCH, MEL_LEN, 6, 0.1, 64 ** -0.5
    q, k, v, slopes, _, _ = mqa_inputs(B, N, N, H, torch.bfloat16, True, gen, kv_heads=H)
    lens = batch["mel_len"].contiguous()
    seed = seed_tensor(2025)
    fwd_args = (q, k, v, slopes, lens, scale, 0, lens, False, rate, seed)
    o, lse = flash_fwd(*fwd_args)
    o_ref, _ = flash_attention_reference(*fwd_args)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    bwd_args = (q, k, v, slopes, lens, lens, seed, o, lse, do, scale, 0, False, rate)
    grads = flash_bwd(*bwd_args)
    grads_ref = flash_bwd_reference(*bwd_args)
    fb, bb = attention_bound(q, k, lens, lens), attention_bound(q, k, lens, lens, backward=True)
    bl_ms = library_bwd_ms(q, k, v, slopes, lens, scale, 0, False, do)
    shape = f"B={B} N=M={N} H={H} Hkv={H} D=64 bfloat16 dropout={rate}"

    serving = serving_times(flash_fwd, gen, kv_heads=H)
    records = [
        {"name": "K5a flash_fwd", "route": "cuda", "source": "isp_tts_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "isp_tts_tpu/ops/flash_attention.py:80", "launches": launches["K5a flash_fwd"],
         "launches_serving": serve_launches, "launches_artifact": artifact_launches,
         "design": FWD_DESIGN,
         "max_abs_err": (o.float() - o_ref.float()).abs().max().item(),
         "ms": graph_ms(lambda: flash_fwd(*fwd_args)),
         "plain_ms": cuda_ms(lambda: flash_attention_reference(*fwd_args), iters=5),
         "bound_ms": fb[0], "bound_by": fb[1],
         "library_ms": graph_ms(library_call(q, k, v, slopes, lens, scale)), "shape": shape,
         **serving},
        {"name": "K5b flash_bwd", "route": "cuda", "source": "isp_tts_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "isp_tts_tpu/ops/flash_attention.py:155 + :229",
         "launches": launches["K5b flash_bwd"], "design": BWD_DESIGN,
         "max_abs_err": max((a.float() - b.float()).abs().max().item()
                            for a, b in zip(grads, grads_ref)),
         "ms": graph_ms(lambda: flash_bwd(*bwd_args)),
         "plain_ms": cuda_ms(lambda: flash_bwd_reference(*bwd_args), iters=5),
         "bound_ms": bb[0], "bound_by": bb[1], "library_ms": bl_ms, "shape": shape},
    ]
    del q, k, v, o, lse, do, grads, grads_ref
    torch.cuda.empty_cache()
    return records


#: the fine-tuning shape's width (H x D = 384) split at other head dims:
#: 12 heads x 32 and 3 heads x 128
HEAD_DIM_SPLITS = ((12, 32), (3, 128))


def product_usage(library: str, kernel: str, dtype: str = "bfloat16") -> list:
    """ptxas's (registers, spill store bytes, spill load bytes) of a tile
    core kernel (``attention_fwd_kernel``, ...) of ``library`` in ``dtype``,
    its D == DT instantiation (the one a head dim equal to the tile width
    launches)."""
    from isp_tts_tpu_torch.ops import cuda_build

    usage = ptxas_usage(cuda_build.BUILD_INFO[library]["log"])
    return [list(u) for k, u in usage.items() if kernel in k and full_width(k)
            and ("bfloat16" in k) == (dtype == "bfloat16")]


def head_dim_records(batch, launches) -> list[dict]:
    """K1, K2 (K2a), K5a and K5b (Hkv = H) at the fine-tuning shape (B 32,
    N = M = 320, the batch's frame counts, bf16, dropout 0.1) with its
    width split as HEAD_DIM_SPLITS: each held against its plain version as
    the kernel phases hold it (check_forward, check_backward: raises past
    the bound), then graph-timed beside its bound (4*D operations per (row,
    key) pair forward, 10*D backward, bytes at 3.35 TB/s), its plain version
    and SDPA (dense bias), with ptxas's registers and spills of its
    library's product kernels (bf16; f32 too for the forward, which also
    runs at the serving shape in f32: :func:`serving_times`). ``launches``:
    library -> launches on the full-width path (:func:`phase_head_dim_path`)."""
    import torch

    from isp_tts_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(13)
    lens = batch["mel_len"].contiguous()
    B, N, rate = lens.shape[0], MEL_LEN, 0.1
    records = []
    for H, D in HEAD_DIM_SPLITS:
        for kv_heads in (None, H):
            mqa = kv_heads is None
            fwd, bwd, pfwd, pbwd = ((fa.mqa_fwd, fa.mqa_bwd, fa.mqa_attention_reference,
                                     fa.mqa_bwd_reference) if mqa else
                                    (fa.flash_fwd, fa.flash_bwd, fa.flash_attention_reference,
                                     fa.flash_bwd_reference))
            q, k, v, slopes, _, _ = mqa_inputs(B, N, N, H, torch.bfloat16, True, gen,
                                               kv_heads=kv_heads, D=D)
            seed, scale = seed_tensor(2026), D ** -0.5
            fargs = (q, k, v, slopes, lens, scale, 0, lens, False, rate, seed)
            _, fwd_err, _, _, _, _ = check_forward(q, k, v, slopes, lens, lens, 0, False,
                                                   rate, seed)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
            _, _, _, _, o, lse = check_backward(q, k, v, slopes, lens, lens, do, 0, False,
                                                rate, seed, autograd=False)
            bargs = (q, k, v, slopes, lens, lens, seed, o, lse, do, scale, 0, False, rate)
            grads, grads_ref = bwd(*bargs), pbwd(*bargs)
            fb = attention_bound(q, k, lens, lens)
            bb = attention_bound(q, k, lens, lens, backward=True)
            shape = (f"B={B} N=M={N} H={H}" + ("" if mqa else f" Hkv={H}")
                     + f" D={D} bfloat16 dropout={rate}")
            fsrc, bsrc = ("mqa_fwd", "mqa_bwd") if mqa else ("flash_fwd", "flash_bwd")
            flib, blib = fa.kernel_library(fsrc, D), fa.kernel_library(bsrc, D)
            records += [
                {"name": f"{'K1' if mqa else 'K5a'} {fsrc}, D={D}", "route": "cuda",
                 "source": f"isp_tts_tpu_torch/csrc/{fsrc}.cu",
                 "replaces": "isp_tts_tpu/ops/flash_attention.py:" + ("736" if mqa else "80"),
                 "launches": launches.get(flib, 0), "library": flib, "design": FWD_DESIGN,
                 "max_abs_err": fwd_err,
                 "ms": graph_ms(lambda: fwd(*fargs)),
                 "plain_ms": cuda_ms(lambda: pfwd(*fargs), iters=5),
                 "bound_ms": fb[0], "bound_by": fb[1],
                 "library_ms": graph_ms(library_call(q, k, v, slopes, lens, scale)),
                 "registers_spills": product_usage(flib, "attention_fwd_kernel"),
                 "registers_spills_f32": product_usage(flib, "attention_fwd_kernel",
                                                       "float32"),
                 "shape": shape, **serving_times(fwd, gen, kv_heads, H, D)},
                {"name": f"{'K2' if mqa else 'K5b'} {bsrc}, D={D}", "route": "cuda",
                 "source": f"isp_tts_tpu_torch/csrc/{bsrc}.cu",
                 "replaces": "isp_tts_tpu/ops/flash_attention.py:"
                             + ("998 (K2a)" if mqa else "155 + :229"),
                 "launches": launches.get(blib, 0), "library": blib, "design": BWD_DESIGN,
                 "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                    for a, b in zip(grads, grads_ref)),
                 "ms": graph_ms(lambda: bwd(*bargs)),
                 "plain_ms": cuda_ms(lambda: pbwd(*bargs), iters=5),
                 "bound_ms": bb[0], "bound_by": bb[1],
                 "library_ms": library_bwd_ms(q, k, v, slopes, lens, scale, 0, False, do),
                 "registers_spills": {kern: product_usage(blib, f"attention_{kern}_kernel")
                                      for kern in ("dq", "dkv")},
                 "shape": shape},
            ]
            del q, k, v, o, lse, do, grads, grads_ref
            torch.cuda.empty_cache()
    return records


#: the head split's attention shapes in training, held by
#: :func:`split_shape_checks`: (H, D, key/value heads or None for one): the
#: encoder and decoder at 12 x 32 and the adaptor at 2 x 128 on one KV head,
#: and the H-KV split's encoder and decoder at 3 x 128 and adaptor at 2 x 128
SPLIT_SHAPES = ((12, 32, None), (2, 128, None), (3, 128, 3), (2, 128, 2))


def split_shape_checks(t0, ml, tl) -> None:
    """K1/K2 and K5a/K5b at the head split's own training shapes: B 32 at
    N = M = RECIPE_MEL on the mel lengths ``ml`` and N = M = RECIPE_TEXT on
    the text lengths ``tl`` of one of its batches, bf16, dropout 0.1, at
    each of SPLIT_SHAPES: the forward against its plain version
    (check_forward), the backward against autograd through the plain
    forward and against the plain backward on the kernel forward's o and
    lse (check_backward). Raises past the bound."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1819)
    rate = 0.1
    for label, N, lens in (("decoder", RECIPE_MEL, ml), ("encoder", RECIPE_TEXT, tl)):
        for H, D, kv_heads in SPLIT_SHAPES:
            q, k, v, slopes, _, _ = mqa_inputs(lens.shape[0], N, N, H, torch.bfloat16, True,
                                               gen, kv_heads=kv_heads, D=D)
            seed = seed_tensor(1819 + D)
            name, err, lse_err, fbound, kept, _ = check_forward(q, k, v, slopes, lens, lens, 0,
                                                                False, rate, seed)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
            bname, auto, errs, bbound, _, _ = check_backward(q, k, v, slopes, lens, lens, do,
                                                             0, False, rate, seed)
            say("head-split", t0, f"{name}/{bname} at the split's {label} shape B="
                f"{lens.shape[0]} N=M={N} H={H}" + ("" if kv_heads is None else
                                                   f" Hkv={kv_heads}")
                + f" D={D} bfloat16 dropout={rate}: o err {err:.3e} lse err {lse_err:.3e} "
                f"(bound {fbound:.0e}), kept {kept:.4f}; {grad_errs('vs autograd', auto)}; "
                f"{grad_errs('vs plain backward', errs)} (bound {bbound:.0e})")
            del q, k, v, do
            torch.cuda.empty_cache()


#: the attention kernels' designs, named in their records
FWD_DESIGN = "tensor cores (mma.sync tile core, csrc/attention_fwd.cuh)"
BWD_DESIGN = "tensor cores (mma.sync tile core, csrc/attention_bwd.cuh)"


def serving_times(fwd, gen, kv_heads, H: int = 6, D: int = 64) -> dict:
    """A forward kernel (K1 with ``kv_heads`` None, else K5a) at the serving
    decoder's shape, the batch bucket of 4 at the frame budget of 1024, f32,
    ragged lengths, ``H`` heads of ``D``: held against its plain version
    (check_forward, raises past F32_BOUND), then its time, its plain
    version's, its bound and the library call's."""
    import torch

    from isp_tts_tpu_torch.ops.flash_attention import (flash_attention_reference,
                                                       mqa_attention_reference)

    scale = D ** -0.5
    q, k, v, sl, kl, ql = mqa_inputs(4, 1024, 1024, H, torch.float32, True, gen,
                                     kv_heads=kv_heads, D=D)
    _, err, _, _, _, _ = check_forward(q, k, v, sl, kl, ql)
    plain = mqa_attention_reference if kv_heads is None else flash_attention_reference
    bound = attention_bound(q, k, kl, ql)
    out = {"serving_max_abs_err": err,
           "serving_ms": graph_ms(lambda: fwd(q, k, v, sl, kl, scale, 0, ql)),
           "serving_plain_ms": cuda_ms(lambda: plain(q, k, v, sl, kl, scale, 0, ql), iters=5),
           "serving_bound_ms": bound[0], "serving_bound_by": bound[1],
           "serving_library_ms": graph_ms(library_call(q, k, v, sl, kl, scale)),
           "serving_shape": f"B=4 N=M=1024 H={H}"
                            + ("" if kv_heads is None else f" Hkv={kv_heads}")
                            + f" D={D} float32 ragged lengths"}
    del q, k, v
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------- training from a recipe
RECIPE = "acoustic/core_fast"
RECIPE_STEPS, RECIPE_CHUNK = 16, 8  # two chunks of core_fast's steps_per_call
RECIPE_BATCH, RECIPE_TEXT, RECIPE_MEL = 32, 192, 896  # core_fast's fixed collation
RECIPE_DIM, RECIPE_LAYERS = 384, 6  # core's width and encoder/decoder depth
DATASET_TRAIN, DATASET_VALID = 512, 64  # one epoch = two chunks of 8 steps at batch 32
DATASET_WORDS = sorted({w.strip(".,").lower() for s in TRAIN_SENTENCES for w in s.split()})
#: the smoke's recipe run, at the recipe's own widths: warm-started from the
#: committed checkpoint, 16 steps, evaluating and saving every 8
RECIPE_SETTINGS = {
    "trainer.max_steps": RECIPE_STEPS, "trainer.batch_size": RECIPE_BATCH,
    "trainer.eval_batch_size": RECIPE_BATCH, "trainer.eval_steps": RECIPE_CHUNK,
    "trainer.save_steps": RECIPE_CHUNK, "trainer.eval_batches": 2,
    "trainer.logging_steps": 1, "trainer.log_with": [], "trainer.label": "smoke",
    "trainer.resume_from_checkpoint": str(CKPT), "trainer.warm_start": True,
    "trainer.metric_for_best_model": None,  # no checkpoint_best: disk
}


def dataset_sentences(n: int, seed: int) -> list[str]:
    """``n`` seeded sentences of 3 to 16 words from the training pool's
    vocabulary, a capital first and a full stop, comma or question mark."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        words = list(rng.choice(DATASET_WORDS, size=rng.randint(3, 17)))
        if len(words) > 6 and rng.rand() < 0.4:
            words[len(words) // 2] += ","
        out.append(" ".join(words).capitalize() + rng.choice([".", ".", "?", "!"]))
    return out


def phase_dataset(t0, synth, root: Path) -> dict:
    """A dataset written by the Synthesizer and the vocoder from the two
    committed checkpoints: 22.05 kHz 16-bit WAVs of seeded sentences, at
    most RECIPE_TEXT symbols and RECIPE_MEL frames each, split into
    meta_train.csv and meta_valid.csv (``audio_path|text``)."""
    from isp_tts_tpu_torch.data.audio import write_wav

    (root / "wavs").mkdir(parents=True)
    want = DATASET_TRAIN + DATASET_VALID
    kept, frames, t = [], [], time.perf_counter()
    pool = dataset_sentences(2 * want, seed=2026)
    for start in range(0, len(pool), RECIPE_BATCH):
        texts = pool[start:start + RECIPE_BATCH]
        waves = synth.synthesize_audio(texts, seed=start)
        for text, wav in zip(texts, waves):
            n_frames = len(wav) // 256
            if len(synth.text_provider(text)) > RECIPE_TEXT - 2 or not 16 <= n_frames <= RECIPE_MEL - 16:
                continue
            name = f"wavs/s{len(kept):04d}.wav"
            write_wav(root / name, wav, 22050)
            kept.append(f"{name}|{text}")
            frames.append(n_frames)
        if len(kept) >= want:
            break
    if len(kept) < want:
        raise AssertionError(f"only {len(kept)} of {want} sentences fit {RECIPE_TEXT} symbols "
                             f"and {RECIPE_MEL} frames")
    kept, frames = kept[:want], frames[:want]
    (root / "meta_train.csv").write_text("\n".join(kept[:DATASET_TRAIN]) + "\n")
    (root / "meta_valid.csv").write_text("\n".join(kept[DATASET_TRAIN:]) + "\n")
    say("dataset", t0, f"{DATASET_TRAIN} train + {DATASET_VALID} valid utterances written in "
        f"{time.perf_counter() - t:.1f} s: frames min {min(frames)} mean {np.mean(frames):.0f} "
        f"max {max(frames)}, {sum(frames) * 256 / 22050 / 60:.1f} min of audio")
    return {"dataset.root": str(root), "dataset._train_": {"meta_name": "meta_train.csv"},
            "dataset._eval_": {"meta_name": "meta_valid.csv"}}


def set_args(settings: dict) -> list[str]:
    """``--set key=value`` arguments (values written as YAML flow)."""
    from isp_tts_tpu_torch.config.yamlio import _flow

    args = []
    for key, value in settings.items():
        args += ["--set", f"{key}={_flow(value) if not isinstance(value, str) else value}"]
    return args


def train_cli(args: list[str], timeout: int = 600,
              recipe: str = RECIPE) -> subprocess.CompletedProcess:
    proc = subprocess.run([sys.executable, "-m", "isp_tts_tpu_torch.train", "--config-name",
                           recipe] + args, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"train {' '.join(args[:6])} ... exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    return proc


def phase_stats(t0, data: dict) -> dict:
    """``--compute-stats`` as a subprocess: YIN and the front end on the
    card over the training split; finite statistics, pitch mean 40-800 Hz."""
    t = time.perf_counter()
    proc = train_cli(["--compute-stats"] + set_args(data))
    path = Path(data["dataset.root"]) / "stats.json"
    stats = json.loads(path.read_text())
    values = [v for feat in stats.values() for v in feat.values()]
    if not (all(np.isfinite(values)) and 40.0 < stats["pitch"]["mean"] < 800.0):
        raise AssertionError(f"dataset statistics {stats}: {proc.stdout[-500:]}")
    say("stats", t0, f"python -m isp_tts_tpu_torch.train --compute-stats: {stats} in "
        f"{time.perf_counter() - t:.1f} s (process)")
    return {**data, "dataset.stats": str(path)}


def recipe_overrides(settings: dict) -> dict:
    from isp_tts_tpu_torch.config import parse_overrides

    return parse_overrides(set_args(settings)[1::2])


class _ChunkClock:
    """A trainer callback: the wall time between chunk starts (each chunk
    is one ``on_step_begin``), with the card synced, and the seconds each
    chunk spent in evaluations and checkpoint writes."""

    def __init__(self):
        self.starts, self.trainer = [], None
        self.eval_s: dict[int, float] = {}
        self.save_s: dict[int, float] = {}
        self.eval_launches: dict[str, int] = {}

    def add(self, table: dict, seconds: float) -> None:
        chunk = len(self.starts) - 1
        table[chunk] = table.get(chunk, 0.0) + seconds

    def on_save(self, config, state, control, **kw):
        self.add(self.save_s, self.trainer.save_seconds[-1])

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_step_begin(self, config, state, control, **kw):
        import torch

        if control.is_train:  # evaluation batches raise the event too
            torch.cuda.synchronize()
            self.starts.append(time.perf_counter())


def recipe_trainer(settings: dict, out: Path, recipe: str = RECIPE,
                   base: dict | None = None, **trainer):
    from isp_tts_tpu_torch.training.experiment import ExperimentModules

    base = RECIPE_SETTINGS if base is None else base
    over = recipe_overrides({**settings, **base, "trainer.output_dir": str(out),
                             **{f"trainer.{k}": v for k, v in trainer.items()}})
    modules = ExperimentModules(recipe, str(ROOT / "recipes"), overrides=over).init_modules()
    clock = _ChunkClock()
    tr = modules.build_trainer(callbacks=[clock])
    clock.trainer = tr
    evaluate = tr.evaluate

    def timed_evaluate(*a, **k):
        import torch

        torch.cuda.synchronize()
        t, before = time.perf_counter(), launch_counts()
        out_ = evaluate(*a, **k)
        torch.cuda.synchronize()
        clock.add(clock.eval_s, time.perf_counter() - t)
        for name, n in launch_counts().items():
            clock.eval_launches[name] = clock.eval_launches.get(name, 0) + n - before[name]
        return out_

    tr.evaluate = timed_evaluate
    return tr, clock


def step_losses(trainer, key="train_step/loss") -> dict[int, float]:
    return {h["step"]: h[key] for h in trainer.state.log_history if key in h}


def phase_recipe(t0, settings: dict, out: Path):
    """``acoustic/core_fast`` at its own widths (dim 384, 6 + 6 layers, one
    KV head, bf16, batch 32, 192 x 896, 8 steps a chunk), warm-started from
    the committed checkpoint: once through the CLI, once in process with
    the launch counts zeroed just before ``train()`` and read just after."""
    import torch

    from isp_tts_tpu_torch.checkpoint import load_checkpoint
    from isp_tts_tpu_torch.training.optimizers import keystr

    t = time.perf_counter()
    train_cli(set_args({**settings, **RECIPE_SETTINGS, "trainer.output_dir": str(out / "cli")}))
    cli_s = time.perf_counter() - t
    cli_ckpt = out / "cli" / "AcousticModel" / "smoke" / "checkpoint_last.ckpt"
    if load_checkpoint(cli_ckpt)["experiment"]["state"]["global_step"] != RECIPE_STEPS:
        raise AssertionError("the CLI run did not take its steps")
    say("recipe", t0, f"python -m isp_tts_tpu_torch.train --config-name {RECIPE} "
        f"({RECIPE_STEPS} steps, eval and save every {RECIPE_CHUNK}): exit 0 in {cli_s:.1f} s")

    trainer, clock = recipe_trainer(settings, out / "run")
    cfg, model = trainer.config, trainer.model
    enc = model.encoder.layers[0].attention
    shape = (cfg.precision, cfg.batch_size, trainer.collator.config.max_text_len,
             trainer.collator.config.max_mel_len, cfg.steps_per_call)
    if (shape != ("bf16", RECIPE_BATCH, RECIPE_TEXT, RECIPE_MEL, RECIPE_CHUNK)
            or model.config.text_dim != RECIPE_DIM
            or len(model.encoder.layers) != RECIPE_LAYERS
            or len(model.decoder.layers) != RECIPE_LAYERS or not enc.one_kv_head):
        raise AssertionError(f"the recipe run is not core_fast at its widths: {shape}")
    from isp_tts_tpu_torch.data.audio import DECODED

    DECODED.update(native=0, python=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    t = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts()
    if DECODED["native"] == 0 or DECODED["python"]:
        raise AssertionError(f"the loader's WAV decode: {DECODED}")
    evals_made = {k: clock.eval_launches.get(k, 0) for k in launches}
    per_step = {k: (v - evals_made[k]) / RECIPE_STEPS for k, v in launches.items()}
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    loss = step_losses(trainer)
    mel = step_losses(trainer, "train_step/model/mel_loss")
    evals = [h for h in trainer.state.log_history if "eval/loss" in h]
    bad = [k for h in trainer.state.log_history for k, v in h.items()
           if isinstance(v, float) and not np.isfinite(v)]
    if bad or sorted(loss) != list(range(1, RECIPE_STEPS + 1)):
        raise AssertionError(f"non-finite or missing step metrics: {bad}, steps {sorted(loss)}")
    first = np.mean([mel[s] for s in range(1, RECIPE_CHUNK + 1)])
    last = np.mean([mel[s] for s in range(RECIPE_CHUNK + 1, RECIPE_STEPS + 1)])
    if not last < first:
        raise AssertionError(f"mel loss did not fall: {mel}")
    mcd = [h.get("eval/metrics/mcd_13") for h in evals]
    if len(evals) != RECIPE_STEPS // RECIPE_CHUNK or not all(np.isfinite(m) for m in mcd):
        raise AssertionError(f"evaluations {evals}")
    path = ("K1 mqa_fwd", "K2 mqa_bwd", "K3 mas", "K4 ctc_fwd", "K4 ctc_bwd")
    if min(launches[k] for k in path) == 0 or launches["K5a flash_fwd"] or launches[
            "K5b flash_bwd"]:
        raise AssertionError(f"the recipe run should launch {path} and no other: {launches}")
    # (c) the aligner's durations on a validation batch
    batch = next(iter(trainer.eval_loader))
    outputs, _ = trainer.eval_step(batch)
    hard = outputs.aligner_output.attn_hard_duration
    if not torch.equal(hard.sum(dim=1).cpu(), torch.from_numpy(batch["mel_len"]).float()):
        raise AssertionError("MAS durations do not sum to the mel lengths")
    # host time per step: chunks after the first, without their eval and save
    chunk_ms = np.diff(clock.starts + [t + wall]) * 1e3
    step_ms = [round(float(c - 1e3 * (clock.eval_s.get(i, 0.0) + clock.save_s.get(i, 0.0)))
                     / RECIPE_CHUNK, 2) for i, c in enumerate(chunk_ms) if i > 0]
    ds = trainer.train_loader.dataset
    say("recipe", t0, f"in process: {RECIPE_STEPS} steps in {wall:.2f} s; loss per step "
        + ", ".join(f"{loss[s]:.4f}" for s in sorted(loss)) + f"; mel_loss first {RECIPE_CHUNK} "
        f"mean {first:.4f}, last {RECIPE_CHUNK} mean {last:.4f}; eval MCD-13 {mcd}; durations "
        f"sum to mel_len on a validation batch")
    say("recipe", t0, f"host ms per step (chunk 2 on, eval and save left out, synced at chunk "
        f"starts) {step_ms}; front end {1e3 * ds.frontend_seconds / max(ds.frontend_calls, 1):.1f}"
        f" ms per batch of {RECIPE_BATCH} ({ds.frontend_calls} passes on {ds.frontend_device}); "
        f"checkpoint save s {[round(x, 3) for x in trainer.save_seconds]}; eval s per chunk "
        f"{clock.eval_s}; peak memory {peak_mib:.0f} MiB; launches {launches}, of them in "
        f"the evaluations {evals_made}; the training step's per step {per_step}; WAVs "
        f"decoded natively {DECODED['native']}, by the Python reader {DECODED['python']}")

    # the written file, read back with the port's reader
    ckpt = load_checkpoint(trainer.run_dir / "checkpoint_last.ckpt")
    state = model.jax_state()
    if ckpt["format"] != "isp_tts_tpu.v1" or set(ckpt["model"]["state"]) != set(state):
        raise AssertionError("checkpoint_last.ckpt: wrong format or tensor names")
    for name, arr in state.items():
        if not np.array_equal(ckpt["model"]["state"][name], arr):
            raise AssertionError(f"checkpoint_last.ckpt: {name} is not bit-equal")
    keyed = ckpt["optimizer"]["keyed"]
    missing = [n for n, (jname, _) in model.jax_names().items()
               if n in dict(model.named_parameters())
               and not any(k.endswith(keystr(jname)) and ".mu" in k for k in keyed)]
    if missing:
        raise AssertionError(f"optimizer moments missing for {missing[:5]}")
    return trainer, launches, evals_made


# -------------------------------------------------- the full-width head split
_ATTN = "model.{}.transformer_layer.attention"
_ADAPTOR = "model.temporal_adaptor.{}.transformer.transformer_layer.attention"
#: ``acoustic/core``'s architecture (6 + 6 layers x 384, one KV head, the
#: adaptor 256 wide) with its head splits set through ``--set``: the encoder
#: (and so the decoder, which interpolates its layer) at 12 heads x 32, the
#: duration/pitch/energy predictor and the feature embedding at 2 heads x 128
HEAD_SPLIT = {
    f"{_ATTN.format('encoder')}.heads": 12, f"{_ATTN.format('encoder')}.head_dim": 32,
    **{f"{_ADAPTOR.format(m)}.{k}": v for m in ("predictor", "embedding")
       for k, v in (("heads", 2), ("head_dim", 128))},
}
#: the same with H key/value heads in every layer, the encoder and decoder at
#: 3 heads x 128: every layer on K5a/K5b at head dim 128
HEAD_SPLIT_MHA = {
    **HEAD_SPLIT, f"{_ATTN.format('encoder')}.heads": 3,
    f"{_ATTN.format('encoder')}.head_dim": 128, f"{_ATTN.format('encoder')}.one_kv_head": False,
    **{f"{_ADAPTOR.format(m)}.one_kv_head": False for m in ("predictor", "embedding")},
}
HEAD_SPLIT_STEPS, HEAD_SPLIT_MHA_STEPS = 16, 4
#: the recipe runs from the random init (no warm start), no evaluation, one
#: checkpoint at the last step
HEAD_SPLIT_BASE = {
    "trainer.batch_size": RECIPE_BATCH, "trainer.do_eval": False,
    "trainer.save_steps": HEAD_SPLIT_STEPS, "trainer.logging_steps": 1,
    "trainer.log_with": [], "trainer.metric_for_best_model": None,
}
#: the full-width path's attention launches a training step and a synthesis:
#: encoder 6 + decoder 6 + predictor 3 + embedding 1, and with the
#: predictor's 4 flow steps 6 + 3 x 4 + 1 + 6
SPLIT_STEP_LAUNCHES, SPLIT_SYNTH_LAUNCHES = 16, 25


def split_launches(per: int, count: int, kernels: tuple) -> dict:
    """library -> launches that ``count`` units (steps or syntheses) of
    ``per`` attention calls each make on the head split's one-KV-head model:
    ``kernels`` (sources) at head dim 32 (the encoder and decoder, 12 of
    each unit's calls) and 128 (the rest)."""
    from isp_tts_tpu_torch.ops.flash_attention import kernel_library

    enc_dec = 12
    want = {}
    for src in kernels:
        want[kernel_library(src, 32)] = enc_dec * count
        want[kernel_library(src, 128)] = (per - enc_dec) * count
    return want


def serve_split(t0, synth, kernel: str, label: str) -> dict:
    """The three sentences one at a time and as one batch through
    ``synth`` (a model trained a few steps from the random init: its
    durations are whatever those steps learned), the launch counts zeroed
    just before and read just after: finite mels of mel_dim columns within
    the frame budget, ``kernel`` alone launched, SPLIT_SYNTH_LAUNCHES a
    synthesis at head dims 32 and 128. Returns the libraries' launches."""
    from isp_tts_tpu_torch.ops import flash_attention as fa

    launch_counts(reset=True)
    fa.LIBRARY_LAUNCHES.clear()
    mels = [m for text in SENTENCES + [SENTENCES] for m in synth(text)]
    launches = {k: v for k, v in launch_counts().items() if v}
    libs = dict(fa.LIBRARY_LAUNCHES)
    budget = synth.config.frame_budgets[-1]
    for m in mels:
        if not (m.ndim == 2 and m.shape[1] == synth.model.mel_dim and m.shape[0] <= budget
                and np.isfinite(m).all()):
            raise AssertionError(f"{label}: bad mel, shape {m.shape}, finite "
                                 f"{np.isfinite(m).all()}")
    calls = len(SENTENCES) + 1
    if (launches != {kernel: SPLIT_SYNTH_LAUNCHES * calls}
            or libs != split_launches(SPLIT_SYNTH_LAUNCHES, calls, ("mqa_fwd",))):
        raise AssertionError(f"{label}: {SPLIT_SYNTH_LAUNCHES} launches of {kernel} a "
                             f"synthesis (12 at head dim 32, 13 at 128) and no other "
                             f"attention kernel expected: {launches}, by library {libs}")
    say("head-split", t0, f"{label}: the three sentences alone and batched, frames "
        f"{[m.shape[0] for m in mels]}, launches {launches} by library {libs} "
        f"({SPLIT_SYNTH_LAUNCHES} a synthesis)")
    return libs


def phase_head_dim_path(t0, settings: dict, out: Path) -> dict:
    """The full-width model of HEAD_SPLIT (12 x 32 and 2 x 128 on one model)
    through the port's entry points: (a) the recipe trainer
    (``acoustic/core_fast`` at its shape, bf16, batch 32 x 192 x 896) from
    the random init, HEAD_SPLIT_STEPS steps on the smoke's dataset, the
    launch counts zeroed just before ``train()`` and read just after: finite
    losses that fall, K1, K2, K3 and K4 at their counts a step (K1/K2 at
    head dims 32 and 128), one checkpoint in the JAX package's format, then
    K1/K2 and K5a/K5b at the split's own shapes on one of its batches
    (:func:`split_shape_checks`); (b)
    ``Synthesizer.from_pretrained`` of that checkpoint: the three sentences
    alone and batched, 25 K1 launches a synthesis, and the batch's mel on
    the kernels within MEL_BOUND of the plain path's, f32, with the same
    noise and durations; (c) HEAD_SPLIT_MHA (every layer 128 wide with H
    key/value heads) through the Trainer for HEAD_SPLIT_MHA_STEPS steps and
    one synthesis: K5a and K5b at head dim 128. Returns each library's
    launches over the three."""
    import torch

    from isp_tts_tpu_torch.checkpoint import load_checkpoint
    from isp_tts_tpu_torch.nn.attention import Attention
    from isp_tts_tpu_torch.ops import flash_attention as fa
    from isp_tts_tpu_torch.serving import Synthesizer

    total: dict[str, int] = {}

    def add(libs):
        for k, v in libs.items():
            total[k] = total.get(k, 0) + v

    # (a) the recipe trainer from the random init
    trainer, _ = recipe_trainer({**settings, **HEAD_SPLIT}, out / "split", base={
        **HEAD_SPLIT_BASE, "trainer.max_steps": HEAD_SPLIT_STEPS, "trainer.label": "split"})
    model = trainer.model
    dims = sorted({(m.heads, m.head_dim, m.one_kv_head) for m in model.modules()
                   if isinstance(m, Attention)})
    if (dims != [(2, 128, True), (12, 32, True)] or model.config.text_dim != RECIPE_DIM
            or len(model.decoder.layers) != RECIPE_LAYERS
            or trainer.collator.config.max_mel_len != RECIPE_MEL):
        raise AssertionError(f"the head split is not core_fast's widths: heads {dims}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    fa.LIBRARY_LAUNCHES.clear()
    t = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches, libs = launch_counts(), dict(fa.LIBRARY_LAUNCHES)
    add(libs)
    loss = step_losses(trainer)
    n = HEAD_SPLIT_STEPS
    want = {"K1 mqa_fwd": SPLIT_STEP_LAUNCHES * n, "K2 mqa_bwd": SPLIT_STEP_LAUNCHES * n,
            "K3 mas": n, "K4 ctc_fwd": n, "K4 ctc_bwd": n, "K5a flash_fwd": 0,
            "K5b flash_bwd": 0}
    want_libs = split_launches(SPLIT_STEP_LAUNCHES, n, ("mqa_fwd", "mqa_bwd"))
    if launches != want or libs != want_libs:
        raise AssertionError(f"the head split's training launches {launches} by library "
                             f"{libs}; expected {want}, {want_libs}")
    if sorted(loss) != list(range(1, n + 1)) or not all(np.isfinite(list(loss.values()))):
        raise AssertionError(f"non-finite or missing losses: {loss}")
    first, last = np.mean([loss[s] for s in range(1, 5)]), np.mean([loss[s] for s in
                                                                     range(n - 3, n + 1)])
    if not last < first:
        raise AssertionError(f"the loss did not fall: {loss}")
    ckpt = trainer.run_dir / "checkpoint_last.ckpt"
    blob = load_checkpoint(ckpt)
    if blob["format"] != "isp_tts_tpu.v1" or blob["experiment"]["state"]["global_step"] != n:
        raise AssertionError(f"{ckpt}: format {blob['format']}, step "
                             f"{blob['experiment']['state']['global_step']}")
    say("head-split", t0, f"(a) {RECIPE} with {HEAD_SPLIT} from the random init: "
        f"{sum(p.numel() for p in model.parameters())} parameters, heads x head dim x one "
        f"KV head {dims}; {n} bf16 steps in {wall:.2f} s, loss "
        + ", ".join(f"{loss[s]:.4f}" for s in sorted(loss)) + f" (first 4 mean {first:.4f}, "
        f"last 4 {last:.4f}); launches {launches}, by library {libs}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; {ckpt.name} in the JAX "
        f"package's format at step {n}")
    split_batch = next(iter(trainer.train_loader))
    split_shape_checks(t0, *(torch.from_numpy(split_batch[key]).cuda().contiguous()
                             for key in ("mel_len", "text_vector_len")))
    del trainer, model, blob, split_batch
    torch.cuda.empty_cache()

    # (b) served from that checkpoint, and the kernel path against the plain path
    synth = Synthesizer.from_pretrained(ckpt)
    add(serve_split(t0, synth, "K1 mqa_fwd", "(b) Synthesizer.from_pretrained"))
    tok, ln, fb, B, noise = batch_draws(synth)
    durations = torch.where(tok > 0, 4.0, 0.0)  # 4 frames a token
    kernel_vs_plain(t0, synth.model, tok, ln, fb, B, noise, durations)
    del synth
    torch.cuda.empty_cache()

    # (c) H key/value heads, every layer at head dim 128
    trainer, _ = recipe_trainer({**settings, **HEAD_SPLIT_MHA}, out / "split_mha", base={
        **HEAD_SPLIT_BASE, "trainer.max_steps": HEAD_SPLIT_MHA_STEPS,
        "trainer.save_strategy": "no", "trainer.label": "split_mha"})
    dims = sorted({(m.heads, m.head_dim, m.one_kv_head) for m in trainer.model.modules()
                   if isinstance(m, Attention)})
    if dims != [(2, 128, False), (3, 128, False)]:
        raise AssertionError(f"the multi-KV-head split: heads {dims}")
    launch_counts(reset=True)
    fa.LIBRARY_LAUNCHES.clear()
    trainer.train()
    torch.cuda.synchronize()
    launches, libs = {k: v for k, v in launch_counts().items() if v}, dict(fa.LIBRARY_LAUNCHES)
    add(libs)
    n = HEAD_SPLIT_MHA_STEPS
    want = {"K5a flash_fwd": SPLIT_STEP_LAUNCHES * n, "K5b flash_bwd": SPLIT_STEP_LAUNCHES * n,
            "K3 mas": n, "K4 ctc_fwd": n, "K4 ctc_bwd": n}
    want_libs = {fa.kernel_library("flash_fwd", 128): SPLIT_STEP_LAUNCHES * n,
                 fa.kernel_library("flash_bwd", 128): SPLIT_STEP_LAUNCHES * n}
    loss = step_losses(trainer)
    if launches != want or libs != want_libs or not all(np.isfinite(list(loss.values()))):
        raise AssertionError(f"the multi-KV-head split: launches {launches} by library "
                             f"{libs}, losses {loss}")
    say("head-split", t0, f"(c) {RECIPE} with {HEAD_SPLIT_MHA}: heads x head dim x one KV "
        f"head {dims}; {n} bf16 steps through the Trainer, loss "
        + ", ".join(f"{loss[s]:.4f}" for s in sorted(loss)) + f"; launches {launches}, by "
        f"library {libs}")
    synth = Synthesizer(trainer.model.eval())
    launch_counts(reset=True)
    fa.LIBRARY_LAUNCHES.clear()
    mel = synth(SENTENCES[0])[0]
    launches, libs = {k: v for k, v in launch_counts().items() if v}, dict(fa.LIBRARY_LAUNCHES)
    add(libs)
    if (launches != {"K5a flash_fwd": SPLIT_SYNTH_LAUNCHES}
            or libs != {fa.kernel_library("flash_fwd", 128): SPLIT_SYNTH_LAUNCHES}
            or not np.isfinite(mel).all()):
        raise AssertionError(f"the multi-KV-head split's synthesis: launches {launches} by "
                             f"library {libs}, finite {np.isfinite(mel).all()}")
    say("head-split", t0, f"(c) one synthesis: frames {mel.shape[0]}, launches {launches} by "
        f"library {libs}")
    del trainer, synth
    torch.cuda.empty_cache()
    return total


def phase_resume(t0, settings: dict, out: Path, first):
    """A second uninterrupted run (the control) and a run resumed from the
    first's step-8 checkpoint in a fresh Trainer: the resumed run's steps
    9-16 losses and final parameters within twice the two uninterrupted
    runs' difference (bit-identical if they are)."""
    import torch

    second, _ = recipe_trainer(settings, out / "control")
    second.train()
    ckpt = first.run_dir / f"checkpoint_s{RECIPE_CHUNK}.ckpt"
    t = time.perf_counter()
    resumed, _ = recipe_trainer(settings, out / "resumed", resume_from_checkpoint=str(ckpt),
                                warm_start=False)
    build_s = time.perf_counter() - t
    if resumed.state.global_step != RECIPE_CHUNK:
        raise AssertionError(f"resumed at step {resumed.state.global_step}")
    resumed.train()
    torch.cuda.synchronize()
    steps = range(RECIPE_CHUNK + 1, RECIPE_STEPS + 1)
    la, lb, lc = (step_losses(x) for x in (first, second, resumed))
    loss_ctl = max(abs(lb[s] - la[s]) for s in steps)
    loss_err = max(abs(lc[s] - la[s]) for s in steps)
    pa, pb, pc = (x.model.jax_state() for x in (first, second, resumed))
    param_ctl = max(float(np.abs(pb[k] - pa[k]).max()) for k in pa)
    param_err = max(float(np.abs(pc[k] - pa[k]).max()) for k in pa)
    exact = loss_ctl == 0.0 and param_ctl == 0.0
    ok = (loss_err == 0.0 and param_err == 0.0) if exact else (
        loss_err <= 2 * loss_ctl and param_err <= 2 * param_ctl)
    say("resume", t0, f"steps {steps.start}-{steps.stop - 1}: loss max |resumed - first| "
        f"{loss_err:.3e}, control |second - first| {loss_ctl:.3e}; final parameters "
        f"{param_err:.3e}, control {param_ctl:.3e} (bound 2x control"
        f"{', bit-identical' if exact else ''}); checkpoint load {resumed.load_seconds:.3f} s, "
        f"fresh trainer with the load {build_s:.2f} s")
    if not ok:
        raise AssertionError("the resumed run left the uninterrupted one")
    return resumed.load_seconds


def recipe_records(t0, trainer, launches, eval_launches) -> list[dict]:
    """K1, K2 (K2a), K3 and K4 at the recipe's shape, B 32 x text 192 x
    mel 896, on a validation batch's lengths: the decoder's attention
    (N = M = 896) and the encoder's (N = M = 192), H 6, bf16, dropout 0.1;
    MAS and CTC on (M 896, T 192). Each is held against its plain version
    as the kernel phases hold it (raises past the bound), then timed.
    ``launches`` are the recipe run's, ``eval_launches`` the part of them
    its evaluations made."""
    import torch
    import torch.nn.functional as F

    from isp_tts_tpu_torch.ops import ctc, mas
    from isp_tts_tpu_torch.ops.flash_attention import (mqa_attention_reference, mqa_bwd,
                                                       mqa_bwd_reference, mqa_fwd)

    batch = next(iter(trainer.eval_loader))
    ml = torch.from_numpy(batch["mel_len"]).cuda().contiguous()
    tl = torch.from_numpy(batch["text_vector_len"]).cuda().contiguous()
    gen = torch.Generator(device="cuda").manual_seed(12)
    B, H, rate, scale = RECIPE_BATCH, 6, 0.1, 64 ** -0.5
    records = []

    def counts(name):
        """The run's launches, and the training step's apart from the
        evaluations' (``launches_per_step`` counts the step's alone)."""
        return {"launches": launches[name], "eval_launches": eval_launches[name],
                "launches_per_step": (launches[name] - eval_launches[name]) / RECIPE_STEPS}

    for label, N, lens in (("decoder", RECIPE_MEL, ml), ("encoder", RECIPE_TEXT, tl)):
        q, k, v, slopes, _, _ = mqa_inputs(B, N, N, H, torch.bfloat16, True, gen)
        seed = seed_tensor(77)
        # K1 within the bf16 bound of its plain version, K2 within K2_BOUNDS
        # of autograd through the plain forward (dq, dk, dv) and of the
        # plain backward on the kernel's own o and lse (all four, dslopes too)
        _, fwd_err, lse_err, fwd_bound, kept, _ = check_forward(q, k, v, slopes, lens, lens, 0,
                                                             False, rate, seed)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        _, auto, errs, bwd_bound, o, lse = check_backward(q, k, v, slopes, lens, lens, do, 0,
                                                          False, rate, seed)
        grads = mqa_bwd(q, k, v, slopes, lens, lens, seed, o, lse, do, scale, 0, False, rate)
        grads_ref = mqa_bwd_reference(q, k, v, slopes, lens, lens, seed, o, lse, do, scale, 0,
                                      False, rate)
        fb, bb = attention_bound(q, k, lens, lens), attention_bound(q, k, lens, lens, backward=True)
        shape = f"recipe {label}: B={B} N=M={N} H={H} D=64 bfloat16 dropout={rate}"
        say("recipe-kernels", t0, f"{shape}: K1 o err {fwd_err:.3e} lse err {lse_err:.3e} "
            f"(bound {fwd_bound:.0e}), kept {kept:.4f}; K2 {grad_errs('vs autograd', auto)}; "
            f"{grad_errs('vs plain backward', errs)} (bound "
            f"{bwd_bound:.0e})")
        records += [
            {"name": f"K1 mqa_fwd, recipe {label}", "route": "cuda",
             "source": "isp_tts_tpu_torch/csrc/mqa_fwd.cu",
             "replaces": "isp_tts_tpu/ops/flash_attention.py:736", **counts("K1 mqa_fwd"),
             "max_abs_err": fwd_err,
             "ms": graph_ms(lambda: mqa_fwd(q, k, v, slopes, lens, scale, 0, lens, False, rate,
                                            seed)),
             "plain_ms": cuda_ms(lambda: mqa_attention_reference(
                 q, k, v, slopes, lens, scale, 0, lens, False, rate, seed), iters=3),
             "bound_ms": fb[0], "bound_by": fb[1],
             "library_ms": graph_ms(library_call(q, k, v, slopes, lens, scale)),
             "shape": shape},
            {"name": f"K2 mqa_bwd, recipe {label}", "route": "cuda",
             "source": "isp_tts_tpu_torch/csrc/mqa_bwd.cu",
             "replaces": "isp_tts_tpu/ops/flash_attention.py:998 (K2a)", **counts("K2 mqa_bwd"),
             "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                for a, b in zip(grads, grads_ref)),
             "ms": graph_ms(lambda: mqa_bwd(q, k, v, slopes, lens, lens, seed, o, lse, do,
                                            scale, 0, False, rate)),
             "plain_ms": cuda_ms(lambda: mqa_bwd_reference(
                 q, k, v, slopes, lens, lens, seed, o, lse, do, scale, 0, False, rate), iters=3),
             "bound_ms": bb[0], "bound_by": bb[1],
             "library_ms": library_bwd_ms(q, k, v, slopes, lens, scale, 0, False, do),
             "shape": shape},
        ]
        del q, k, v, o, lse, do, grads, grads_ref
        torch.cuda.empty_cache()

    M, T = RECIPE_MEL, RECIPE_TEXT
    la, _, _ = mas_inputs(B, M, T, gen)
    got = mas.monotonic_alignment_search(la, tl, ml)
    torch.cuda.synchronize()
    ref = mas.monotonic_alignment_search_reference(la, tl, ml)
    if not (torch.equal(got, ref) and torch.equal(got.sum(dim=(1, 2)), ml.float())):
        raise AssertionError(f"K3 at the recipe's shape: {(got != ref).sum().item()} elements "
                             "differ from the plain version, or durations do not sum to mel_len")
    k3b = mas_bound(la, tl, ml)
    shape = f"recipe: B={B} M={M} T={T} float32, a validation batch's lengths"
    records.append(
        {"name": "K3 mas, recipe", "route": "cuda", "source": "isp_tts_tpu_torch/csrc/mas.cu",
         "replaces": "isp_tts_tpu/ops/mas_pallas.py:44 + :66", **counts("K3 mas"),
         "max_abs_err": (got - ref).abs().max().item(),
         "ms": graph_ms(lambda: mas.monotonic_alignment_search(la, tl, ml)),
         "plain_ms": cuda_ms(lambda: mas.monotonic_alignment_search_reference(la, tl, ml),
                             iters=1, warmup=1),
         "bound_ms": k3b[0], "bound_by": k3b[1], "library_ms": None, "shape": shape})
    lp, _, _ = ctc_inputs(B, M, T, gen)
    g = torch.rand((B,), generator=gen, device="cuda")
    neg, ab, al, logz = ctc.ctc_fwd(lp, tl, ml)
    dlp = ctc.ctc_bwd(lp, ab, al, logz, g, tl, ml)
    x = lp.detach().double().requires_grad_()
    neg_r = ctc.ordered_ctc_neg_logp_reference(x, tl, ml)
    (dlp_r,) = torch.autograd.grad((neg_r * g.double()).sum(), x, retain_graph=True)
    loss_err, grad_err = rel_err(neg, neg_r.detach()), rel_err(dlp, dlp_r)
    if not (loss_err <= K4_LOSS_BOUND and grad_err <= K4_GRAD_BOUND):
        raise AssertionError(f"K4 at the recipe's shape: loss {loss_err:.3e} (bound "
                             f"{K4_LOSS_BOUND:.0e}), gradient {grad_err:.3e} (bound "
                             f"{K4_GRAD_BOUND:.0e})")
    say("recipe-kernels", t0, f"K3 B={B} M={M} T={T}: equal to the plain version, durations "
        f"sum to mel_len; K4 loss rel_err={loss_err:.2e} bound={K4_LOSS_BOUND:.0e} grad "
        f"rel_err={grad_err:.2e} bound={K4_GRAD_BOUND:.0e}")
    fb, bb = ctc_fwd_bound(lp, tl, ml), ctc_bwd_bound(lp, tl, ml)
    labels = torch.arange(1, T + 1, device="cuda").repeat(B, 1)
    xl = lp.detach().requires_grad_()

    def library(backward):
        def call():
            loss = F.ctc_loss(xl.transpose(0, 1), labels, ml.long(), tl.long(), blank=0,
                              reduction="sum", zero_infinity=True)
            if backward:
                torch.autograd.grad(loss, xl)
        return cuda_ms(call, iters=5)

    shape = f"recipe: B={B} M={M} T+1={T + 1} float32, a validation batch's lengths"
    records += [
        {"name": "K4 ctc_fwd, recipe", "route": "cuda", "source": "isp_tts_tpu_torch/csrc/ctc.cu",
         "replaces": "isp_tts_tpu/ops/ctc_pallas.py:77", **counts("K4 ctc_fwd"),
         "max_abs_err": (neg - neg_r.detach().float()).abs().max().item(),
         "ms": graph_ms(lambda: ctc.ctc_fwd(lp, tl, ml)),
         "plain_ms": cuda_ms(lambda: ctc.ordered_ctc_neg_logp_reference(lp.double(), tl, ml),
                             iters=1, warmup=1),
         "bound_ms": fb[0], "bound_by": fb[1], "library_ms": library(False),
         "library": "F.ctc_loss, eager", "shape": shape},
        {"name": "K4 ctc_bwd, recipe", "route": "cuda", "source": "isp_tts_tpu_torch/csrc/ctc.cu",
         "replaces": "isp_tts_tpu/ops/ctc_pallas.py:114", **counts("K4 ctc_bwd"),
         "max_abs_err": (dlp - dlp_r.float()).abs().max().item(),
         "ms": graph_ms(lambda: ctc.ctc_bwd(lp, ab, al, logz, g, tl, ml)),
         "plain_ms": cuda_ms(lambda: torch.autograd.grad((neg_r * g.double()).sum(), x,
                                                         retain_graph=True), iters=1, warmup=1),
         "bound_ms": bb[0], "bound_by": bb[1], "library_ms": library(True),
         "library": "F.ctc_loss, eager, forward + backward", "shape": shape},
    ]
    for r in records:
        say("recipe-kernels", t0, f"{r['name']}: {r['shape']}; ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.4f} ({r['bound_by']}) library_ms "
            f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} "
            f"max_abs_err {r['max_abs_err']:.3e} launches {r['launches']} (training "
            f"{r['launches_per_step']} a step, evaluations {r['eval_launches']})")
    return records


# ---------------------------------------------------------------- slope gradients
# The f32 slope gradients of K2 and K5b at B 4, N = M = 1024, H 6, dropout
# 0.1 (a sum of 4M products ds * dist that cancel to a small total) over 16
# draws of dL/do, each from a generator of its own: every draw within 1e-4
# of the plain version's scale (tests/test_torch_port_cuda.py's rule: with
# one key/value head on dv's scale times the largest distance), and each
# side's distance from the same formula in float64 read beside it.
SLOPE_DRAWS = 16
SLOPE_CASES = (("K5b", 1), ("K5b", 6), ("K2", 1))


def phase_slope_draws(t0):
    import torch

    sys.path.insert(0, str(ROOT / "tools"))
    from torch_bwd_seeds import f64_backward, shares

    from isp_tts_tpu_torch.ops import flash_attention as fa

    B, N, M, H, bound = 4, 1024, 1024, 6, 1e-4
    for name, hkv in SLOPE_CASES:
        rng = np.random.RandomState(2)
        q = torch.from_numpy(rng.randn(B, N, H, 64).astype(np.float32)).cuda()
        k = torch.from_numpy(rng.randn(B, M, hkv, 64).astype(np.float32)).cuda()
        v = torch.from_numpy(rng.randn(B, M, hkv, 64).astype(np.float32)).cuda()
        slopes = torch.from_numpy(rng.rand(2, H).astype(np.float32) * 0.3).cuda()
        key_lens = torch.tensor([M, M - 100, M // 2, M - 1], dtype=torch.int32).cuda()
        q_lens = torch.tensor([N, N - 7, N - 300, N // 3], dtype=torch.int32).cuda()
        per_head = name == "K5b"
        if not per_head:
            k, v = k[:, :, 0].contiguous(), v[:, :, 0].contiguous()
        fwd, bwd, plain = ((fa.flash_fwd, fa.flash_bwd, fa.flash_bwd_reference) if per_head
                           else (fa.mqa_fwd, fa.mqa_bwd, fa.mqa_bwd_reference))
        seed = seed_tensor(41)
        o, lse = fwd(q, k, v, slopes, key_lens, 0.125, 0, q_lens, False, 0.1, seed)
        worst = {"kernel": 0.0, "kernel/f64": 0.0, "plain/f64": 0.0}
        for draw in range(SLOPE_DRAWS):
            gen = torch.Generator(device="cuda").manual_seed(draw)
            w = torch.randn(q.shape, generator=gen, device="cuda")
            args = (q, k, v, slopes, key_lens, q_lens, seed, o, lse, w, 0.125, 0, False, 0.1)
            got, ref = bwd(*args), plain(*args)
            exact = f64_backward(q, k, v, slopes, key_lens, seed, o, lse, w, 0.125, 0, False,
                                 0.1, per_head)
            read = {"kernel": shares(got, ref, bound, N)[3],
                    "kernel/f64": shares(got, exact, bound, N)[3],
                    "plain/f64": shares(ref, exact, bound, N)[3]}
            worst = {key: max(worst[key], read[key]) for key in worst}
            if read["kernel"] > 1.0:
                raise AssertionError(f"{name} Hkv={hkv} draw {draw}: dslopes at "
                                     f"{read['kernel']:.3f} of its 1e-4 allowance")
            del got, ref, exact
        torch.cuda.empty_cache()
        say("slopes", t0, f"{name} f32 B={B} N=M={N} H={H} Hkv={hkv} dropout 0.1, "
            f"{SLOPE_DRAWS} draws: dslopes max share of the 1e-4 allowance " + ", ".join(
                f"{key} {val:.3f}" for key, val in worst.items()))


# ---------------------------------------------------------------- vocoder GAN
GAN_RECIPE = "vocoder/vocos"
GAN_STEPS, GAN_EVERY = 16, 8
GAN_BATCH, GAN_SEGMENT = 16, 16384  # the recipe's batch and segment
GAN_TRAIN = 128  # utterances: one epoch is 8 steps, so step 8 ends an epoch
GAN_DIM, GAN_LAYERS = 512, 8  # the recipe's generator width and depth
#: the smoke's GAN runs: the recipe at its widths, warm-started from the
#: committed vocoder (its generator; the discriminators from the seed), 16
#: steps, evaluating (2 batches, and once before the first step) and saving
#: every 8
GAN_SETTINGS = {
    "trainer.max_steps": GAN_STEPS, "trainer.batch_size": GAN_BATCH,
    "trainer.eval_batch_size": GAN_BATCH, "trainer.eval_steps": GAN_EVERY,
    "trainer.save_steps": GAN_EVERY, "trainer.eval_batches": 2,
    "trainer.eval_first_step": True, "trainer.logging_steps": 1, "trainer.log_with": [],
    "trainer.label": "smoke", "trainer.resume_from_checkpoint": str(VOCODER),
    "trainer.warm_start": True, "trainer.metric_for_best_model": None,
}
# one f32 GAN step on the card against the same step on the CPU (TF32 off):
# each loss term and gradient norm within GAN_LOSS_BOUND of the CPU's; every
# updated parameter within GAN_PARAM_BOUND of it, but for at most
# GAN_FLIP_SHARE of them, which may differ by up to two first AdamW updates
# (2 x lr): the first update is lr * g / (|g| + eps), about lr * sign(g), so
# a gradient within the two devices' rounding of zero flips it (1.7e-4 of
# the parameters flip on an NVIDIA H100 80GB HBM3; PERF.md section 6)
GAN_LOSS_BOUND = 1e-4
GAN_PARAM_BOUND = 1e-5
GAN_FLIP_SHARE = 1e-3
# the generator's evaluation mel L1 after 16 steps against the warm start's
# (0.2074 against 0.2513, 0.83x, on an NVIDIA H100 80GB HBM3; PERF.md
# section 6: the fresh discriminators' first steps may move it either way)
GAN_MEL_FACTOR = 1.25


def gan_data(data: dict) -> dict:
    """The recipe's dataset settings on the dataset phase's WAVs: the first
    GAN_TRAIN training utterances (meta_gan.csv) and the 64 validation ones."""
    root = Path(data["dataset.root"])
    lines = (root / "meta_train.csv").read_text().splitlines()[:GAN_TRAIN]
    (root / "meta_gan.csv").write_text("\n".join(lines) + "\n")
    return {"dataset.root": str(root), "dataset._train_.meta_name": "meta_gan.csv",
            "dataset._eval_.meta_name": "meta_valid.csv"}


def phase_wav_decode(t0, data: dict) -> None:
    """The native decoder's batch against the port's Python reader on 32 of
    the dataset's WAVs: bit-equal, and each reader's ms per batch of 32."""
    from isp_tts_tpu_torch.data.audio import DECODED, load_audio, load_audio_batch

    root = Path(data["dataset.root"])
    paths = [root / line.split("|")[0]
             for line in (root / "meta_train.csv").read_text().splitlines()[:32]]
    before = dict(DECODED)
    native = load_audio_batch(paths, 22050, native=True)
    python = [load_audio(p, 22050, native=False) for p in paths]
    if DECODED["native"] - before["native"] != 32 or DECODED["python"] - before["python"] != 32:
        raise AssertionError(f"readers {DECODED} (before {before})")
    for p, a, b in zip(paths, native, python):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{p.name}: the native decode is not bit-equal to the Python "
                                 "reader's")
    times = {}
    for name, fn in (("native", lambda: load_audio_batch(paths, 22050, native=True)),
                     ("python", lambda: [load_audio(p, 22050, native=False) for p in paths])):
        t = time.perf_counter()
        for _ in range(5):
            fn()
        times[name] = 1e3 * (time.perf_counter() - t) / 5
    say("wav-decode", t0, f"32 WAVs ({sum(len(a) for a in native) / 22050:.1f} s of audio) "
        f"bit-equal; ms per batch of 32: native {times['native']:.2f} (thread pool), Python "
        f"reader {times['python']:.2f}")


def gan_modules(settings: dict, out: Path, device: str, **trainer):
    from isp_tts_tpu_torch.training.experiment import ExperimentModules

    over = recipe_overrides({**settings, **GAN_SETTINGS, "trainer.output_dir": str(out),
                             **{f"trainer.{k}": v for k, v in trainer.items()}})
    return ExperimentModules(GAN_RECIPE, str(ROOT / "recipes"), overrides=over,
                             device=device).init_modules()


def check_gan_widths(model) -> None:
    gen, disc = model.generator, model.discriminator
    if (gen.config.dim != GAN_DIM or len(gen.blocks) != GAN_LAYERS
            or len(disc.period_discs) != 5 or len(disc.resolution_discs) != 3
            or disc.config.mpd_channels[-1] != 1024):
        raise AssertionError("the GAN run is not vocoder/vocos at its widths")


def phase_gan_step(t0, settings: dict, out: Path):
    """One f32 GAN step at the recipe's widths on the card against the same
    step on the CPU (same weights, same batch), then the card's bf16 step
    finite. Returns the bf16 trainer and its batch."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gan_modules(settings, out / "card", "cuda", precision="fp32").build_trainer()
    cpu = gan_modules(settings, out / "cpu", "cpu", precision="fp32").build_trainer()
    check_gan_widths(card.model)
    before = card.model.jax_state()
    for key, arr in cpu.model.jax_state().items():
        if not np.array_equal(arr, before[key]):
            raise AssertionError(f"card and CPU models differ before the step at {key}")
    batch = next(iter(card.train_loader))
    if batch["audio"].shape != (GAN_BATCH, GAN_SEGMENT):
        raise AssertionError(f"batch {batch['audio'].shape}")
    lr = card.schedule(0, 0)
    results = []
    for tr in (card, cpu):
        tr._set_lr(lr)
        if tr is card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        metrics, _ = tr._update(batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        results.append((metrics, time.perf_counter() - t))
    (got, card_s), (ref, cpu_s) = results
    loss_err = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-6) for k in ref}
    after_card, after_cpu = card.model.jax_state(), cpu.model.jax_state()
    diffs = np.concatenate([np.abs(after_card[k] - after_cpu[k]).ravel() for k in after_cpu])
    moved = max(float(np.abs(after_cpu[k] - before[k]).max()) for k in after_cpu)
    past = int((diffs > GAN_PARAM_BOUND).sum())
    say("gan-step", t0, f"{GAN_RECIPE} at its widths ({sum(p.numel() for p in card.model.generator.parameters()) / 1e6:.2f}M "
        f"generator, {sum(p.numel() for p in card.model.discriminator.parameters()) / 1e6:.2f}M "
        f"discriminator parameters), batch {GAN_BATCH} x {GAN_SEGMENT}, f32, one step on the "
        f"card against the CPU: metrics {', '.join(f'{k} {got[k]:.6g}' for k in got)}; "
        f"relative errors {', '.join(f'{k} {v:.2e}' for k, v in loss_err.items())} (bound "
        f"{GAN_LOSS_BOUND:.0e}); parameters moved up to {moved:.3e}, card against CPU max "
        f"{diffs.max():.3e}, {past} of {diffs.size} past {GAN_PARAM_BOUND:.0e} (at most "
        f"{GAN_FLIP_SHARE:.0e} of them, each within 2 x lr); step {1e3 * card_s:.1f} ms on "
        f"the card (first, cold), {cpu_s:.1f} s on the CPU")
    if (max(loss_err.values()) > GAN_LOSS_BOUND or past > GAN_FLIP_SHARE * diffs.size
            or diffs.max() > 2 * lr + GAN_PARAM_BOUND):
        raise AssertionError("the card's GAN step left the CPU's")
    del cpu, card
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    bf16 = gan_modules(settings, out / "bf16", "cuda").build_trainer()
    if bf16.config.precision != "bf16":
        raise AssertionError(f"the recipe's precision is {bf16.config.precision}")
    batch = next(iter(bf16.train_loader))
    hist = bf16.train([batch], 2)
    bad = [k for h in hist for k, v in h.items() if not np.isfinite(v)]
    state = bf16.model.jax_state()
    bad += [k for k, v in state.items() if not np.isfinite(v).all()]
    if bad:
        raise AssertionError(f"the bf16 GAN steps are not finite: {bad[:5]}")
    say("gan-step", t0, "bf16 (the recipe's precision), two steps on the card: finite, "
        + ", ".join(f"{k} {v:.5g}" for k, v in hist[-1].items()))
    return bf16, batch


def phase_gan_recipe(t0, settings: dict, out: Path):
    """``vocoder/vocos`` at its widths through the CLI, then in process;
    the native decoder read every WAV of the in-process run."""
    import torch

    from isp_tts_tpu_torch.checkpoint import load_checkpoint
    from isp_tts_tpu_torch.data.audio import DECODED
    from isp_tts_tpu_torch.training.gan_trainer import BRANCHES
    from isp_tts_tpu_torch.training.optimizers import jax_param_name, keystr

    t = time.perf_counter()
    train_cli(set_args({**settings, **GAN_SETTINGS, "trainer.output_dir": str(out / "cli")}),
              recipe=GAN_RECIPE)
    cli_s = time.perf_counter() - t
    cli_ckpt = out / "cli" / "VocoderModel" / "smoke" / "checkpoint_last.ckpt"
    if load_checkpoint(cli_ckpt)["experiment"]["state"]["global_step"] != GAN_STEPS:
        raise AssertionError("the CLI run did not take its steps")
    shutil.rmtree(out / "cli")
    say("gan-recipe", t0, f"python -m isp_tts_tpu_torch.train --config-name {GAN_RECIPE} "
        f"({GAN_STEPS} steps, eval and save every {GAN_EVERY}): exit 0 in {cli_s:.1f} s")

    DECODED.update(native=0, python=0)
    trainer, clock = recipe_trainer(settings, out / "run", recipe=GAN_RECIPE, base=GAN_SETTINGS)
    model = trainer.model
    check_gan_widths(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts(reset=True)
    t = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launch_counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    if DECODED["native"] == 0 or DECODED["python"]:
        raise AssertionError(f"the loader's WAV decode: {DECODED}")
    if any(launches.values()):
        raise AssertionError(f"the GAN path launched attention or DP kernels: {launches}")
    disc = step_losses(trainer, "train_step/losses/disc")
    gen = step_losses(trainer, "train_step/loss")
    bad = [k for h in trainer.state.log_history for k, v in h.items()
           if isinstance(v, float) and not np.isfinite(v)]
    if bad or sorted(disc) != list(range(1, GAN_STEPS + 1)):
        raise AssertionError(f"non-finite or missing step metrics: {bad}, steps {sorted(disc)}")
    first = np.mean([disc[s] for s in range(1, GAN_EVERY + 1)])
    last = np.mean([disc[s] for s in range(GAN_EVERY + 1, GAN_STEPS + 1)])
    evals = {h["step"]: h for h in trainer.state.log_history if "eval/losses/mel" in h}
    mel0, mel16 = evals[0]["eval/losses/mel"], evals[GAN_STEPS]["eval/losses/mel"]
    say("gan-recipe", t0, f"in process: {GAN_STEPS} steps in {wall:.2f} s; losses/disc per "
        "step " + ", ".join(f"{disc[s]:.4f}" for s in sorted(disc)) + f" (steps 1-{GAN_EVERY} "
        f"mean {first:.4f}, {GAN_EVERY + 1}-{GAN_STEPS} mean {last:.4f}); generator loss "
        + ", ".join(f"{gen[s]:.3f}" for s in sorted(gen)) + "; evaluation mel L1 "
        + ", ".join(f"step {s} {h['eval/losses/mel']:.4f}" for s, h in sorted(evals.items()))
        + ", spectral convergence " + ", ".join(
            f"{h.get('eval/metrics/spectral_convergence', float('nan')):.4f}"
            for _, h in sorted(evals.items()))
        + f"; WAVs decoded natively {DECODED['native']}, by the Python reader "
        f"{DECODED['python']}")
    if not last < first:
        raise AssertionError("the discriminator's loss did not fall")
    if not mel16 <= GAN_MEL_FACTOR * mel0:
        raise AssertionError(f"evaluation mel L1 {mel16:.4f} past {GAN_MEL_FACTOR} x the warm "
                             f"start's {mel0:.4f}")
    # host time per step: the step starts (synced), less evaluations and saves
    step_ms = np.diff(clock.starts + [t + wall]) * 1e3
    step_ms = [round(float(c - 1e3 * (clock.eval_s.get(i, 0.0) + clock.save_s.get(i, 0.0))), 2)
               for i, c in enumerate(step_ms) if i > 0]
    say("gan-recipe", t0, f"host ms per GAN step (steps 2-{GAN_STEPS}, synced at step starts, "
        f"eval and save left out) {step_ms}, median {np.median(step_ms):.2f}; checkpoint save "
        f"s {[round(x, 3) for x in trainer.save_seconds]}; eval s {clock.eval_s}; peak memory "
        f"{peak_mib:.0f} MiB")

    ckpt = load_checkpoint(trainer.run_dir / "checkpoint_last.ckpt")
    state = model.jax_state()
    if ckpt["model"]["class"] != "VocoderModel" or set(ckpt["model"]["state"]) != set(state):
        raise AssertionError("checkpoint_last.ckpt: wrong class or tensor names")
    for name, arr in state.items():
        if not np.array_equal(ckpt["model"]["state"][name], arr):
            raise AssertionError(f"checkpoint_last.ckpt: {name} is not bit-equal")
    keyed = ckpt["optimizer"]["keyed"]
    for key, branch in BRANCHES:
        module = getattr(model, branch)
        missing = [n for n, _ in module.named_parameters()
                   if not any(k.startswith(f"['{key}']") and ".mu" in k
                              and k.endswith(keystr(jax_param_name(module, n)[0]))
                              for k in keyed)]
        if missing:
            raise AssertionError(f"{branch}: optimizer moments missing for {missing[:5]}")
    return trainer


def phase_gan_resume(t0, settings: dict, out: Path, first) -> None:
    """A second uninterrupted GAN run (the control) and one resumed from the
    first's step-8 checkpoint: steps 9-16 and the final parameters within
    twice the control (bit-identical if it is)."""
    import torch

    # these two write only their final checkpoint (~660 MB, ~5.5 s each)
    second, _ = recipe_trainer(settings, out / "control", recipe=GAN_RECIPE, base=GAN_SETTINGS,
                               eval_first_step=False, save_strategy="no")
    second.train()
    ckpt = first.run_dir / f"checkpoint_s{GAN_EVERY}.ckpt"
    resumed, _ = recipe_trainer(settings, out / "resumed", recipe=GAN_RECIPE, base=GAN_SETTINGS,
                                resume_from_checkpoint=str(ckpt), warm_start=False,
                                eval_first_step=False, save_strategy="no")
    if resumed.state.global_step != GAN_EVERY:
        raise AssertionError(f"resumed at step {resumed.state.global_step}")
    resumed.train()
    torch.cuda.synchronize()
    steps = range(GAN_EVERY + 1, GAN_STEPS + 1)
    la, lb, lc = (step_losses(x) for x in (first, second, resumed))
    loss_ctl = max(abs(lb[s] - la[s]) for s in steps)
    loss_err = max(abs(lc[s] - la[s]) for s in steps)
    pa, pb, pc = (x.model.jax_state() for x in (first, second, resumed))
    param_ctl = max(float(np.abs(pb[k] - pa[k]).max()) for k in pa)
    param_err = max(float(np.abs(pc[k] - pa[k]).max()) for k in pa)
    exact = loss_ctl == 0.0 and param_ctl == 0.0
    ok = (loss_err == 0.0 and param_err == 0.0) if exact else (
        loss_err <= 2 * loss_ctl and param_err <= 2 * param_ctl)
    say("gan-resume", t0, f"steps {steps.start}-{steps.stop - 1}: generator loss max |resumed "
        f"- first| {loss_err:.3e}, control |second - first| {loss_ctl:.3e}; final parameters "
        f"{param_err:.3e}, control {param_ctl:.3e} (bound 2x control"
        f"{', bit-identical' if exact else ''}); checkpoint load {resumed.load_seconds:.3f} s")
    if not ok:
        raise AssertionError("the resumed GAN run left the uninterrupted one")


def main() -> int:
    import torch

    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    phase_env(t0)
    phase_build(t0)
    phase_sass(t0)
    phase_kernel(t0)
    phase_kernel_train(t0)
    phase_kernel_mha(t0)
    phase_tp_heads(t0)
    phase_slope_draws(t0)
    phase_head_dims(t0)
    synth, serve_launches, reference = phase_slice(t0)
    phase_profile(t0, lambda: synth(SENTENCES[0]), "one sentence")
    phase_profile(t0, lambda: synth(SENTENCES), "batch of 3")
    phase_vocoder(t0, synth, reference)
    phase_serve_bf16(t0, synth(SENTENCES))
    audio_synth, audio_launches = phase_serve_audio(t0)
    phase_profile_audio(t0, audio_synth)
    phase_serve_devices(t0)
    phase_cli(t0)
    phase_daemon(t0, audio_synth)
    work = Path(tempfile.mkdtemp(dir=ROOT, prefix="_smoke_recipe_"))
    (work / "export").mkdir()
    artifact_launches = phase_export(t0, audio_synth, work / "export")
    data = phase_dataset(t0, audio_synth, work / "data")
    del audio_synth
    mha_synth, mha_serve_launches = phase_slice_mha(t0, reference)
    phase_profile(t0, lambda: mha_synth(SENTENCES[0]), "one sentence, multi-KV-head")
    mha_artifact_launches = phase_export_mha(t0, mha_synth, work / "export")
    del mha_synth
    experiment, batch, durations = phase_batch(t0, synth)
    del synth
    phase_interop(t0, experiment, batch, reference, work / "export")
    shutil.rmtree(work / "export", ignore_errors=True)
    del reference
    trainer, train_launches = phase_train(t0, experiment, batch, durations)
    phase_profile(t0, lambda: trainer.train([batch], 1), "one training step")
    del trainer
    phase_dist_one(t0, experiment, batch)
    phase_seq_stage(t0, experiment, batch)
    phase_tf32(t0, experiment, batch)
    phase_interface(t0)
    phase_batch_norm(t0, experiment, batch)
    mha_trainer, mha_launches = phase_train(t0, experiment, batch, durations, mha=True)
    phase_profile(t0, lambda: mha_trainer.train([batch], 1),
                  "one training step, multi-KV-head")
    del mha_trainer
    phase_kv_grad(t0, experiment, batch)
    records = kernel_records(batch, train_launches, serve_launches, mha_launches,
                             mha_serve_launches, audio_launches, artifact_launches,
                             mha_artifact_launches)
    try:
        torch.cuda.empty_cache()
        data = phase_stats(t0, data)
        recipe, recipe_launches, recipe_eval_launches = phase_recipe(t0, data, work / "runs")
        phase_resume(t0, data, work / "runs", recipe)
        recipe_batch = next(iter(recipe.train_loader))
        phase_profile(t0, lambda: recipe.train([recipe_batch], 1),
                      f"one recipe training step ({RECIPE_TEXT} x {RECIPE_MEL}, bf16)")
        records += recipe_records(t0, recipe, recipe_launches, recipe_eval_launches)
        del recipe
        torch.cuda.empty_cache()
        split = phase_head_dim_path(t0, data, work / "split")
        records += head_dim_records(batch, split)
        torch.cuda.empty_cache()
        phase_wav_decode(t0, data)
        gdata = gan_data(data)
        gan_bf16, gan_batch = phase_gan_step(t0, gdata, work / "gan_step")
        phase_profile(t0, lambda: gan_bf16.train([gan_batch], 1),
                      f"one GAN step ({GAN_RECIPE}, batch {GAN_BATCH} x {GAN_SEGMENT}, bf16)")
        del gan_bf16
        shutil.rmtree(work / "gan_step", ignore_errors=True)
        gan = phase_gan_recipe(t0, gdata, work / "gan")
        phase_gan_resume(t0, gdata, work / "gan", gan)
        del gan
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say("done", t0)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
