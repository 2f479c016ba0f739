#!/usr/bin/env python3
"""The ALiBi slope gradient of a cross-attention layer at far offsets,
against float64, on one NVIDIA card:

    python3 tools/torch_slope_study.py

On the committed checkpoint's first decoder layer (384 wide, 6 heads x 64,
one key/value head and H), non-causal, at ``chip_smoke.CROSS_SHAPES`` (mel
320 against text 48, 1024 against 192: offsets -272 and -832), the inputs
K1/K2 or K5a/K5b take in ``flash: on`` are captured with the gradient of
the layer's loss at their output. On those inputs it prints each slope
gradient's distance from float64 autograd through the plain forward,
relative to its max-abs:
- ``kernel``: the kernel forward and backward;
- ``plain, nearest key``: the plain backward on the kernel's o and lse,
  summing ds times each key's distance from the row's nearest valid key
  (``ops/flash_attention.py:_slope_arms``), as the kernel does;
- ``plain, ALiBi distance``: the same summing ds times the ALiBi distance
  -|c - n - offset|, as the TPU kernels do: where a row's valid keys all
  lie on one side, delta's error (o is the forward's rounded output) times
  the row's shared distance enters the sum;
and the forward's o distance from float64, the kernel's and the f32 plain
version's (absolute). f32 and bf16 (autocast), TF32 off.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402


def alibi_arms(key_lens, offset, causal, N, M, device, dtype):
    n = torch.arange(N, device=device)[:, None]
    c = torch.arange(M, device=device)[None, :]
    return -(c - n - offset).abs().to(dtype)[None, :, None, :]


def captured(layer, core: str, B, N, M, dtype):
    """The layer's ``flash: on`` call as :func:`chip_smoke.cross_check`
    makes it: (the core's positional args, its keyword args, dL/d(output))."""
    import isp_tts_tpu_torch.nn.attention as att

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
    rec, orig = {}, getattr(att, core)

    def spy(*args, **kw):
        out = orig(*args, **kw)
        rec["args"], rec["kw"] = args, kw
        out.register_hook(lambda g: rec.__setitem__("do", g))
        return out

    setattr(att, core, spy)
    try:
        layer.flash = "on"
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
            out = layer(x, mask=mask, context=ctx, context_mask=cmask)
        (out.float() * w).sum().backward()
    finally:
        setattr(att, core, orig)
        layer.flash = "auto"
        layer.zero_grad(set_to_none=True)
    args = [a.detach() if torch.is_tensor(a) else a for a in rec["args"]]
    return args, rec["kw"], rec["do"]


def readings(mha: bool, B, N, M, dtype) -> dict:
    from isp_tts_tpu_torch.ops import flash_attention as fa

    layer = smoke.causal_decoder(mha).layers[0].attention.train()
    layer.causal = False
    layer.dropout.rate = 0.0
    core = "flash_attention" if mha else "mqa_attention"
    (q, k, v, slopes, key_lens, scale, offset), kw, do = captured(layer, core, B, N, M, dtype)
    q_lens, causal = kw["q_lens"], kw["causal"]
    fwd, bwd, pfwd, pbwd = ((fa.flash_fwd, fa.flash_bwd, fa.flash_attention_reference,
                             fa.flash_bwd_reference) if mha else
                            (fa.mqa_fwd, fa.mqa_bwd, fa.mqa_attention_reference,
                             fa.mqa_bwd_reference))
    seed = smoke.seed_tensor(0)
    o, lse = fwd(q, k, v, slopes, key_lens, scale, offset, q_lens, causal, 0.0, seed)

    def grads(back, o_, lse_):
        return back(q, k, v, slopes, key_lens, q_lens, seed, o_, lse_, do, scale, offset,
                    causal, 0.0)

    wide = [t.double().requires_grad_() for t in (q, k, v, slopes)]
    o64, _ = pfwd(*wide, key_lens, scale, offset, q_lens, causal)
    exact = torch.autograd.grad(o64, wide, do.double())[3]
    o32, _ = pfwd(q, k, v, slopes, key_lens, scale, offset, q_lens, causal)
    out = {"kernel": smoke.rel_err(grads(bwd, o, lse)[3], exact),
           "plain, nearest key": smoke.rel_err(grads(pbwd, o, lse)[3], exact)}
    arms, fa._slope_arms = fa._slope_arms, alibi_arms
    try:
        out["plain, ALiBi distance"] = smoke.rel_err(grads(pbwd, o, lse)[3], exact)
    finally:
        fa._slope_arms = arms
    o64 = o64.detach()
    out["o: kernel"] = (o.double() - o64).abs().max().item()
    out["o: plain f32"] = (o32.double() - o64).abs().max().item()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from isp_tts_tpu_torch.ops import cuda_build

    cuda_build.build_all([f"{name}_d64" for name in smoke.ATTENTION_SOURCES])
    print(f"{torch.cuda.get_device_name(0)}; slope gradient relative to max-abs, o absolute, "
          "against float64", flush=True)
    result = {}
    for mha in (False, True):
        for B, N, M in smoke.CROSS_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                label = (f"{'K5a/K5b' if mha else 'K1/K2'} B {B} mel {N} text {M} "
                         f"(offset {M - N}) {str(dtype)[6:]}")
                result[label] = readings(mha, B, N, M, dtype)
                print(f"{label}: " + "; ".join(f"{k} {v:.3e}" for k, v in result[label].items()),
                      flush=True)
    print(json.dumps({"slope_study": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
