#!/usr/bin/env python3
"""The attention kernels (K1, K5a forwards; K2, K5b backwards) run in the
CPU emulation of this directory and held against their plain versions, on
a machine without a GPU or nvcc (g++ only):

    python3 tools/cuda_emu/check_attention.py [--sweep] [--out DIR]

Each case prints the kernel's error relative to the plain version's
max-abs (o and lse forward; dq, dk, dv and dslopes backward). The bounds
are the card's: f32 1e-4, bf16 2e-2. With one key (M = 1) dq, dk and
dslopes vanish in exact arithmetic, so they are read on dv's scale (times
the largest distance for dslopes), as the ``cuda`` tests do. ``--sweep``
adds row and key counts of 1, 63, 64, 65 and 70 in both types, causal and
not, with and without row splits. A case takes about a second; the
emulation says nothing of speed, registers or races between warps: only
the card does.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(HERE))

import emubuild  # noqa: E402
from isp_tts_tpu_torch.ops import flash_attention as fa  # noqa: E402

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SCALE = 0.125


def inputs(B, N, M, H, Hkv, dtype, seed=3):
    """q, k, v, dO in ``dtype``, slopes, ragged lengths (with B > 2 a key
    length of 0 and a query length of 0)."""
    g = torch.Generator().manual_seed(seed)
    kv = (B, M, 64) if Hkv is None else (B, M, Hkv, 64)
    q = torch.randn(B, N, H, 64, generator=g).to(dtype)
    k, v = torch.randn(kv, generator=g).to(dtype), torch.randn(kv, generator=g).to(dtype)
    do = torch.randn(B, N, H, 64, generator=g).to(dtype)
    sl = torch.rand(2, H, generator=g) * 0.3
    kl = torch.randint(M // 2, M + 1, (B,), generator=g, dtype=torch.int32)
    ql = torch.randint(N // 2, N + 1, (B,), generator=g, dtype=torch.int32)
    kl[0], ql[0] = M, N
    if B > 2:
        kl[1], ql[2] = 0, 0
    return q, k, v, do, sl, kl, ql


def rel(a, b, scale=None):
    d = (a.float() - b.float()).abs().max()
    return (d / (b if scale is None else scale).float().abs().max().clamp_min(1e-30)).item()


def forward(libs, B, N, M, H, Hkv, dtype, causal, offset, rate):
    q, k, v, _, sl, kl, ql = inputs(B, N, M, H, Hkv, dtype)
    sd = torch.tensor([77], dtype=torch.int32)
    thresh, inv = fa.drop_params(rate) or (256, 1.0)
    o = torch.empty_like(q)
    ptrs = [x.data_ptr() for x in (q, k, v, sl, kl, ql, sd, o)]
    code = 0 if dtype == torch.float32 else 1
    if Hkv is None:
        lse = torch.empty(B, N * H)
        fn = libs["mqa_fwd"].isp_mqa_fwd
        fn.argtypes = [P] * 9 + [I] * 6 + [F, I, F, I, P]
        err = fn(*ptrs, lse.data_ptr(), B, N, M, H, offset, int(causal), SCALE, thresh, inv,
                 code, None)
        ref, lref = fa.mqa_attention_reference(q, k, v, sl, kl, SCALE, offset, ql, causal, rate,
                                               sd)
    else:
        lse = torch.empty(B, H, N)
        fn = libs["flash_fwd"].isp_flash_fwd
        fn.argtypes = [P] * 9 + [I] * 7 + [F, I, F, I, P]
        err = fn(*ptrs, lse.data_ptr(), B, N, M, H, Hkv, offset, int(causal), SCALE, thresh,
                 inv, code, None)
        ref, lref = fa.flash_attention_reference(q, k, v, sl, kl, SCALE, offset, ql, causal,
                                                 rate, sd)
    assert err == 0, err
    live = torch.isfinite(lref)
    assert torch.equal(torch.isfinite(lse), live), "dead rows differ"
    return [rel(o, ref), rel(lse[live], lref[live]) if live.any() else 0.0]


def backward(libs, B, N, M, H, Hkv, dtype, causal, offset, rate, splits=1):
    q, k, v, do, sl, kl, ql = inputs(B, N, M, H, Hkv, dtype)
    sd = torch.tensor([77], dtype=torch.int32)
    thresh, inv = fa.drop_params(rate) or (256, 1.0)
    plain_fwd, plain_bwd = ((fa.mqa_attention_reference, fa.mqa_bwd_reference) if Hkv is None
                            else (fa.flash_attention_reference, fa.flash_bwd_reference))
    o, lse = plain_fwd(q, k, v, sl, kl, SCALE, offset, ql, causal, rate, sd)
    ref = plain_bwd(q, k, v, sl, kl, ql, sd, o, lse, do, SCALE, offset, causal, rate)
    nan = float("nan")
    dq, dk, dv = (torch.full_like(x, nan) for x in (q, k, v))
    dsl, delta = torch.zeros(2, H), torch.full(lse.shape, nan)
    work = torch.full((splits, 2, *k.shape), nan) if splits > 1 else None
    ptrs = [x.data_ptr() for x in (q, k, v, sl, kl, ql, sd, o, lse, do, dq, dk, dv, dsl, delta)]
    ptrs.append(None if work is None else work.data_ptr())
    code = 0 if dtype == torch.float32 else 1
    if Hkv is None:
        fn = libs["mqa_bwd"].isp_mqa_bwd
        fn.argtypes = [P] * 16 + [I] * 6 + [F, I, F, I, I, P]
        err = fn(*ptrs, B, N, M, H, offset, int(causal), SCALE, thresh, inv, splits, code, None)
    else:
        fn = libs["flash_bwd"].isp_flash_bwd
        fn.argtypes = [P] * 16 + [I] * 7 + [F, I, F, I, I, P]
        err = fn(*ptrs, B, N, M, H, Hkv, offset, int(causal), SCALE, thresh, inv, splits, code,
                 None)
    assert err == 0, err
    one_key = M == 1
    dv_scale, far = ref[2], N + abs(offset)
    return [rel(a, b, dv_scale * (far if i == 3 else 1) if one_key and i != 2 else None)
            for i, (a, b) in enumerate(zip((dq, dk, dv, dsl), ref))]


CASES = [  # B, N, M, H, Hkv (None: folded MQA), dtype, causal, offset, rate, splits
    (2, 37, 45, 6, None, torch.float32, False, 0, 0.0, 1),
    (3, 20, 70, 4, None, torch.float32, True, -5, 0.1, 1),
    (2, 70, 40, 3, None, torch.bfloat16, False, 0, 0.1, 3),
    (3, 20, 70, 4, 4, torch.float32, True, -5, 0.1, 1),
    (3, 66, 33, 3, 1, torch.float32, False, 7, 0.1, 2),
    (2, 40, 130, 2, 2, torch.bfloat16, True, 70, 0.1, 1),
    (3, 65, 64, 2, 1, torch.bfloat16, False, 0, 0.0, 1),
]


def sweep():
    for (N, M), kv, causal, dtype, splits in itertools.product(
            [(1, 1), (63, 65), (64, 64), (65, 63), (1, 70), (70, 1)], ["H", 1, None],
            [False, True], [torch.float32, torch.bfloat16], [1, 2]):
        yield (3, N, M, 3, None if kv is None else (3 if kv == "H" else 1), dtype, causal,
               -5 if causal else 0, 0.1, splits)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true", help="add the tile-edge sweep")
    ap.add_argument("--out", type=Path, help="build directory (default: a temporary one)")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="cuda_emu_") as tmp:
        libs = emubuild.build(ROOT / "isp_tts_tpu_torch/csrc",
                              ["mqa_fwd", "flash_fwd", "mqa_bwd", "flash_bwd"], args.out or Path(tmp))
        bad = []
        for case in CASES + (list(sweep()) if args.sweep else []):
            B, N, M, H, Hkv, dtype, causal, offset, rate, splits = case
            bound = 1e-4 if dtype == torch.float32 else 2e-2
            results = [("forward o/lse", forward(libs, *case[:-1]))] if splits == 1 else []
            results.append(("backward dq/dk/dv/dslopes", backward(libs, *case)))
            for what, errs in results:
                ok = all(e <= bound for e in errs)
                bad += [] if ok else [(case, what, errs)]
                print(f"{'ok  ' if ok else 'FAIL'} B={B} N={N} M={M} H={H} Hkv={Hkv} "
                      f"{str(dtype).replace('torch.', '')} causal={int(causal)} offset={offset} "
                      f"dropout={rate} splits={splits} {what}: "
                      + " ".join(f"{e:.1e}" for e in errs), flush=True)
    print(f"{len(bad)} failing" if bad else "all within bounds")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
