#!/usr/bin/env python3
"""The attention kernels (K1, K5a forwards; K2, K5b backwards) run in the
CPU emulation of this directory and held against their plain versions, on
a machine without a GPU or nvcc (g++ only):

    python3 tools/cuda_emu/check_attention.py [--sweep] [--out DIR]

Each case prints the kernel's error relative to the plain version's
max-abs (o and lse forward; dq, dk, dv and dslopes backward). The bounds
are the card's: f32 1e-4, bf16 2e-2. With one key (M = 1) dq, dk and
dslopes vanish in exact arithmetic, so they are read on dv's scale (times
the largest distance for dslopes), as the ``cuda`` tests do. The cases
run at head dim 64 (the tile width 64), and ``HEAD_DIM_CASES`` at head
dims 8, 32, 96 and 128 (tile widths 16, 32 and 128, 96 below its tile's
width), with the f32 forward at tile width 128 (its own kernel) at its
tile edges and a far offset. ``--sweep`` adds row and key counts of 1, 63,
64, 65 and 70 in both types, causal and not, with and without row splits.
A case takes
about a second; the emulation says nothing of speed, registers or races
between warps: only the card does.
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

P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
SCALE = 0.125


def inputs(B, N, M, H, Hkv, dtype, seed=3, D=64):
    """q, k, v, dO in ``dtype`` at head dim ``D``, slopes, ragged lengths
    (with B > 2 a key length of 0 and a query length of 0)."""
    g = torch.Generator().manual_seed(seed)
    kv = (B, M, D) if Hkv is None else (B, M, Hkv, D)
    q = torch.randn(B, N, H, D, generator=g).to(dtype)
    k, v = torch.randn(kv, generator=g).to(dtype), torch.randn(kv, generator=g).to(dtype)
    do = torch.randn(B, N, H, D, generator=g).to(dtype)
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


def libraries(D_values=(64,)) -> list[str]:
    """The attention libraries the cases at head dims ``D_values`` launch."""
    return sorted({fa.kernel_library(src, D) for src in ("mqa_fwd", "flash_fwd", "mqa_bwd",
                                                         "flash_bwd") for D in D_values})


def forward(libs, B, N, M, H, Hkv, dtype, causal, offset, rate, origin=(0, 0, None), D=64):
    """Kernel against plain version; ``origin`` = (batch0, head0,
    heads_total) places the call in a global one's dropout hash."""
    q, k, v, _, sl, kl, ql = inputs(B, N, M, H, Hkv, dtype, D=D)
    sd = torch.tensor([77], dtype=torch.int32)
    thresh, inv = fa.drop_params(rate) or (256, 1.0)
    hh, shift = fa.hash_origin(Hkv is None, N, M, H, *origin)
    o = torch.empty_like(q)
    ptrs = [x.data_ptr() for x in (q, k, v, sl, kl, ql, sd, o)]
    code = 0 if dtype == torch.float32 else 1
    if Hkv is None:
        lse = torch.empty(B, N * H)
        fn = libs[fa.kernel_library("mqa_fwd", D)].isp_mqa_fwd
        fn.argtypes = [P] * 9 + [I] * 7 + [F, I, F, I, U, I, P]
        err = fn(*ptrs, lse.data_ptr(), B, N, M, H, D, offset, int(causal), SCALE, thresh, inv,
                 hh, shift, code, None)
        ref, lref = fa.mqa_attention_reference(q, k, v, sl, kl, SCALE, offset, ql, causal, rate,
                                               sd, *origin)
    else:
        lse = torch.empty(B, H, N)
        fn = libs[fa.kernel_library("flash_fwd", D)].isp_flash_fwd
        fn.argtypes = [P] * 9 + [I] * 8 + [F, I, F, I, U, I, P]
        err = fn(*ptrs, lse.data_ptr(), B, N, M, H, Hkv, D, offset, int(causal), SCALE, thresh,
                 inv, hh, shift, code, None)
        ref, lref = fa.flash_attention_reference(q, k, v, sl, kl, SCALE, offset, ql, causal,
                                                 rate, sd, *origin)
    assert err == 0, err
    live = torch.isfinite(lref)
    assert torch.equal(torch.isfinite(lse), live), "dead rows differ"
    return [rel(o, ref), rel(lse[live], lref[live]) if live.any() else 0.0]


def backward(libs, B, N, M, H, Hkv, dtype, causal, offset, rate, splits=1,
             origin=(0, 0, None), D=64):
    q, k, v, do, sl, kl, ql = inputs(B, N, M, H, Hkv, dtype, D=D)
    sd = torch.tensor([77], dtype=torch.int32)
    thresh, inv = fa.drop_params(rate) or (256, 1.0)
    hh, shift = fa.hash_origin(Hkv is None, N, M, H, *origin)
    plain_fwd, plain_bwd = ((fa.mqa_attention_reference, fa.mqa_bwd_reference) if Hkv is None
                            else (fa.flash_attention_reference, fa.flash_bwd_reference))
    o, lse = plain_fwd(q, k, v, sl, kl, SCALE, offset, ql, causal, rate, sd, *origin)
    ref = plain_bwd(q, k, v, sl, kl, ql, sd, o, lse, do, SCALE, offset, causal, rate, *origin)
    nan = float("nan")
    dq, dk, dv = (torch.full_like(x, nan) for x in (q, k, v))
    # the (2, H) sums, then the dq pass's partials per batch and row block
    rows = N * H if Hkv is None else N
    dsl, delta = torch.zeros(2 * H * (1 + B * -(-rows // 64))), torch.full(lse.shape, nan)
    work = torch.full((splits, 2, *k.shape), nan) if splits > 1 else None
    ptrs = [x.data_ptr() for x in (q, k, v, sl, kl, ql, sd, o, lse, do, dq, dk, dv, dsl, delta)]
    ptrs.append(None if work is None else work.data_ptr())
    code = 0 if dtype == torch.float32 else 1
    if Hkv is None:
        fn = libs[fa.kernel_library("mqa_bwd", D)].isp_mqa_bwd
        fn.argtypes = [P] * 16 + [I] * 7 + [F, I, F, I, I, U, I, P]
        err = fn(*ptrs, B, N, M, H, D, offset, int(causal), SCALE, thresh, inv, splits, hh,
                 shift, code, None)
    else:
        fn = libs[fa.kernel_library("flash_bwd", D)].isp_flash_bwd
        fn.argtypes = [P] * 16 + [I] * 8 + [F, I, F, I, I, U, I, P]
        err = fn(*ptrs, B, N, M, H, Hkv, D, offset, int(causal), SCALE, thresh, inv, splits,
                 hh, shift, code, None)
    assert err == 0, err
    one_key = M == 1
    dv_scale, far = ref[2], N + abs(offset)
    return [rel(a, b, dv_scale * (far if i == 3 else 1) if one_key and i != 2 else None)
            for i, (a, b) in enumerate(zip((dq, dk, dv, dsl[:2 * H].view(2, H)), ref))]


CASES = [  # B, N, M, H, Hkv (None: folded MQA), dtype, causal, offset, rate, splits
    (2, 37, 45, 6, None, torch.float32, False, 0, 0.0, 1),
    (3, 20, 70, 4, None, torch.float32, True, -5, 0.1, 1),
    (2, 70, 40, 3, None, torch.bfloat16, False, 0, 0.1, 3),
    (3, 20, 70, 4, 4, torch.float32, True, -5, 0.1, 1),
    (3, 66, 33, 3, 1, torch.float32, False, 7, 0.1, 2),
    (2, 40, 130, 2, 2, torch.bfloat16, True, 70, 0.1, 1),
    (3, 65, 64, 2, 1, torch.bfloat16, False, 0, 0.0, 1),
    # far offsets: every valid key on one side of each row (the slope
    # gradients over distances from the row's nearest valid key)
    (3, 96, 24, 3, None, torch.float32, False, -72, 0.0, 1),
    (3, 40, 20, 2, 2, torch.bfloat16, False, 60, 0.1, 1),
]


#: a data rank's or model rank's share of a global call: (case, (batch0,
#: head0, heads_total)); the kernel's global hash against the plain version's
ORIGIN_CASES = [
    ((2, 20, 33, 2, None, torch.float32, False, 0, 0.1, 1), (3, 2, 6)),
    ((2, 70, 40, 3, None, torch.bfloat16, True, -5, 0.1, 2), (1, 3, 6)),
    ((2, 20, 33, 2, 2, torch.float32, False, 0, 0.1, 1), (1, 4, 6)),
    ((3, 66, 33, 2, 1, torch.bfloat16, False, 7, 0.1, 2), (6, 2, 4)),
]


#: other head dims (the last element): tile widths 16 (D 8), 32 and 128, and
#: D 96 below its tile's width; both families, f32 and bf16, causal at an
#: offset with dropout, splits 1 (forward and backward) and 2 (backward)
HEAD_DIM_CASES = [
    ((3, 20, 70, 4, None, torch.float32, True, -5, 0.1, 1), 8),
    ((2, 70, 40, 3, 3, torch.bfloat16, False, 0, 0.1, 2), 8),
    ((3, 37, 45, 3, 1, torch.bfloat16, True, 3, 0.1, 1), 32),
    ((2, 66, 33, 2, None, torch.float32, False, 0, 0.0, 2), 32),
    ((3, 20, 70, 2, None, torch.bfloat16, True, -5, 0.1, 1), 128),
    ((2, 40, 66, 2, 2, torch.float32, True, 26, 0.1, 1), 128),
    ((2, 70, 40, 2, 1, torch.float32, False, 0, 0.1, 2), 128),
    ((2, 65, 63, 2, None, torch.bfloat16, False, 0, 0.1, 2), 128),
    ((3, 37, 45, 2, 2, torch.bfloat16, True, 3, 0.1, 1), 96),
] + [
    # f32 at tile width 128 (attention_fwd_kernel_staged), D 128 and 96: key
    # counts 1, 31, 32, 33, 63 and 65 (around half a key tile and a whole
    # one) and row counts 1, 63, 64 and 65 (K1's rows folded: N x H),
    # causal and not, dropout 0.1, batch row 1's key length 0 (B 3), and
    # the cross-attention offset M - N at N 48, M 320
    ((3, 1, 1, 1, None, torch.float32, False, 0, 0.1, 1), 128),
    ((3, 63, 31, 1, None, torch.float32, True, 0, 0.1, 1), 128),
    ((3, 32, 32, 2, None, torch.float32, False, 0, 0.1, 1), 96),
    ((3, 65, 33, 1, None, torch.float32, True, -5, 0.1, 1), 96),
    ((2, 48, 320, 1, None, torch.float32, False, 272, 0.1, 1), 128),
    ((3, 64, 63, 2, 2, torch.float32, False, 0, 0.1, 1), 128),
    ((3, 65, 65, 2, 1, torch.float32, True, 0, 0.1, 1), 128),
    ((3, 1, 31, 2, 2, torch.float32, True, 30, 0.1, 1), 96),
    ((3, 63, 32, 3, 3, torch.float32, False, 0, 0.1, 1), 96),
    ((2, 48, 320, 1, 1, torch.float32, True, 272, 0.1, 1), 96),
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
                              libraries((64,) + tuple(D for _, D in HEAD_DIM_CASES)),
                              args.out or Path(tmp))
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
        for case, origin in ORIGIN_CASES:
            bound = 1e-4 if case[5] == torch.float32 else 2e-2
            errs = (forward(libs, *case[:-1], origin=origin) if case[-1] == 1 else []) + \
                backward(libs, *case, origin=origin)
            ok = all(e <= bound for e in errs)
            bad += [] if ok else [(case, origin, errs)]
            print(f"{'ok  ' if ok else 'FAIL'} {case} origin={origin}: "
                  + " ".join(f"{e:.1e}" for e in errs), flush=True)
        for case, D in HEAD_DIM_CASES:
            bound = 1e-4 if case[5] == torch.float32 else 2e-2
            errs = (forward(libs, *case[:-1], D=D) if case[-1] == 1 else []) + \
                backward(libs, *case, D=D)
            ok = all(e <= bound for e in errs)
            bad += [] if ok else [(case, D, errs)]
            print(f"{'ok  ' if ok else 'FAIL'} {case} D={D}: "
                  + " ".join(f"{e:.1e}" for e in errs), flush=True)
    print(f"{len(bad)} failing" if bad else "all within bounds")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
