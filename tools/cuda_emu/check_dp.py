#!/usr/bin/env python3
"""The aligner's DP kernels, K3 (MAS, ``csrc/mas.cu``) and K4 (banded CTC
forward and backward, ``csrc/ctc.cu``), run in the CPU emulation of this
directory and held against their plain versions, on a machine without a GPU
or nvcc (g++ only):

    python3 tools/cuda_emu/check_dp.py [--out DIR]

K3 must equal ``monotonic_alignment_search_reference`` and its durations sum
to mel_len; K4's loss must be within 1e-5 and its gradient within 1e-4 of the
float64 plain version (relative to its max-abs), the card's bounds. The
cases cross the designs' path boundaries: K3 with one and two column
blocks a lane (T = 1, 31, 33) and its row split over warps (T > 256), K4's
rows over one to nine warps (W = 2, 32, 33, 49, 65, 200, 257), K3's choice bits
in global memory, a map of one row, row counts off the staging ring and
the 16-frame occupancy sums, mel_len < M, text_len 1 (and 0 for K3) and a
row of NEG_INF. The emulation computes ``ex2``/``lg2.approx`` precisely and
says nothing of speed or races between warps: only the card does.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(HERE))

import emubuild  # noqa: E402
from isp_tts_tpu_torch.ops import ctc, mas  # noqa: E402

P, I = ctypes.c_void_p, ctypes.c_int
K4_LOSS_BOUND = 1e-5
K4_GRAD_BOUND = 1e-4

#: (B, M, T, special): T = 1, 31, 33 and a row split over two warps (T > 256);
#: M = 1 and M off the staging rings (32, 16 and 8 rows); M 12000 puts the
#: choice bits in the global scratch; "neg_row": a row of NEG_INF logits,
#: "tl0": a text_len of 0, "tl1": a text_len of 1
MAS_CASES = [(3, 37, 31, None), (3, 37, 33, "tl1"), (2, 1, 5, None), (3, 20, 1, None),
             (3, 45, 48, "neg_row"), (2, 19, 200, "tl0"), (2, 13, 300, None),
             (2, 12000, 33, None)]
#: (B, M, W, special), a warp per 32 states: W = 2, 32 (one warp), 33, 49 (two,
#: the training shape's), 65 (three), 200 (seven), 257 (nine: the staging
#: ring of 8 frames, not 16); one frame (M = 1); mel lengths off the 16-frame
#: occupancy sums
CTC_CASES = [(3, 21, 2, None), (3, 37, 32, None), (3, 40, 33, "tl1"), (4, 60, 49, None),
             (3, 70, 65, None), (2, 1, 2, None), (2, 1, 9, "tl1"), (2, 210, 200, None),
             (1, 260, 257, None)]


def mas_inputs(B, M, T, special=None, seed=0):
    """An aligner-like log-attention map (a diagonal trend), ragged lengths
    (row 0 full, the others mel_len < M where M > 1)."""
    rng = np.random.RandomState(seed)
    i, j = np.arange(M)[:, None] / M, np.arange(T)[None, :] / T
    logits = torch.from_numpy((rng.randn(B, M, T) - 8 * (i - j) ** 2).astype(np.float32))
    la = logits.log_softmax(-1).contiguous()
    tl = torch.from_numpy(rng.randint(max(T // 2, 1), T + 1, size=B).astype(np.int32))
    ml = torch.from_numpy(rng.randint(max(M // 2, 1), M + 1, size=B).astype(np.int32))
    tl[0], ml[0] = T, M
    if special == "neg_row":
        la[1, M // 3] = -1e9
    elif special == "tl0":
        tl[1] = 0
    elif special == "tl1":
        tl[1] = 1
    return la, tl, torch.maximum(ml, tl)


def run_mas(lib, la, tl, ml):
    B, M, T = la.shape
    lib.isp_mas_scratch_bytes.argtypes = [I, I]
    lib.isp_mas_scratch_bytes.restype = ctypes.c_longlong
    bits = torch.zeros(max(B * lib.isp_mas_scratch_bytes(M, T), 1), dtype=torch.uint8)
    out = torch.full_like(la, float("nan"))
    fn = lib.isp_mas
    fn.argtypes = [P] * 5 + [I] * 3 + [P]
    err = fn(la.data_ptr(), tl.data_ptr(), ml.data_ptr(), bits.data_ptr(), out.data_ptr(),
             B, M, T, None)
    if err:
        raise RuntimeError(f"isp_mas returned {err}")
    return out


def check_mas(libs, B, M, T, special=None):
    """(equal to the plain version, durations sum to mel_len)."""
    la, tl, ml = mas_inputs(B, M, T, special)
    got = run_mas(libs["mas"], la, tl, ml)
    ref = mas.monotonic_alignment_search_reference(la, tl, ml)
    # every row below min(mel_len, M) holds a one; with text_len 0 all but the last
    rows = ml.clamp(max=M) - (tl == 0).int()
    return torch.equal(got, ref), torch.equal(got.sum(dim=(1, 2)), rows.float())


def ctc_inputs(B, M, W, special=None, seed=1):
    """The attention loss's input: a blank column in front of aligner-like
    logits, log-softmaxed over W; ragged lengths, row 0 full, every sample
    feasible (text_len <= mel_len <= M)."""
    la, tl, ml = mas_inputs(B, M, W - 1, special, seed)
    lp = torch.nn.functional.pad(la, (1, 0), value=-1.0).log_softmax(-1).contiguous()
    tl = tl.clamp(max=M)
    return lp, tl, torch.maximum(ml.clamp(max=M), tl)


def run_ctc(lib, lp, tl, ml, g):
    """K4's (neg_logp, dlogprobs)."""
    B, M, W = lp.shape
    ab = torch.full((B, M, W), float("nan"), dtype=torch.float64)
    al = torch.full_like(ab, float("nan"))
    logz = torch.empty(B, dtype=torch.float64)
    neg = torch.empty(B)
    fwd = lib.isp_ctc_fwd
    fwd.argtypes = [P] * 7 + [I] * 3 + [P]
    err = fwd(lp.data_ptr(), tl.data_ptr(), ml.data_ptr(), ab.data_ptr(), al.data_ptr(),
              logz.data_ptr(), neg.data_ptr(), B, M, W, None)
    if err:
        raise RuntimeError(f"isp_ctc_fwd returned {err}")
    dlp = torch.full_like(lp, float("nan"))
    bwd = lib.isp_ctc_bwd
    bwd.argtypes = [P] * 8 + [I] * 3 + [P]
    err = bwd(lp.data_ptr(), ab.data_ptr(), al.data_ptr(), logz.data_ptr(), g.data_ptr(),
              tl.data_ptr(), ml.data_ptr(), dlp.data_ptr(), B, M, W, None)
    if err:
        raise RuntimeError(f"isp_ctc_bwd returned {err}")
    return neg, dlp


def check_ctc(libs, B, M, W, special=None):
    """(loss error, gradient error), each relative to the plain version's
    max-abs."""
    lp, tl, ml = ctc_inputs(B, M, W, special)
    g = torch.from_numpy(np.random.RandomState(2).rand(B).astype(np.float32))
    neg, dlp = run_ctc(libs["ctc"], lp, tl, ml, g)
    x = lp.double().requires_grad_()
    ref = ctc.ordered_ctc_neg_logp_reference(x, tl, ml)
    (dref,) = torch.autograd.grad((ref * g.double()).sum(), x)
    ref = ref.detach().float()

    def rel(a, b):
        return ((a.double() - b.double()).abs().max() / b.double().abs().max()).item()

    return rel(neg, ref), rel(dlp, dref)


def build(out: Path):
    return emubuild.build(ROOT / "isp_tts_tpu_torch/csrc", ["mas", "ctc"], out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(args.out or Path(tmp))
        ok = True
        for case in MAS_CASES:
            equal, sums = check_mas(libs, *case)
            ok &= equal and sums
            print(f"K3 B, M, T, special = {case}: equal {equal}, durations sum to mel_len {sums}",
                  flush=True)
        for case in CTC_CASES:
            loss, grad = check_ctc(libs, *case)
            ok &= loss <= K4_LOSS_BOUND and grad <= K4_GRAD_BOUND
            print(f"K4 B, M, W, special = {case}: loss {loss:.2e} (bound {K4_LOSS_BOUND:.0e}), "
                  f"gradient {grad:.2e} (bound {K4_GRAD_BOUND:.0e})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
