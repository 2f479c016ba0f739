"""The port's CUDA kernels built with g++ for the CPU emulation of
``tools/cuda_emu`` and held against their plain versions, on the CPU, at
the bounds the card is held to:
- the attention kernels (K1, K5a forwards; K2, K5b backwards): fragment
  layouts, tile indexing, masks, dropout hashes and row splits. The
  emulation sums each MMA in double and rounds once (f32 1e-4, bf16 2e-2 of
  the plain version's max-abs);
- the aligner's DP kernels, K3 (MAS, equal to its plain version) and K4
  (banded CTC forward and backward, loss 1e-5 and gradient 1e-4 of the f64
  plain version): the lane layout, the staging ring, the row split over
  warps and the backtrack's windows, at every path boundary
  (``check_dp.MAS_CASES``, ``check_dp.CTC_CASES``).
The emulation says nothing of speed, registers or races between warps.
"""

import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools" / "cuda_emu"))

import check_attention as emu  # noqa: E402
import check_dp  # noqa: E402


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    return emu.emubuild.build(ROOT / "isp_tts_tpu_torch/csrc",
                              ["mqa_fwd", "flash_fwd", "mqa_bwd", "flash_bwd", "mas", "ctc"],
                              tmp_path_factory.mktemp("cuda_emu"))


def _bound(dtype):
    return 1e-4 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("case", [c for c in emu.CASES if c[-1] == 1],
                         ids=lambda c: "-".join(map(str, c)).replace("torch.", ""))
def test_forward_kernel_matches_plain_version(libs, case):
    errs = emu.forward(libs, *case[:-1])
    assert max(errs) <= _bound(case[5]), errs


@pytest.mark.parametrize("case", emu.CASES + [
    (3, 1, 1, 3, 3, torch.float32, False, 0, 0.1, 1),   # one row, one key
    (3, 70, 1, 3, None, torch.float32, True, -5, 0.1, 2),
    (3, 65, 63, 3, 1, torch.bfloat16, True, -5, 0.1, 2),
], ids=lambda c: "-".join(map(str, c)).replace("torch.", ""))
def test_backward_kernel_matches_plain_version(libs, case):
    errs = emu.backward(libs, *case)
    assert max(errs) <= _bound(case[5]), errs


@pytest.mark.parametrize("case", check_dp.MAS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_k3_equals_plain_mas(libs, case):
    equal, sums = check_dp.check_mas(libs, *case)
    assert equal and sums


@pytest.mark.parametrize("case", check_dp.CTC_CASES, ids=lambda c: "-".join(map(str, c)))
def test_k4_matches_plain_version(libs, case):
    loss, grad = check_dp.check_ctc(libs, *case)
    assert loss <= check_dp.K4_LOSS_BOUND and grad <= check_dp.K4_GRAD_BOUND, (loss, grad)
