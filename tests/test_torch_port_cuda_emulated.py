"""The CUDA attention kernels (K1, K5a forwards; K2, K5b backwards) built
with g++ for the CPU emulation of ``tools/cuda_emu`` and held against their
plain versions, on the CPU: their fragment layouts, tile indexing, masks,
dropout hashes and row splits, which otherwise run only on the card. The
emulation sums each MMA in double and rounds once, so the bounds are the
card's (f32 1e-4, bf16 2e-2 of the plain version's max-abs); it says
nothing of speed, registers or races between warps.
"""

import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools" / "cuda_emu"))

import check_attention as emu  # noqa: E402


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    return emu.emubuild.build(ROOT / "isp_tts_tpu_torch/csrc",
                              ["mqa_fwd", "flash_fwd", "mqa_bwd", "flash_bwd"],
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
