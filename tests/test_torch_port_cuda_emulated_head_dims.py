"""The attention kernels (K1, K5a forwards; K2, K5b backwards) at head dims
other than 64, built with g++ for the CPU emulation of ``tools/cuda_emu``
at the tile widths they launch (16 for D 8; 32; 128 for D 96 and 128) and
held against their plain versions on the CPU at the bounds the card is held
to (f32 1e-4, bf16 2e-2 of the plain version's max-abs):
``check_attention.HEAD_DIM_CASES``, both families, f32 and bf16, causal at
an offset with dropout, the backward with one row split and with two, and
the f32 forward at tile width 128 (Q staged, K and V split once a tile,
interleaved output columns) at D 128 and 96 over key counts 1-65, row
counts 1-65, a key length of 0 and the offset M - N at N 48, M 320. The
emulation checks the tile width's fragment layouts, k-steps and output
slices, the zero columns past D, the staged A operands at width 128 and
the row strides of D; it says nothing of speed, registers or races between
warps.
"""

import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools" / "cuda_emu"))

import check_attention as emu  # noqa: E402

CASES = emu.HEAD_DIM_CASES


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulated kernels")
    return emu.emubuild.build(ROOT / "isp_tts_tpu_torch/csrc",
                              emu.libraries(tuple(D for _, D in CASES)),
                              tmp_path_factory.mktemp("cuda_emu_dims"))


def _bound(dtype):
    return 1e-4 if dtype == torch.float32 else 2e-2


def _id(x):
    return "-".join(map(str, x)).replace("torch.", "") if isinstance(x, tuple) else f"D{x}"


@pytest.mark.parametrize("case,D", [c for c in CASES if c[0][-1] == 1], ids=_id)
def test_forward_kernel_matches_plain_version_at_head_dim(libs, case, D):
    errs = emu.forward(libs, *case[:-1], D=D)
    assert max(errs) <= _bound(case[5]), errs


@pytest.mark.parametrize("case,D", CASES, ids=_id)
def test_backward_kernel_matches_plain_version_at_head_dim(libs, case, D):
    errs = emu.backward(libs, *case, D=D)
    assert max(errs) <= _bound(case[5]), errs
