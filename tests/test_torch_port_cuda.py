"""Kernel K1 on the card against its plain version, and the Synthesizer's
kernel path against its plain-attention path. These need an NVIDIA card and
nvcc, and skip without them; on the card run

    python -m pytest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from isp_tts_tpu_torch.nn.embeddings import alibi_slopes
from isp_tts_tpu_torch.ops.flash_attention import mqa_attention_reference, mqa_fwd

pytestmark = pytest.mark.cuda
CKPT = "docs/assets/scale_r5/acoustic_scratch10k_r5.f16.ckpt"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 has no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,N,M,H,offset,symmetric,causal,dtype,bound", [
    (2, 256, 256, 6, 0, True, False, torch.float32, 1e-4),
    (2, 96, 224, 4, 128, False, False, torch.float32, 1e-4),
    (2, 300, 300, 6, 0, False, True, torch.float32, 1e-4),
    (2, 512, 512, 6, 0, True, False, torch.bfloat16, 2e-2),
])
def test_k1_matches_plain_version(card, B, N, M, H, offset, symmetric, causal, dtype,
                                  bound):
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(B, N, H, 64).astype(np.float32)).to(card, dtype)
    k = torch.from_numpy(rng.randn(B, M, 64).astype(np.float32)).to(card, dtype)
    v = torch.from_numpy(rng.randn(B, M, 64).astype(np.float32)).to(card, dtype)
    sl = np.asarray(alibi_slopes(H), np.float32)
    slopes = torch.from_numpy(np.stack([sl, sl if symmetric else sl * 0.5])).to(card)
    key_lens = torch.tensor([M, M // 2 + 3], dtype=torch.int32, device=card)
    q_lens = torch.tensor([N - 5, N // 2], dtype=torch.int32, device=card)
    before = mqa_fwd.launches
    o, lse = mqa_fwd(q, k, v, slopes, key_lens, 0.125, offset, q_lens, causal)
    torch.cuda.synchronize()
    assert mqa_fwd.launches == before + 1
    o_ref, lse_ref = mqa_attention_reference(q, k, v, slopes, key_lens, 0.125, offset,
                                             q_lens, causal)
    assert (o.float() - o_ref.float()).abs().max().item() <= bound
    live = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), live)
    assert (lse[live] - lse_ref[live]).abs().max().item() <= 1e-4 * (
        1 + lse_ref[live].abs().max().item())


def test_k1_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 4, 2, 32), device=card)
    k = torch.zeros((1, 4, 32), device=card)
    lens = torch.full((1,), 4, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        mqa_fwd(q, k, k, torch.zeros((2, 2), device=card), lens, 0.1, q_lens=lens)


def test_synthesizer_kernel_path_matches_plain_path(card):
    from isp_tts_tpu_torch.nn.attention import Attention
    from isp_tts_tpu_torch.serving import Synthesizer

    synth = Synthesizer.from_pretrained(CKPT)
    tokens, lens, fb, _ = synth.prepare(["Hello there.", "A somewhat longer sentence."])
    tok = torch.from_numpy(tokens).long().to(card)
    ln = torch.from_numpy(lens).to(card)
    noise = torch.randn((tok.shape[0], tok.shape[1], 3), device=card,
                        generator=torch.Generator(device=card).manual_seed(0))
    mel_k, ad_k = synth.model.infer(tok, ln, max_dec_len=fb, noise=noise)
    for m in synth.model.modules():
        if isinstance(m, Attention):
            m.flash = "off"
    mel_p, ad_p = synth.model.infer(tok, ln, max_dec_len=fb, noise=noise,
                                    duration_target=ad_k.duration)
    assert torch.equal(ad_k.dec_lengths, ad_p.dec_lengths)
    assert (mel_k - mel_p).abs().max().item() <= 1e-3
