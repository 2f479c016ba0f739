"""Kernels K1-K5b on the card against their plain versions, the
Synthesizer's kernel path against its plain-attention path, and one
training step's kernel path against its plain path. These need an NVIDIA
card and nvcc, and skip without them; on the card run

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
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# The tile edges of the tensor-core forward kernels (64-row blocks, 16-row
# warps, 64-key tiles, 8- and 16-wide fragments): lengths that are not
# multiples of 8, 16 or 64, 6 and 4 heads (K1's folded rows straddle queries
# inside a fragment), causal with offsets 128 and -5, M 3072, dropout 0.1;
# with B > 2 a batch row of key length 0 and one of query length 0.
EDGE_CASES = [  # B, N, M, H, offset, causal, rate
    (4, 37, 45, 6, 0, False, 0.0), (4, 37, 45, 4, 0, True, 0.1),
    (8, 48, 48, 6, 0, False, 0.1), (8, 48, 48, 4, 0, False, 0.0),
    (4, 1024, 1024, 6, 0, False, 0.1), (4, 96, 224, 6, 128, True, 0.1),
    (4, 300, 300, 4, -5, True, 0.1), (3, 3072, 3072, 6, 0, False, 0.1),
]


@pytest.mark.parametrize("B,N,M,H,offset,symmetric,causal,rate,dtype,bound", [
    (2, 256, 256, 6, 0, True, False, 0.0, torch.float32, 1e-4),
    (2, 96, 224, 4, 128, False, False, 0.0, torch.float32, 1e-4),
    (2, 300, 300, 6, 0, False, True, 0.0, torch.float32, 1e-4),
    (2, 512, 512, 6, 0, True, False, 0.0, torch.bfloat16, 2e-2),
] + [(B, N, M, H, offset, False, causal, rate, dtype, bound)
     for B, N, M, H, offset, causal, rate in EDGE_CASES
     for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))])
def test_k1_matches_plain_version(card, B, N, M, H, offset, symmetric, causal, rate, dtype,
                                  bound):
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(B, N, H, 64).astype(np.float32)).to(card, dtype)
    k = torch.from_numpy(rng.randn(B, M, 64).astype(np.float32)).to(card, dtype)
    v = torch.from_numpy(rng.randn(B, M, 64).astype(np.float32)).to(card, dtype)
    sl = np.asarray(alibi_slopes(H), np.float32)
    slopes = torch.from_numpy(np.stack([sl, sl if symmetric else sl * 0.5])).to(card)
    key_lens = torch.tensor(([M, M // 2 + 3, 0, M - 7] + [M // 2 + 3] * B)[:B],
                            dtype=torch.int32, device=card)
    q_lens = torch.tensor(([N - 5, N // 2, N - 1, 0] + [N // 2] * B)[:B], dtype=torch.int32,
                          device=card)
    seed = torch.tensor([23], dtype=torch.int32, device=card)
    before = mqa_fwd.launches
    o, lse = mqa_fwd(q, k, v, slopes, key_lens, 0.125, offset, q_lens, causal, rate, seed)
    torch.cuda.synchronize()
    assert mqa_fwd.launches == before + 1
    o_ref, lse_ref = mqa_attention_reference(q, k, v, slopes, key_lens, 0.125, offset,
                                             q_lens, causal, rate, seed)
    assert (o.float() - o_ref.float()).abs().max().item() <= bound
    live = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), live)
    assert (lse[live] - lse_ref[live]).abs().max().item() <= 1e-4 * (
        1 + lse_ref[live].abs().max().item())


def test_k1_refuses_what_it_does_not_take(card):
    """A head dim past 128 and a k whose head dim is not q's."""
    lens = torch.full((1,), 4, dtype=torch.int32, device=card)
    slopes = torch.zeros((2, 2), device=card)
    q = torch.zeros((1, 4, 2, 256), device=card)
    with pytest.raises(ValueError, match="head dims up to 128"):
        mqa_fwd(q, q[:, :, 0], q[:, :, 0], slopes, lens, 0.1, q_lens=lens)
    q, k = torch.zeros((1, 4, 2, 32), device=card), torch.zeros((1, 4, 16), device=card)
    with pytest.raises(ValueError):
        mqa_fwd(q, k, k, slopes, lens, 0.1, q_lens=lens)


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


def _mqa(card, B, N, M, H, dtype, seed=0):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, N, H, 64).astype(np.float32)).to(card, dtype)
    k = torch.from_numpy(rng.randn(B, M, 64).astype(np.float32)).to(card, dtype)
    v = torch.from_numpy(rng.randn(B, M, 64).astype(np.float32)).to(card, dtype)
    sl = np.asarray(alibi_slopes(H), np.float32)
    slopes = torch.from_numpy(np.stack([sl, sl * 0.5])).to(card)
    key_lens = torch.tensor([M] + [M // 2 + 3] * (B - 1), dtype=torch.int32, device=card)
    q_lens = torch.tensor([N] + [N // 2 + 1] * (B - 1), dtype=torch.int32, device=card)
    return q, k, v, slopes, key_lens, q_lens


GRAD_NAMES = ("dq", "dk", "dv", "dslopes")


def _do(card, q, seed):
    """dL/do of q's shape and dtype from a generator of its own, so that a
    test's draw does not depend on what ran before it."""
    gen = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(q.shape, generator=gen, device=card).to(q.dtype)


def _assert_within(got, ref, bound, skip=(), max_dist=1):
    """Each gradient within ``bound`` of its reference's max-abs. With one
    key (M = 1) p = 1 and ds = dp - delta = 0 in exact arithmetic, so dq, dk
    and dslopes are rounding noise on both sides: they are held to the
    bound on the scale of dv, the gradient that does not vanish, and
    dslopes = sum ds * dist on that scale times the largest distance
    ``max_dist``."""
    one_key = ref[1].shape[1] == 1
    for name, a, b in zip(GRAD_NAMES, got, ref):
        if name in skip:
            continue
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        if one_key and name != "dv":
            scale = ref[2].float().abs().max().item() * (max_dist if name == "dslopes" else 1)
        assert err <= bound * scale, (name, err)


def _kernel_vs_plain_bwd(fwd, bwd, plain, q, k, v, slopes, key_lens, q_lens, seed, w, offset,
                         causal, rate, bound):
    """The kernel backward against its plain version, both fed the kernel
    forward's saved o and lse: one launch, every gradient within bound."""
    o, lse = fwd(q, k, v, slopes, key_lens, 0.125, offset, q_lens, causal, rate, seed)
    args = (q, k, v, slopes, key_lens, q_lens, seed, o, lse, w, 0.125, offset, causal, rate)
    before = bwd.launches
    got = bwd(*args)
    torch.cuda.synchronize()
    assert bwd.launches == before + 1
    _assert_within(got, plain(*args), bound, max_dist=q.shape[1] + abs(offset))


# bf16: dq, dk and dv are held to autograd through the plain forward, and
# every gradient to the plain backward fed the kernel forward's saved o and
# lse. dslopes is held to the plain backward alone: it is a sum with
# cancellation of ds * dist, and ds takes delta = rowsum(dO * O) on the o
# the forward saved in bf16, as the TPU kernels' residual is (the plain
# backward from the bf16 o reads 5e-3 to 4e-2 against autograd through the
# plain forward, from the f32 o under 4e-6; tests/test_torch_port_attention_bwd_bf16.py)
BF16_AUTOGRAD_SKIP = {torch.float32: (), torch.bfloat16: ("dslopes",)}


@pytest.mark.parametrize("B,N,M,H,offset,causal,rate,dtype,bound", [
    (4, 320, 320, 6, 0, False, 0.1, torch.float32, 1e-4),
    (4, 320, 320, 4, 0, False, 0.0, torch.float32, 1e-4),
    (2, 300, 300, 4, 0, True, 0.1, torch.float32, 1e-4),
    (2, 96, 224, 6, 128, False, 0.1, torch.float32, 1e-4),
    (2, 2304, 2304, 6, 0, False, 0.1, torch.float32, 1e-4),
    (4, 320, 320, 6, 0, False, 0.1, torch.bfloat16, 2e-2),
])
def test_k2_matches_autograd_through_plain_k1(card, B, N, M, H, offset, causal, rate, dtype,
                                              bound):
    from isp_tts_tpu_torch.ops.flash_attention import (mqa_attention, mqa_bwd,
                                                       mqa_bwd_reference)

    q, k, v, slopes, key_lens, q_lens = _mqa(card, B, N, M, H, dtype)
    seed = torch.tensor([31], dtype=torch.int32, device=card)
    w = _do(card, q, 1)

    def grads(fn):
        args = [x.clone().requires_grad_() for x in (q, k, v, slopes)]
        torch.autograd.backward(fn(*args), w)
        return [a.grad.float() for a in args]

    before = mqa_bwd.launches
    got = grads(lambda *a: mqa_attention(*a, key_lens, 0.125, offset, q_lens, causal, rate,
                                         seed))
    torch.cuda.synchronize()
    assert mqa_bwd.launches == before + 1
    ref = grads(lambda *a: mqa_attention_reference(*a, key_lens, 0.125, offset, q_lens, causal,
                                                   rate, seed)[0])
    _assert_within(got, ref, bound, BF16_AUTOGRAD_SKIP[dtype])
    _kernel_vs_plain_bwd(mqa_fwd, mqa_bwd, mqa_bwd_reference, q, k, v, slopes, key_lens,
                         q_lens, seed, w, offset, causal, rate, bound)


# The backward kernels' tile edges (64-row and 64-key blocks, 16-row warps,
# 64-row tiles): EDGE_CASES and row and key counts of 1, 63, 64 and 65.
BWD_EDGE_CASES = EDGE_CASES + [  # B, N, M, H, offset, causal, rate
    (4, 1, 1, 6, 0, False, 0.1), (4, 63, 65, 6, 0, False, 0.1), (4, 64, 64, 4, -5, True, 0.1),
    (4, 65, 63, 6, 0, False, 0.0), (4, 1, 65, 4, 0, False, 0.1), (4, 65, 1, 6, 0, True, 0.1),
]


@pytest.mark.parametrize("B,N,M,H,offset,causal,rate,dtype,bound",
                         [c + db for c in BWD_EDGE_CASES
                          for db in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))])
def test_k2_matches_plain_version_at_tile_edges(card, B, N, M, H, offset, causal, rate, dtype,
                                                bound):
    from isp_tts_tpu_torch.ops.flash_attention import mqa_bwd, mqa_bwd_reference

    q, k, v, slopes, key_lens, q_lens = _flash(card, B, N, M, H, 1, dtype, seed=2)
    w = _do(card, q, 2)
    seed = torch.tensor([37], dtype=torch.int32, device=card)
    _kernel_vs_plain_bwd(mqa_fwd, mqa_bwd, mqa_bwd_reference, q, k[:, :, 0].contiguous(),
                         v[:, :, 0].contiguous(), slopes, key_lens, q_lens, seed, w, offset,
                         causal, rate, bound)


# the training shape and M 1024, T 192; T = 1, 32, 33 (one and two column
# blocks a lane), 256 and 257 (one warp, two), 6144 (24 warps, the widest the
# wrapper takes; choice bits in global memory); M 12000 (the bits past shared
# memory at a narrow T)
@pytest.mark.parametrize("B,M,T", [(32, 320, 48), (8, 1024, 192), (4, 64, 1), (4, 64, 32),
                                   (4, 64, 33), (4, 300, 256), (4, 300, 257),
                                   (2, 1024, 6144), (2, 12000, 33)])
def test_k3_equals_plain_mas(card, B, M, T):
    from isp_tts_tpu_torch.ops.mas import (monotonic_alignment_search,
                                           monotonic_alignment_search_reference)

    rng = np.random.RandomState(1)
    i, j = np.arange(M)[:, None] / M, np.arange(T)[None, :] / T
    la = torch.from_numpy((rng.randn(B, M, T) - 8 * (i - j) ** 2).astype(np.float32))
    la = la.log_softmax(-1).to(card)
    tl = torch.from_numpy(rng.randint(max(T // 2, 1), T + 1, size=B).astype(np.int32)).to(card)
    ml = torch.from_numpy(rng.randint(min(T, M), M + 1, size=B).astype(np.int32)).to(card)
    got = monotonic_alignment_search(la, tl, ml)
    torch.cuda.synchronize()
    assert torch.equal(got, monotonic_alignment_search_reference(la, tl, ml))
    assert torch.equal(got.sum(dim=(1, 2)), ml.float())


# the training shape and M 1024, T 192; W = T + 1 = 2, 33 (one warp, two),
# 256 and 257 (8 and 9 warps: the staging ring of 16 frames and of 8), 1024
# (32 warps, the ring of 4; the widest the wrapper takes)
@pytest.mark.parametrize("B,M,T", [(32, 320, 48), (8, 1024, 192), (4, 64, 1), (4, 64, 32),
                                   (4, 300, 255), (4, 300, 256), (2, 1024, 1023)])
def test_k4_matches_plain_version(card, B, M, T):
    from isp_tts_tpu_torch.ops import ctc

    rng = np.random.RandomState(2)
    lp = torch.from_numpy(rng.randn(B, M, T + 1).astype(np.float32)).log_softmax(-1).to(card)
    tl = torch.from_numpy(rng.randint(1, T + 1, size=B).astype(np.int32)).to(card)
    ml = torch.from_numpy(rng.randint(T, M + 1, size=B).astype(np.int32)).to(card)
    g = torch.from_numpy(rng.rand(B).astype(np.float32)).to(card)
    neg, ab, al, logz = ctc.ctc_fwd(lp, tl, ml)
    dlp = ctc.ctc_bwd(lp, ab, al, logz, g, tl, ml)
    torch.cuda.synchronize()
    x = lp.double().requires_grad_()
    neg_r = ctc.ordered_ctc_neg_logp_reference(x, tl, ml)
    (dlp_r,) = torch.autograd.grad((neg_r * g.double()).sum(), x)
    neg_r = neg_r.detach().float()
    assert (neg - neg_r).abs().max() <= 1e-5 * neg_r.abs().max()
    assert (dlp - dlp_r).abs().max() <= 1e-4 * dlp_r.abs().max()


def test_training_step_kernel_path_matches_plain_path(card):
    """One f32 training step of a small model with dropout: the kernel path
    (K1-K4) against the plain path (einsum attention, plain MAS and CTC),
    same weights, generators and noise."""
    import copy

    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.models.acoustic.loss import AcousticLossConfig, AcousticModelLoss
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
    from isp_tts_tpu_torch.nn.attention import Attention
    from isp_tts_tpu_torch.training.trainer import Trainer
    from isp_tts_tpu_torch.training.trainer_config import TrainerConfig

    layer = {"attention": {"heads": 4, "head_dim": 64, "one_kv_head": True,
                           "alibi_pos_bias": True, "dropout": 0.1},
             "feed_forward": {"inner_dim": 256, "activation": "gelu", "dropout": 0.1}}
    stack = {"dim": 128, "depth": 2, "transformer_layer": layer}
    cfg = {"encoding_map": {c: i for i, c in enumerate(["<pad>", "</s>", *"abcdefgh "])},
           "mel_dim": 16, "text_dim": 128, "encoder": stack, "decoder": stack,
           "temporal_adaptor": {"predictor": {"transformer": stack, "time_embedding_dim": 16},
                                "embedding": {"transformer": stack}, "soft_duration": True},
           "aligner": {"attention_dim": 16, "key_kernel_size": 5, "query_kernel_size": 5}}
    torch.manual_seed(0)
    model = AcousticModel(build_config(AcousticModelConfig, cfg))
    plain = copy.deepcopy(model)
    for m in plain.modules():
        if isinstance(m, Attention):
            m.flash = "off"
    plain.aligner.config.mas_impl = "scan"
    rng = np.random.RandomState(3)
    B, T, M = 4, 24, 96
    batch = {"text_vector": torch.from_numpy(rng.randint(2, 11, size=(B, T))),
             "text_vector_len": torch.tensor([24, 20, 13, 9]),
             "mel": torch.from_numpy(rng.randn(B, M, 16).astype(np.float32)),
             "mel_len": torch.tensor([96, 80, 60, 40]),
             "pitch": torch.from_numpy(rng.randn(B, M).astype(np.float32)),
             "energy": torch.from_numpy(rng.randn(B, M).astype(np.float32))}
    out = []
    for mod, ctc_impl in ((model, "auto"), (plain, "scan")):
        loss_cfg = build_config(AcousticLossConfig, {"attention_loss": {"ctc_impl": ctc_impl}})
        trainer = Trainer(mod, AcousticModelLoss(loss_cfg), TrainerConfig(precision="fp32"),
                          generator=torch.Generator(device=card).manual_seed(4))
        out.append(trainer.compute_gradients(batch))
    (_, lk, nk), (_, lp, np_) = out
    for key in lp:
        assert abs(lk[key].item() - lp[key].item()) <= 1e-3 * abs(lp[key].item()), key
    assert abs(nk.item() - np_.item()) <= 2e-2 * np_.item()
    for (name, a), b in zip(model.named_parameters(), plain.parameters()):
        assert (a.grad - b.grad).abs().max() <= 2e-2 * b.grad.abs().max(), name


def _flash(card, B, N, M, H, Hkv, dtype, seed=0):
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(B, N, H, 64).astype(np.float32)).to(card, dtype)
    k = torch.from_numpy(rng.randn(B, M, Hkv, 64).astype(np.float32)).to(card, dtype)
    v = torch.from_numpy(rng.randn(B, M, Hkv, 64).astype(np.float32)).to(card, dtype)
    sl = np.asarray(alibi_slopes(H), np.float32)
    slopes = torch.from_numpy(np.stack([sl, sl * 0.5])).to(card)
    key_lens = torch.tensor([M, 0] + [M // 2 + 3] * (B - 2), dtype=torch.int32, device=card)
    q_lens = torch.tensor([N, N // 2 + 1, 0, N - 3][:B] + [N // 2 + 1] * (B - 4),
                          dtype=torch.int32, device=card)
    return q, k, v, slopes, key_lens, q_lens


K5_CASES = [  # B, N, M, H, Hkv, offset, causal, rate, dtype, bound
    (4, 320, 320, 6, 6, 0, False, 0.1, torch.float32, 1e-4),
    (4, 320, 320, 4, 4, 0, False, 0.0, torch.float32, 1e-4),
    (4, 320, 320, 6, 1, 0, False, 0.1, torch.float32, 1e-4),
    (3, 96, 224, 6, 6, 128, True, 0.1, torch.float32, 1e-4),
    (4, 320, 320, 6, 6, 0, False, 0.1, torch.bfloat16, 2e-2),
    (4, 1024, 1024, 6, 1, 0, False, 0.1, torch.bfloat16, 2e-2),
    (4, 300, 300, 4, 1, -5, True, 0.1, torch.bfloat16, 2e-2),
]
# K5a alone at the tile edges, with H and with 1 key/value head
K5A_EDGE_CASES = [(B, N, M, H, Hkv, offset, causal, rate, dtype, bound)
                  for B, N, M, H, offset, causal, rate in EDGE_CASES for Hkv in (H, 1)
                  for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))]


@pytest.mark.parametrize("B,N,M,H,Hkv,offset,causal,rate,dtype,bound",
                         K5_CASES + K5A_EDGE_CASES)
def test_k5a_matches_plain_version(card, B, N, M, H, Hkv, offset, causal, rate, dtype,
                                   bound):
    from isp_tts_tpu_torch.ops.flash_attention import flash_attention_reference, flash_fwd

    q, k, v, slopes, key_lens, q_lens = _flash(card, B, N, M, H, Hkv, dtype)
    seed = torch.tensor([17], dtype=torch.int32, device=card)
    before = flash_fwd.launches
    o, lse = flash_fwd(q, k, v, slopes, key_lens, 0.125, offset, q_lens, causal, rate, seed)
    torch.cuda.synchronize()
    assert flash_fwd.launches == before + 1
    o_ref, lse_ref = flash_attention_reference(q, k, v, slopes, key_lens, 0.125, offset,
                                               q_lens, causal, rate, seed)
    assert (o.float() - o_ref.float()).abs().max().item() <= bound
    live = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), live)
    assert (lse[live] - lse_ref[live]).abs().max().item() <= 1e-4 * (
        1 + lse_ref[live].abs().max().item())


@pytest.mark.parametrize("B,N,M,H,Hkv,offset,causal,rate,dtype,bound", K5_CASES)
def test_k5b_matches_autograd_through_plain_k5a(card, B, N, M, H, Hkv, offset, causal,
                                                rate, dtype, bound):
    from isp_tts_tpu_torch.ops.flash_attention import (flash_attention,
                                                       flash_attention_reference, flash_bwd,
                                                       flash_bwd_reference, flash_fwd)

    q, k, v, slopes, key_lens, q_lens = _flash(card, B, N, M, H, Hkv, dtype, seed=1)
    seed = torch.tensor([29], dtype=torch.int32, device=card)
    w = _do(card, q, 3)

    def grads(fn):
        args = [x.clone().requires_grad_() for x in (q, k, v, slopes)]
        torch.autograd.backward(fn(*args), w)
        return [a.grad.float() for a in args]

    before = flash_bwd.launches
    got = grads(lambda *a: flash_attention(*a, key_lens, 0.125, offset, q_lens, causal,
                                           rate, seed))
    torch.cuda.synchronize()
    assert flash_bwd.launches == before + 1
    ref = grads(lambda *a: flash_attention_reference(*a, key_lens, 0.125, offset, q_lens,
                                                     causal, rate, seed)[0])
    _assert_within(got, ref, bound, BF16_AUTOGRAD_SKIP[dtype])
    _kernel_vs_plain_bwd(flash_fwd, flash_bwd, flash_bwd_reference, q, k, v, slopes, key_lens,
                         q_lens, seed, w, offset, causal, rate, bound)


@pytest.mark.parametrize("B,N,M,H,Hkv,offset,causal,rate,dtype,bound",
                         [(B, N, M, H, hkv, offset, causal, rate) + db
                          for B, N, M, H, offset, causal, rate in BWD_EDGE_CASES
                          for hkv in (H, 1)
                          for db in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))])
def test_k5b_matches_plain_version_at_tile_edges(card, B, N, M, H, Hkv, offset, causal, rate,
                                                 dtype, bound):
    from isp_tts_tpu_torch.ops.flash_attention import flash_bwd, flash_bwd_reference, flash_fwd

    q, k, v, slopes, key_lens, q_lens = _flash(card, B, N, M, H, Hkv, dtype, seed=2)
    w = _do(card, q, 4)
    seed = torch.tensor([41], dtype=torch.int32, device=card)
    _kernel_vs_plain_bwd(flash_fwd, flash_bwd, flash_bwd_reference, q, k, v, slopes, key_lens,
                         q_lens, seed, w, offset, causal, rate, bound)


# Head dims other than 64: 8 (tile width 16), 12 (zero-padded to 16 by the
# wrappers), 32, 96 (tile width 128 below its width) and 128, each family,
# causal at an offset with dropout, ragged lengths with a key length of 0
# and a query length of 0; the forward and the backward (on the kernel
# forward's o and lse) against their plain versions, one launch each.
HEAD_DIM_CASES = [(D, hkv, dtype, bound) for D in (8, 12, 32, 96, 128)
                  for hkv in (None, 4, 1)
                  for dtype, bound in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2))]


@pytest.mark.parametrize("D,Hkv,dtype,bound", HEAD_DIM_CASES)
def test_kernels_match_plain_versions_at_head_dim(card, D, Hkv, dtype, bound):
    from isp_tts_tpu_torch.ops import flash_attention as fa

    B, N, M, H, offset = 4, 130, 97, 4, -3
    rng = np.random.RandomState(D)
    kv = (B, M, D) if Hkv is None else (B, M, Hkv, D)
    q = torch.from_numpy(rng.randn(B, N, H, D).astype(np.float32)).to(card, dtype)
    k = torch.from_numpy(rng.randn(*kv).astype(np.float32)).to(card, dtype)
    v = torch.from_numpy(rng.randn(*kv).astype(np.float32)).to(card, dtype)
    sl = np.asarray(alibi_slopes(H), np.float32)
    slopes = torch.from_numpy(np.stack([sl, sl * 0.5])).to(card)
    key_lens = torch.tensor([M, 0, M // 2 + 3, M - 9], dtype=torch.int32, device=card)
    q_lens = torch.tensor([N, N // 2, 0, N - 3], dtype=torch.int32, device=card)
    seed = torch.tensor([43], dtype=torch.int32, device=card)
    fwd, bwd, pfwd, pbwd = ((fa.mqa_fwd, fa.mqa_bwd, fa.mqa_attention_reference,
                             fa.mqa_bwd_reference) if Hkv is None else
                            (fa.flash_fwd, fa.flash_bwd, fa.flash_attention_reference,
                             fa.flash_bwd_reference))
    scale = D ** -0.5
    before = fwd.launches
    o, lse = fwd(q, k, v, slopes, key_lens, scale, offset, q_lens, True, 0.1, seed)
    torch.cuda.synchronize()
    assert fwd.launches == before + 1 and o.shape == q.shape
    o_ref, lse_ref = pfwd(q, k, v, slopes, key_lens, scale, offset, q_lens, True, 0.1, seed)
    assert (o.float() - o_ref.float()).abs().max().item() <= bound
    live = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), live)
    assert (lse[live] - lse_ref[live]).abs().max().item() <= 1e-4 * (
        1 + lse_ref[live].abs().max().item())
    w = _do(card, q, D)
    args = (q, k, v, slopes, key_lens, q_lens, seed, o, lse, w, scale, offset, True, 0.1)
    before = bwd.launches
    got = bwd(*args)
    torch.cuda.synchronize()
    assert bwd.launches == before + 1
    assert [g.shape for g in got[:3]] == [q.shape, k.shape, v.shape]
    _assert_within(got, pbwd(*args), bound)


# The f32 slope gradients at B 4, N = M = 1024 (a sum of 4M products of
# ds * dist that cancel to a small total) over 16 draws of dL/do, each from
# a generator of its own: K5b with one and with H key/value heads, and K2.
# With f32 logits (the slopes and lse rounded in base 2 once a head and a
# row) K5b with one key/value head strayed past the bound in 2 of 16 draws;
# the f32 kernels now take the logits less lse in float64.
SLOPE_DRAW_CASES = [("K5b", 1), ("K5b", 6), ("K2", 1)]


@pytest.mark.parametrize("kernel,Hkv", SLOPE_DRAW_CASES)
def test_f32_slope_gradient_holds_over_16_draws(card, kernel, Hkv):
    from isp_tts_tpu_torch.ops import flash_attention as fa

    q, k, v, slopes, key_lens, q_lens = _flash(card, 4, 1024, 1024, 6, Hkv, torch.float32,
                                               seed=2)
    if kernel == "K2":
        fwd, bwd, plain = fa.mqa_fwd, fa.mqa_bwd, fa.mqa_bwd_reference
        k, v = k[:, :, 0].contiguous(), v[:, :, 0].contiguous()
    else:
        fwd, bwd, plain = fa.flash_fwd, fa.flash_bwd, fa.flash_bwd_reference
    seed = torch.tensor([41], dtype=torch.int32, device=card)
    for draw in range(16):
        w = _do(card, q, draw)
        _kernel_vs_plain_bwd(fwd, bwd, plain, q, k, v, slopes, key_lens, q_lens, seed, w, 0,
                             False, 0.1, 1e-4)


VOCODER = "docs/assets/scale_r5/vocoder_joint10k_r5.f16.ckpt"
AUDIO_TEXTS = ["The birch canoe slid away.", "Glue the sheet to the dark blue background."]


def _audio_synth(card):
    """The committed acoustic model and vocoder on the card, a padded batch
    mel of AUDIO_TEXTS and its frame counts."""
    from isp_tts_tpu_torch.serving import Synthesizer

    synth = Synthesizer.from_pretrained(CKPT, vocoder_path=VOCODER)
    mel, dec_lens, B = synth._synthesize_mel(AUDIO_TEXTS, seed=0)
    return synth, mel, dec_lens[:B].tolist()


def test_vocoder_on_the_card_matches_the_cpu(card):
    from isp_tts_tpu_torch.models.vocoder import VocoderModel

    torch.backends.cudnn.allow_tf32 = False
    synth, mel, dec = _audio_synth(card)
    cpu = VocoderModel.from_pretrained(VOCODER, device="cpu")
    wave = synth.vocoder.infer(mel)
    assert (wave.cpu() - cpu.infer(mel.cpu())).abs().max().item() <= 1e-3
    with torch.no_grad():
        head = synth.vocoder.generator.spectrum(mel).cpu()
        ref = cpu.generator.spectrum(mel.cpu())
    assert (head - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    from isp_tts_tpu_torch.ops.vocoder import log_mel_matmul

    for i, n in enumerate(dec):
        audio = torch.clamp(wave[i, : n * 256], -1, 1)
        assert (log_mel_matmul(audio) - mel[i, :n]).abs().mean().item() <= 0.5


def test_griffin_lim_on_the_card_matches_the_cpu(card):
    from isp_tts_tpu_torch.ops.vocoder import griffin_lim_matmul, log_mel_matmul, mel_to_linear

    _, mel, dec = _audio_synth(card)
    mag = mel_to_linear(mel[:, : max(dec)], 22050) ** 1.2
    angles = torch.rand(mag.shape, generator=torch.Generator().manual_seed(0)) * 6.283 - 3.1415
    got = griffin_lim_matmul(mag, n_iter=32, angles=angles.to(card))
    ref = griffin_lim_matmul(mag.cpu(), n_iter=32, angles=angles)
    assert (got.cpu() - ref).abs().max().item() <= 2e-3
    for i, n in enumerate(dec):  # each sentence on its own frames, as the CLI runs it
        audio = torch.clamp(griffin_lim_matmul(mel_to_linear(mel[i:i + 1, :n], 22050) ** 1.2,
                                               n_iter=32), -1, 1)[0]
        assert (log_mel_matmul(audio) - mel[i, :n]).abs().mean().item() <= 0.6


def test_synthesize_audio_on_the_card(card):
    from isp_tts_tpu_torch.ops.flash_attention import mqa_fwd

    synth, _, _ = _audio_synth(card)
    frames = [m.shape[0] for m in synth(AUDIO_TEXTS, seed=4)]
    before = mqa_fwd.launches
    wavs = synth.synthesize_audio(AUDIO_TEXTS, seed=4)
    assert mqa_fwd.launches - before == 25
    for w, n in zip(wavs, frames):
        assert w.shape == (n * 256,) and np.isfinite(w).all() and np.abs(w).max() <= 1.0
    long = synth.synthesize_long(" ".join(AUDIO_TEXTS), seed=4)
    assert long.shape == (sum(w.size for w in wavs) + int(0.25 * 22050),)


def test_fp16_training_step_runs_the_kernels(card):
    """``precision: fp16`` on the card: the attention kernels take the fp16
    values widened to f32; the kernel path's loss terms within 1e-2 of the
    plain path's (fp16 rounds the products on both), every gradient finite."""
    import copy

    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.models.acoustic.loss import AcousticLossConfig, AcousticModelLoss
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
    from isp_tts_tpu_torch.nn.attention import Attention
    from isp_tts_tpu_torch.ops.flash_attention import mqa_fwd
    from isp_tts_tpu_torch.training.trainer import Trainer
    from isp_tts_tpu_torch.training.trainer_config import TrainerConfig

    layer = {"attention": {"heads": 4, "head_dim": 64, "one_kv_head": True,
                           "alibi_pos_bias": True}, "feed_forward": {"inner_dim": 256}}
    stack = {"dim": 128, "depth": 2, "transformer_layer": layer}
    cfg = {"encoding_map": {c: i for i, c in enumerate(["<pad>", "</s>", *"abcdefgh "])},
           "mel_dim": 16, "text_dim": 128, "encoder": stack, "decoder": stack,
           "temporal_adaptor": {"predictor": {"transformer": stack, "time_embedding_dim": 16},
                                "embedding": {"transformer": stack}, "soft_duration": True},
           "aligner": {"attention_dim": 16}}
    torch.manual_seed(0)
    model = AcousticModel(build_config(AcousticModelConfig, cfg))
    plain = copy.deepcopy(model)
    for m in plain.modules():
        if isinstance(m, Attention):
            m.flash = "off"
    rng = np.random.RandomState(5)
    B, T, M = 4, 24, 96
    batch = {"text_vector": torch.from_numpy(rng.randint(2, 11, size=(B, T))),
             "text_vector_len": torch.tensor([24, 20, 13, 9]),
             "mel": torch.from_numpy(rng.randn(B, M, 16).astype(np.float32)),
             "mel_len": torch.tensor([96, 80, 60, 40]),
             "pitch": torch.from_numpy(rng.randn(B, M).astype(np.float32)),
             "energy": torch.from_numpy(rng.randn(B, M).astype(np.float32))}
    out = []
    mqa_fwd.launches = 0
    for mod in (model, plain):
        trainer = Trainer(mod, AcousticModelLoss(build_config(AcousticLossConfig, {})),
                          TrainerConfig(precision="fp16"),
                          generator=torch.Generator(device=card).manual_seed(4))
        out.append(trainer.compute_gradients(batch))
        assert all(torch.isfinite(p.grad).all() for p in mod.parameters())
    assert mqa_fwd.launches > 0
    (_, lk, _), (_, lp, _) = out
    for key in lp:
        assert abs(lk[key].item() - lp[key].item()) <= 1e-2 * abs(lp[key].item()), key


def test_front_end_on_the_card_matches_the_cpu(card):
    """The batched front end (STFT, log-mel, energy, YIN) on the card
    against the same on the CPU: mel and energy within 1e-3, pitch voiced
    on the same frames (at least 99%) and within 1e-3 relative there."""
    from isp_tts_tpu_torch.ops.frontend import FrontendConfig, extract_features

    rng = np.random.RandomState(6)
    n = 22050 * 3
    t = np.arange(n) / 22050
    f0 = 140 + 40 * np.sin(2 * np.pi * 0.7 * t)
    audio = np.stack([0.5 * np.sin(2 * np.pi * np.cumsum(f0 * s) / 22050) + 0.01 * rng.randn(n)
                      for s in (1.0, 1.3, 0.8, 1.7)]).astype(np.float32)
    lens = np.array([n, n - 5000, n // 2, n - 123], np.int32)
    cfg = FrontendConfig()
    cpu = extract_features(torch.from_numpy(audio), torch.from_numpy(lens), cfg, 150.0, 40.0)
    gpu = extract_features(torch.from_numpy(audio).to(card), torch.from_numpy(lens).to(card),
                           cfg, 150.0, 40.0)
    assert torch.equal(cpu.mel_lens, gpu.mel_lens.cpu())
    assert (cpu.mel - gpu.mel.cpu()).abs().max() <= 1e-3
    assert (cpu.energy - gpu.energy.cpu()).abs().max() <= 1e-3 * cpu.energy.abs().max()
    fc, fg = cpu.pitch * 40 + 150, gpu.pitch.cpu() * 40 + 150
    mask = torch.arange(cpu.mel.shape[1])[None] < cpu.mel_lens[:, None]
    vc, vg = (fc > 1) & mask, (fg > 1) & mask
    assert (vc == vg)[mask].float().mean() >= 0.99
    both = vc & vg
    assert ((fc - fg).abs()[both] <= 1e-3 * fc[both]).all()


def test_fp32_steps_run_with_tf32_off_and_restore_the_setting(card, tmp_path):
    """``precision: fp32`` computes in full float32 on the card: cuDNN's and
    cuBLAS's TF32 are off and cuDNN deterministic inside the trainer's step
    (and only there), the process's settings are the same after it, and two
    runs of the same 2 steps from the same weights and seed are bit-equal."""
    import copy

    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.models.acoustic.loss import AcousticModelLoss
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
    from isp_tts_tpu_torch.training.trainer import Trainer
    from isp_tts_tpu_torch.training.trainer_config import TrainerConfig

    layer = {"attention": {"heads": 4, "head_dim": 64, "one_kv_head": True,
                           "alibi_pos_bias": True, "dropout": 0.1},
             "feed_forward": {"inner_dim": 256, "activation": "gelu", "dropout": 0.1}}
    stack = {"dim": 128, "depth": 2, "transformer_layer": layer}
    cfg = {"encoding_map": {c: i for i, c in enumerate(["<pad>", "</s>", *"abcdefgh "])},
           "mel_dim": 16, "text_dim": 128, "encoder": stack, "decoder": stack,
           "temporal_adaptor": {"predictor": {"transformer": stack, "time_embedding_dim": 16},
                                "embedding": {"transformer": stack}, "soft_duration": True},
           "aligner": {"attention_dim": 16, "key_kernel_size": 5, "query_kernel_size": 5}}
    torch.manual_seed(0)
    model = AcousticModel(build_config(AcousticModelConfig, cfg))
    rng = np.random.RandomState(3)
    B, T, M = 4, 24, 96
    batch = {"text_vector": rng.randint(2, 11, (B, T)).astype(np.int32),
             "text_vector_len": np.array([24, 20, 16, 12], np.int32),
             "mel": rng.randn(B, M, 16).astype(np.float32),
             "mel_len": np.array([96, 80, 64, 50], np.int32),
             "pitch": rng.randn(B, M).astype(np.float32),
             "energy": rng.randn(B, M).astype(np.float32)}
    backends = torch.backends
    def settings():
        return (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
                backends.cudnn.deterministic)

    before = (True, False, False)  # PyTorch's defaults
    (backends.cudnn.allow_tf32, backends.cuda.matmul.allow_tf32,
     backends.cudnn.deterministic) = before
    seen, runs = [], []
    for _ in range(2):
        config = build_config(TrainerConfig, {"precision": "fp32", "progress": False,
                                              "log_with": [], "output_dir": str(tmp_path)})
        trainer = Trainer(copy.deepcopy(model), AcousticModelLoss(), config, device=card)
        hook = trainer.model.register_forward_pre_hook(lambda m, a: seen.append(settings()))
        history = trainer.train([batch], 2)
        hook.remove()
        runs.append((history, [p.detach().clone() for p in trainer.model.parameters()]))
    assert set(seen) == {(False, False, True)}
    assert settings() == before
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
