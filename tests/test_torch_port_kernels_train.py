"""The plain versions of the training path's kernels (K1 with dropout, K2,
K3, K4) against the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as the JAX
package's own tests do. Inputs come from numpy seeds. Tolerances: float32
rounding of sums over at most a few hundred terms (1e-5 absolute on outputs,
1e-4 of the max-abs on gradients, which sum over rows and heads); MAS is
integer-exact; CTC losses 1e-5 relative (a frame-serial chain of logaddexp),
gradients 1e-4 of the max-abs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import isp_tts_tpu.ops.flash_attention as fa
from isp_tts_tpu.models.acoustic.loss import _ordered_ctc_neg_logp
from isp_tts_tpu.nn.embeddings import alibi_slopes
from isp_tts_tpu.ops.mas import mas_numpy as jax_mas_numpy
from isp_tts_tpu.ops.mas import monotonic_alignment_search as jax_mas
from isp_tts_tpu.ops.mas_pallas import monotonic_alignment_search_pallas
from isp_tts_tpu_torch.ops import ctc as pctc
from isp_tts_tpu_torch.ops import mas as pmas
from isp_tts_tpu_torch.ops.flash_attention import (keep_hash, mqa_attention,
                                                   mqa_attention_reference, mqa_bwd,
                                                   mqa_fwd, mqa_keep_mask)
from torch_port_common import t


@pytest.mark.parametrize("B,R,M,seed", [(2, 24, 40, 0), (3, 18, 33, 12345),
                                        (1, 6, 7, 2**31 - 2)])
def test_keep_mask_matches_jax_bit_for_bit(B, R, M, seed):
    H = 6 if R % 6 == 0 else 3
    for rate in (0.1, 0.3, 0.5):
        thresh = fa.dropout_thresh(rate)
        ours = mqa_keep_mask(B, R // H, H, M, torch.tensor([seed], dtype=torch.int32),
                             thresh).reshape(B, R, M).numpy()
        sref = jnp.asarray([seed], jnp.int32)
        ref = np.stack([np.asarray(fa._mqa_keep(sref, jnp.int32(b), 0, 0, R, M, R, M,
                                                thresh)) for b in range(B)])
        np.testing.assert_array_equal(ours, ref)
        assert abs(ours.mean() - thresh / 256) < 0.1


@pytest.mark.parametrize("b,ri,ki,r_true,m_true", [
    (3, 70000, 9, 2**20, 4096),        # (b*R + r)*M + c past 2**34
    (40, 5, 2**13, 1920, 2**20),       # past 2**32 through the key index
    (31, 239, 2, 1920, 320),           # the training shape's last block
])
def test_keep_hash_wraps_like_jax_past_2_32(b, ri, ki, r_true, m_true):
    seed, thresh, br, bk = 987654321, fa.dropout_thresh(0.1), 8, 128
    ref = np.asarray(fa._mqa_keep(jnp.asarray([seed], jnp.int32), jnp.int32(b), ri, ki,
                                  br, bk, r_true, m_true, thresh))
    rows = ri * br + np.arange(br)[:, None]
    cols = ki * bk + np.arange(bk)[None, :]
    idx = (b * r_true + rows) * m_true + cols  # exact, not wrapped
    assert idx.max() > 2**32 or (b, ri) == (31, 239)
    ours = keep_hash(torch.from_numpy(idx.astype(np.int64)), seed, thresh).numpy()
    np.testing.assert_array_equal(ours, ref)


def _mqa_inputs(B, N, M, H, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, N, H, 64).astype(np.float32)
    k = rng.randn(B, M, 64).astype(np.float32)
    v = rng.randn(B, M, 64).astype(np.float32)
    sl = np.asarray(alibi_slopes(H), np.float32)
    slopes = np.stack([sl, sl * 0.5 + 0.01]).astype(np.float32)
    key_lens = rng.randint(M // 2, M + 1, size=B).astype(np.int32)
    q_lens = rng.randint(N // 2, N + 1, size=B).astype(np.int32)
    key_lens[0], q_lens[0] = M, N
    return q, k, v, slopes, key_lens, q_lens


def _jax_mqa(q, k, v, slopes, key_lens, q_lens, offset, causal, rate, seed):
    return fa.flash_attention_mqa(
        q, k, v, slopes, jnp.asarray(key_lens), 64 ** -0.5, offset, symmetric=False,
        q_lens=jnp.asarray(q_lens), causal=causal, dropout_rate=rate,
        dropout_seed=jnp.asarray(seed, jnp.int32) if rate else None)


MQA_CASES = [  # B, N, M, H, offset, causal, rate
    (2, 40, 40, 6, 0, False, 0.1),
    (2, 40, 40, 4, 0, False, 0.3),
    (1, 24, 56, 6, 32, False, 0.1),
    (2, 30, 30, 4, 0, True, 0.1),
]


@pytest.mark.parametrize("B,N,M,H,offset,causal,rate", MQA_CASES)
def test_plain_k1_with_dropout_matches_pallas_interpret(B, N, M, H, offset, causal,
                                                        rate):
    q, k, v, slopes, key_lens, q_lens = _mqa_inputs(B, N, M, H, 0)
    seed = 4242
    fa.INTERPRET = True
    try:
        ref = _jax_mqa(*(jnp.asarray(a) for a in (q, k, v, slopes)), key_lens, q_lens,
                       offset, causal, rate, seed)
    finally:
        fa.INTERPRET = False
    out, _ = mqa_fwd(t(q), t(k), t(v), t(slopes), t(key_lens), 64 ** -0.5, offset,
                     t(q_lens), causal, rate, torch.tensor([seed], dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # the dropout is live: without it the output differs
    plain, _ = mqa_attention_reference(t(q), t(k), t(v), t(slopes), t(key_lens),
                                       64 ** -0.5, offset, t(q_lens), causal)
    assert (plain - out).abs().max() > 1e-2


@pytest.mark.parametrize("B,N,M,H,offset,causal,rate", [
    (2, 40, 40, 6, 0, False, 0.0), (2, 40, 40, 6, 0, False, 0.1),
    (1, 24, 56, 4, 32, False, 0.1), (2, 30, 30, 4, 0, True, 0.0)])
def test_plain_k2_matches_jax_grad_through_pallas(B, N, M, H, offset, causal, rate):
    """K2's plain version (the backward of the port's autograd function on
    CPU tensors) against jax.grad through the Pallas forward and backward
    in interpret mode, and against autograd through the plain K1."""
    q, k, v, slopes, key_lens, q_lens = _mqa_inputs(B, N, M, H, 1)
    w = np.random.RandomState(2).randn(B, N, H, 64).astype(np.float32)
    seed = 77

    def jloss(q, k, v, s):
        o = _jax_mqa(q, k, v, s, key_lens, q_lens, offset, causal, rate, seed)
        return jnp.sum(o * jnp.asarray(w))

    fa.INTERPRET = True
    try:
        ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(
            *(jnp.asarray(a) for a in (q, k, v, slopes)))
    finally:
        fa.INTERPRET = False

    def grads(fn):
        args = [t(a).requires_grad_() for a in (q, k, v, slopes)]
        o = fn(*args)
        (o * t(w)).sum().backward()
        return [a.grad.numpy() for a in args]

    sd = torch.tensor([seed], dtype=torch.int32)
    ours = grads(lambda q_, k_, v_, s_: mqa_attention(
        q_, k_, v_, s_, t(key_lens), 64 ** -0.5, offset, t(q_lens), causal, rate, sd))
    auto = grads(lambda q_, k_, v_, s_: mqa_attention_reference(
        q_, k_, v_, s_, t(key_lens), 64 ** -0.5, offset, t(q_lens), causal, rate, sd)[0])
    for name, a, b, c in zip(("dq", "dk", "dv", "dslopes"), ours, ref, auto):
        scale = np.abs(np.asarray(b)).max()
        assert np.abs(a - np.asarray(b)).max() <= 1e-4 * scale, name
        assert np.abs(a - c).max() <= 1e-4 * scale, name
    assert mqa_bwd.launches == 0  # CPU tensors never reach the kernel


def _lattice(B, M, T, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, M, T).astype(np.float32)
    i = np.arange(M)[:, None] / M
    j = np.arange(T)[None, :] / T
    return logits - 8.0 * (i - j) ** 2


@pytest.mark.parametrize("B,M,T,tl,ml,seed", [
    (4, 50, 16, [16, 9, 4, 12], [50, 33, 21, 14], 3),
    (3, 40, 12, [12, 12, 12], [40, 40, 40], 0),
    (5, 64, 20, [20, 11, 1, 7, 19], [64, 40, 9, 7, 30], 5),
])
def test_plain_mas_matches_jax_exactly(B, M, T, tl, ml, seed):
    logits = _lattice(B, M, T, seed)
    tl, ml = np.asarray(tl, np.int32), np.asarray(ml, np.int32)
    ours = pmas.monotonic_alignment_search(t(logits), t(tl), t(ml)).numpy()
    np.testing.assert_array_equal(ours, jax_mas_numpy(logits, tl, ml))
    np.testing.assert_array_equal(ours, pmas.mas_numpy(logits, tl, ml))
    np.testing.assert_array_equal(ours, np.asarray(jax_mas(logits, tl, ml)))
    pallas = monotonic_alignment_search_pallas(jnp.asarray(logits), jnp.asarray(tl),
                                               jnp.asarray(ml), interpret=True)
    np.testing.assert_array_equal(ours, np.asarray(pallas))
    np.testing.assert_array_equal(ours.sum(axis=(1, 2)), ml)
    assert pmas.monotonic_alignment_search.launches == 0


def test_plain_mas_row_of_neg_inf_logits():
    """A row whose logits all sit at the DP's NEG_INF: the backtrack clamps
    at token 0, as the Pallas kernel does (the scan's pointer would leave
    the map), so every valid row still selects one token."""
    logits = _lattice(2, 30, 8, 7)
    logits[0, 10] = -1e9
    tl, ml = np.array([8, 5], np.int32), np.array([30, 20], np.int32)
    ours = pmas.monotonic_alignment_search(t(logits), t(tl), t(ml)).numpy()
    pallas = monotonic_alignment_search_pallas(jnp.asarray(logits), jnp.asarray(tl),
                                               jnp.asarray(ml), interpret=True)
    np.testing.assert_array_equal(ours, np.asarray(pallas))
    np.testing.assert_array_equal(ours.sum(axis=(1, 2)), ml)


def _ctc_inputs(B, M, T, seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, M, T + 1).astype(np.float32)
    logprobs = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=2))
    text_lens = rng.randint(1, T + 1, size=B).astype(np.int32)
    mel_lens = rng.randint(T + 1, M + 1, size=B).astype(np.int32)
    text_lens[0], mel_lens[0] = T, M
    return logprobs, text_lens, mel_lens


@pytest.mark.parametrize("B,M,T,seed", [(3, 40, 12, 0), (5, 64, 20, 1), (2, 17, 16, 2)])
def test_plain_k4_matches_jax_and_torch_ctc(B, M, T, seed):
    lp, tl, ml = _ctc_inputs(B, M, T, seed)
    g = np.random.RandomState(seed + 10).rand(B).astype(np.float32)

    def jloss(x):
        return jnp.sum(_ordered_ctc_neg_logp(x, jnp.asarray(tl), jnp.asarray(ml))
                       * jnp.asarray(g))

    ref = np.asarray(_ordered_ctc_neg_logp(jnp.asarray(lp), jnp.asarray(tl),
                                           jnp.asarray(ml)))
    ref_grad = np.asarray(jax.grad(jloss)(jnp.asarray(lp)))

    for fn in (pctc.ordered_ctc_neg_logp, pctc.ordered_ctc_neg_logp_reference):
        x = t(lp).requires_grad_()
        out = fn(x, t(tl), t(ml))
        (out * t(g)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5)
        assert np.abs(x.grad.numpy() - ref_grad).max() <= 1e-4 * np.abs(ref_grad).max()

    # a third reference, in this test only: torch's CTC on the same ordered
    # labels, blank 0, zero_infinity. Its backward assumes a log_softmax in
    # front of it, so both gradients are taken through one, w.r.t. logits.
    logits = t(lp).requires_grad_()
    labels = torch.arange(1, T + 1).repeat(B, 1)
    torch_ctc = F.ctc_loss(logits.log_softmax(-1).transpose(0, 1), labels,
                           t(ml).long(), t(tl).long(), blank=0, reduction="none",
                           zero_infinity=True)
    (torch_ctc * t(g)).sum().backward()
    np.testing.assert_allclose(torch_ctc.detach().numpy(), ref, rtol=1e-5)
    ours = t(lp).requires_grad_()
    (pctc.ordered_ctc_neg_logp(ours.log_softmax(-1), t(tl), t(ml)) * t(g)).sum().backward()
    scale = logits.grad.abs().max()
    assert (ours.grad - logits.grad).abs().max() <= 1e-4 * scale
    assert pctc.ctc_fwd.launches == 0 and pctc.ctc_bwd.launches == 0


def test_plain_k4_infeasible_sample_is_finite_and_gated_by_the_loss():
    """mel shorter than text: -log Z sits at ~1e30 (the NEG sentinel), and
    the gradient is finite; the loss gate, not the kernel, zeroes it."""
    lp, _, _ = _ctc_inputs(2, 10, 8, 3)
    tl, ml = np.array([8, 4], np.int32), np.array([5, 10], np.int32)
    x = t(lp).requires_grad_()
    out = pctc.ordered_ctc_neg_logp(x, t(tl), t(ml))
    assert out[0] > 1e29 and np.isfinite(out[1].item())
    out[1].backward()
    assert torch.isfinite(x.grad).all() and x.grad[0].abs().max() == 0
