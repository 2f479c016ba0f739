"""The per-head attention kernels' plain versions (K5a forward, K5b
backward) and the multi-KV-head attention layer against the JAX package,
on the CPU.

The JAX side runs ``flash_attention``'s Pallas kernels in interpret mode,
as the JAX package's own tests do; the JAX layer takes its CPU path (the
einsum attention), so the layer is compared with dropout off. Inputs come
from numpy seeds. Tolerances: float32 rounding of sums over at most a few
hundred terms, 1e-5 absolute on outputs and 1e-5 of the max-abs on
gradients (they sum over rows, and over heads where one key/value head
serves all).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import isp_tts_tpu.ops.flash_attention as fa
from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.nn.attention import Attention as JAttention
from isp_tts_tpu.nn.attention import AttentionConfig as JAttentionConfig
from isp_tts_tpu.nn.embeddings import alibi_slopes
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.nn.attention import Attention, AttentionConfig
from isp_tts_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_reference, flash_bwd,
                                                   flash_fwd, head_keep_mask, keep_hash,
                                                   mqa_attention_reference)
from torch_port_common import assert_grads_match, carry, flat_grads, perturb, t


@pytest.mark.parametrize("B,H,N,M,seed", [(2, 4, 24, 40, 0), (3, 3, 18, 33, 12345),
                                          (1, 2, 6, 7, 2**31 - 2)])
def test_head_keep_mask_matches_jax_bit_for_bit(B, H, N, M, seed):
    for rate in (0.1, 0.3, 0.5):
        thresh = fa.dropout_thresh(rate)
        ours = head_keep_mask(B, H, N, M, torch.tensor([seed], dtype=torch.int32),
                              thresh).numpy()
        sref = jnp.asarray([seed], jnp.int32)
        ref = np.stack([np.stack([np.asarray(fa._head_keep(
            sref, jnp.int32(b), jnp.int32(h), H, 0, 0, N, M, N, M, thresh))
            for h in range(H)]) for b in range(B)])
        np.testing.assert_array_equal(ours, ref)
        assert abs(ours.mean() - thresh / 256) < 0.1


@pytest.mark.parametrize("b,h,heads,qi,ki,n_true,m_true", [
    (3, 5, 6, 70000, 9, 2**20, 4096),      # ((b*H + h)*N + n)*M + c past 2**36
    (40, 1, 4, 5, 2**13, 1920, 2**20),     # past 2**32 through the key index
    (31, 5, 6, 39, 2, 320, 320),           # the decoder training shape's last block
])
def test_head_keep_hash_wraps_like_jax_past_2_32(b, h, heads, qi, ki, n_true, m_true):
    seed, thresh, bq, bk = 987654321, fa.dropout_thresh(0.1), 8, 128
    ref = np.asarray(fa._head_keep(jnp.asarray([seed], jnp.int32), jnp.int32(b),
                                   jnp.int32(h), heads, qi, ki, bq, bk, n_true, m_true,
                                   thresh))
    rows = qi * bq + np.arange(bq)[:, None]
    cols = ki * bk + np.arange(bk)[None, :]
    idx = ((b * heads + h) * n_true + rows) * m_true + cols  # exact, not wrapped
    assert idx.max() > 2**32 or n_true == 320
    ours = keep_hash(torch.from_numpy(idx.astype(np.int64)), seed, thresh).numpy()
    np.testing.assert_array_equal(ours, ref)


def _inputs(B, N, M, H, Hkv, symmetric, seed, key_lens=None, q_lens=None):
    """q (B, N, H, 64), k/v (B, M, Hkv, 64) in the port's layout, slopes
    (2, H) and ragged lengths (row 0 full unless given)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, N, H, 64).astype(np.float32)
    k = rng.randn(B, M, Hkv, 64).astype(np.float32)
    v = rng.randn(B, M, Hkv, 64).astype(np.float32)
    sl = np.asarray(alibi_slopes(H), np.float32)
    slopes = np.stack([sl, sl if symmetric else sl * 0.5 + 0.01]).astype(np.float32)
    if key_lens is None:
        key_lens = rng.randint(M // 2, M + 1, size=B)
        key_lens[0] = M
    if q_lens is None:
        q_lens = rng.randint(N // 2, N + 1, size=B)
        q_lens[0] = N
    return (q, k, v, slopes, np.asarray(key_lens, np.int32), np.asarray(q_lens, np.int32))


def _jax_flash(q, k, v, slopes, key_lens, q_lens, offset, causal, rate, seed, block):
    """JAX's flash_attention on the port's layouts: (B, N, H, D) out."""
    out = fa.flash_attention(
        q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3),
        slopes, jnp.asarray(key_lens), 64 ** -0.5, offset, block_q=block, block_k=block,
        q_lens=jnp.asarray(q_lens), causal=causal, dropout_rate=rate,
        dropout_seed=jnp.asarray(seed, jnp.int32) if rate else None)
    return out.transpose(0, 2, 1, 3)


FLASH_CASES = [  # B, N, M, H, Hkv, symmetric, offset, causal, rate, key_lens, q_lens, block
    (2, 40, 40, 4, 4, True, 0, False, 0.0, None, None, 128),
    (2, 40, 40, 4, 4, False, 0, False, 0.1, None, None, 128),
    (2, 40, 40, 4, 1, False, 0, False, 0.1, None, None, 128),
    (1, 24, 56, 3, 3, True, 32, True, 0.1, None, None, 128),
    (3, 30, 30, 2, 2, False, 0, False, 0.1, [30, 0, 17], [30, 12, 0], 128),
    (2, 160, 160, 2, 2, False, 0, True, 0.1, [160, 131], [160, 150], 128),
]


@pytest.mark.parametrize("B,N,M,H,Hkv,symmetric,offset,causal,rate,key_lens,q_lens,block",
                         FLASH_CASES)
def test_plain_k5a_matches_pallas_interpret(B, N, M, H, Hkv, symmetric, offset, causal,
                                            rate, key_lens, q_lens, block):
    q, k, v, slopes, kl, ql = _inputs(B, N, M, H, Hkv, symmetric, 0, key_lens, q_lens)
    seed = 4242
    fa.INTERPRET = True
    try:
        ref = _jax_flash(*(jnp.asarray(a) for a in (q, k, v, slopes)), kl, ql, offset,
                         causal, rate, seed, block)
    finally:
        fa.INTERPRET = False
    out, lse = flash_fwd(t(q), t(k), t(v), t(slopes), t(kl), 64 ** -0.5, offset, t(ql),
                         causal, rate, torch.tensor([seed], dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # dead rows (past q_len, or with no valid key) give o = 0 and lse = +inf
    dead = (np.arange(N)[None, :] >= ql[:, None]) | (kl[:, None] == 0)
    assert np.isinf(lse.numpy().transpose(0, 2, 1)[dead]).all()
    assert np.isfinite(lse.numpy().transpose(0, 2, 1)[~dead]).all()
    assert not out.numpy()[dead].any()
    if rate:  # the dropout is live: without it the output differs
        plain, _ = flash_attention_reference(t(q), t(k), t(v), t(slopes), t(kl),
                                             64 ** -0.5, offset, t(ql), causal)
        assert (plain - out).abs().max() > 1e-2


@pytest.mark.parametrize("B,N,M,H,Hkv,symmetric,offset,causal,rate,key_lens,q_lens,block",
                         FLASH_CASES)
def test_plain_k5b_matches_jax_grad_through_pallas(B, N, M, H, Hkv, symmetric, offset,
                                                   causal, rate, key_lens, q_lens, block):
    """K5b's plain version (the backward of the port's autograd function on
    CPU tensors) against jax.grad through the Pallas forward and backward
    in interpret mode, and against autograd through the plain K5a."""
    q, k, v, slopes, kl, ql = _inputs(B, N, M, H, Hkv, symmetric, 1, key_lens, q_lens)
    w = np.random.RandomState(2).randn(B, N, H, 64).astype(np.float32)
    seed = 77

    def jloss(q, k, v, s):
        o = _jax_flash(q, k, v, s, kl, ql, offset, causal, rate, seed, block)
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
    ours = grads(lambda q_, k_, v_, s_: flash_attention(
        q_, k_, v_, s_, t(kl), 64 ** -0.5, offset, t(ql), causal, rate, sd))
    auto = grads(lambda q_, k_, v_, s_: flash_attention_reference(
        q_, k_, v_, s_, t(kl), 64 ** -0.5, offset, t(ql), causal, rate, sd)[0])
    for name, a, b, c in zip(("dq", "dk", "dv", "dslopes"), ours, ref, auto):
        b = np.asarray(b)
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-5 * scale, name
        assert np.abs(a - c).max() <= 1e-5 * scale, name
    assert flash_bwd.launches == 0  # CPU tensors never reach the kernel


def test_one_kv_head_flash_equals_folded_mqa_without_dropout():
    """With Hkv = 1 the per-head family computes the folded-MQA family's
    function (their dropout masks hash different indices)."""
    q, k, v, slopes, kl, ql = _inputs(2, 33, 41, 3, 1, False, 5)
    args = [t(a).requires_grad_() for a in (q, k, v, slopes)]
    o = flash_attention(*args, t(kl), 0.125, 4, t(ql))
    o.square().sum().backward()
    margs = [t(a[:, :, 0] if a.ndim == 4 and a.shape[2] == 1 else a).requires_grad_()
             for a in (q, k, v, slopes)]
    mo, _ = mqa_attention_reference(*margs, t(kl), 0.125, 4, t(ql))
    mo.square().sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), mo.detach().numpy(), atol=1e-6)
    for a, b in zip(args, margs):
        np.testing.assert_allclose(a.grad.reshape(b.grad.shape).numpy(), b.grad.numpy(),
                                   atol=1e-5 * b.grad.abs().max().item())


MHA_CFG = {"dim": 64, "heads": 3, "head_dim": 64, "one_kv_head": False,
           "alibi_pos_bias": True}


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("flash", ["auto", "off"])
def test_multi_kv_head_attention_layer_matches(symmetric, flash):
    """The port's multi-KV-head attention layer (the autograd function over
    K5a/K5b's plain versions, and the plain forward under autograd) against
    the JAX layer's CPU path, ragged padding mask included: output and
    every parameter's gradient."""
    cfg = dict(MHA_CFG, alibi_symmetric=symmetric)
    jat = JAttention(jax_build_config(JAttentionConfig, cfg), rngs=nnx.Rngs(0))
    at = Attention(build_config(AttentionConfig, dict(cfg, flash=flash)))
    carry(perturb(jat, 6), at)
    assert at.to_kv.weight.shape == (2 * 3 * 64, 64)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 19, 64).astype(np.float32)
    w = rng.randn(2, 19, 64).astype(np.float32)
    mask = np.arange(19)[None, :] < np.array([19, 11])[:, None]

    def jloss(m):
        out, _, _ = m(jnp.asarray(x), mask=jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), jgrads = nnx.value_and_grad(jloss, has_aux=True)(jat)
    out = at(t(x), mask=t(mask))
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    assert_grads_match(flat_grads(jgrads), at, 1e-5)
