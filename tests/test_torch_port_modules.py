"""The port's building blocks against the JAX package's, on the CPU.

Same numpy inputs from a seed through both; float32 throughout, so the
tolerance is float32 rounding of sums over at most a few hundred terms
(1e-5 absolute on unit-scale values unless stated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import isp_tts_tpu.ops.flash_attention as fa
from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.nn import embeddings as jemb
from isp_tts_tpu.nn import norms as jnorms
from isp_tts_tpu.nn.attention import Attention as JAttention
from isp_tts_tpu.nn.attention import AttentionConfig as JAttentionConfig
from isp_tts_tpu.nn.feedforward import FeedForward as JFeedForward
from isp_tts_tpu.nn.feedforward import FeedForwardConfig as JFeedForwardConfig
from isp_tts_tpu.nn.transformer import Transformer as JTransformer
from isp_tts_tpu.nn.transformer import TransformerConfig as JTransformerConfig
from isp_tts_tpu.ops.attention import scaled_dot_product_attention as jax_sdpa
from isp_tts_tpu.utils import masks as jmasks
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.nn import embeddings as pemb
from isp_tts_tpu_torch.nn import norms as pnorms
from isp_tts_tpu_torch.nn.attention import Attention, AttentionConfig
from isp_tts_tpu_torch.nn.feedforward import FeedForward, FeedForwardConfig
from isp_tts_tpu_torch.nn.transformer import Transformer, TransformerConfig
from isp_tts_tpu_torch.ops.flash_attention import _geometry, mqa_attention_reference, mqa_fwd
from isp_tts_tpu_torch.utils import masks as pmasks
from torch_port_common import carry, perturb, t

ATOL = 1e-5


def test_masks_match():
    lens = np.array([0, 3, 7, 5], np.int32)
    heights = np.array([2, 6, 1, 4], np.int32)
    np.testing.assert_array_equal(
        pmasks.get_mask_from_lengths(t(lens), 7).numpy(),
        np.asarray(jmasks.get_mask_from_lengths(jnp.asarray(lens), 7)))
    flens = np.array([0.0, 2.5, 6.25, 3.75], np.float32)
    np.testing.assert_array_equal(
        pmasks.get_float_mask_from_lengths(t(flens), 7).numpy(),
        np.asarray(jmasks.get_float_mask_from_lengths(jnp.asarray(flens), 7)))
    np.testing.assert_array_equal(
        pmasks.get_mask_3d(t(lens), t(heights), 7, 6).numpy(),
        np.asarray(jmasks.get_mask_3d(jnp.asarray(lens), jnp.asarray(heights), 7, 6)))


def test_layer_norms_match():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 16).astype(np.float32) * 3 + 1
    cond = rng.randn(2, 8).astype(np.float32)

    jln = jnorms.LayerNorm(16, rngs=nnx.Rngs(0))
    flat = perturb(jln, 1)
    ln = pnorms.LayerNorm(16)
    carry(flat, ln)
    np.testing.assert_allclose(ln(t(x)).detach().numpy(),
                               np.asarray(jln(jnp.asarray(x))), atol=ATOL)

    jada = jnorms.AdaptiveLayerNorm(16, 8, rngs=nnx.Rngs(0))
    flat = perturb(jada, 2)
    ada = pnorms.AdaptiveLayerNorm(16, 8)
    carry(flat, ada)
    np.testing.assert_allclose(ada(t(x), t(cond)).detach().numpy(),
                               np.asarray(jada(jnp.asarray(x), jnp.asarray(cond))),
                               atol=ATOL)


@pytest.mark.parametrize("heads", [1, 2, 3, 4, 5, 6, 8, 12])
def test_alibi_slopes_match(heads):
    np.testing.assert_allclose(pemb.alibi_slopes(heads), jemb.alibi_slopes(heads),
                               rtol=1e-12)


def test_position_and_time_embeddings_match():
    np.testing.assert_allclose(pemb.fixed_positional_embedding(37, 24).numpy(),
                               np.asarray(jemb.fixed_positional_embedding(37, 24)),
                               atol=ATOL)
    ts = np.array([0.0, 0.1, 0.5, 0.999], np.float32)
    np.testing.assert_allclose(
        pemb.sinusoidal_embedding(t(ts), 64, 1000.0, 1000.0).numpy(),
        np.asarray(jemb.sinusoidal_embedding(jnp.asarray(ts), 64, 1000.0, 1000.0)),
        atol=1e-4)  # sin/cos of angles up to 1e3 rad: f32 argument rounding
    jte = jemb.TimePositionalEmbedding(freq_dim=64, emb_dim=16, rngs=nnx.Rngs(0))
    te = pemb.TimePositionalEmbedding(freq_dim=64, emb_dim=16)
    carry(perturb(jte, 3), te)
    np.testing.assert_allclose(te(t(ts)).detach().numpy(),
                               np.asarray(jte(jnp.asarray(ts))), atol=1e-4)


@pytest.mark.parametrize("symmetric", [True, False])
def test_learned_alibi_match(symmetric):
    jb = jemb.LearnedALiBiBias(heads=3, total_heads=4, symmetric=symmetric)
    pb = pemb.LearnedALiBiBias(3, 4, symmetric)
    carry(perturb(jb, 4), pb)
    # the bias the port's attention applies (from the kernels' two slope
    # rows) against the JAX layer's materialised bias
    dist = jemb.alibi_distance_bias(5, 9, 4)
    _, _, bias = _geometry(5, 9, 4, pb.slopes2(), "cpu")  # (N, H, M)
    np.testing.assert_allclose(bias.permute(1, 0, 2).detach().numpy(),
                               np.asarray(jb.apply_slopes(dist, offset=4)), atol=ATOL)


@pytest.mark.parametrize("glu", [False, True])
def test_feedforward_matches(glu):
    cfg = {"dim": 16, "inner_dim": 32, "activation": "gelu", "glu": glu}
    jff = JFeedForward(jax_build_config(JFeedForwardConfig, cfg), rngs=nnx.Rngs(0))
    ff = FeedForward(build_config(FeedForwardConfig, cfg))
    carry(perturb(jff, 5), ff)
    x = np.random.RandomState(1).randn(2, 7, 16).astype(np.float32)
    np.testing.assert_allclose(ff(t(x)).detach().numpy(),
                               np.asarray(jff(jnp.asarray(x))), atol=ATOL)


def _mqa_inputs(B, N, M, H, symmetric, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, N, H, 64).astype(np.float32)
    k = rng.randn(B, M, 64).astype(np.float32)
    v = rng.randn(B, M, 64).astype(np.float32)
    sl = np.asarray(jemb.alibi_slopes(H), np.float32)
    slopes = np.stack([sl, sl if symmetric else sl * 0.5 + 0.01])
    key_lens = rng.randint(M // 2, M + 1, size=B).astype(np.int32)
    q_lens = rng.randint(N // 2, N + 1, size=B).astype(np.int32)
    return q, k, v, slopes, key_lens, q_lens


MQA_CASES = [  # B, N, M, H, offset, symmetric, causal
    (2, 40, 40, 6, 0, True, False),
    (2, 40, 40, 4, 0, False, False),
    (1, 24, 56, 6, 32, False, False),
    (2, 30, 45, 4, 15, True, True),
]


@pytest.mark.parametrize("B,N,M,H,offset,symmetric,causal", MQA_CASES)
def test_mqa_attention_matches_pallas_kernel_in_interpret_mode(B, N, M, H, offset,
                                                               symmetric, causal):
    """The plain K1 against the JAX package's folded-MQA Pallas kernel,
    run by the Pallas interpreter on the CPU."""
    q, k, v, slopes, key_lens, q_lens = _mqa_inputs(B, N, M, H, symmetric, 0)
    scale = 64 ** -0.5
    fa.INTERPRET = True
    try:
        ref = fa.flash_attention_mqa(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slopes),
            jnp.asarray(key_lens), scale, offset, symmetric=symmetric,
            q_lens=jnp.asarray(q_lens), causal=causal)
        _, (*_, lse_ref) = fa._mqa_fwd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slopes),
            jnp.asarray(key_lens), jnp.asarray(q_lens), jnp.zeros((1,), jnp.int32),
            scale, offset, fa.DEF_BLOCK_R, fa.DEF_BLOCK_K_MQA, symmetric, causal)
    finally:
        fa.INTERPRET = False
    out, lse = mqa_fwd(t(q), t(k), t(v), t(slopes), t(key_lens), scale, offset,
                       t(q_lens), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL)
    assert mqa_fwd.launches == 0  # CPU tensors never reach the kernel


@pytest.mark.parametrize("B,N,M,H,offset,symmetric,causal", MQA_CASES)
def test_mqa_attention_matches_jax_einsum_path(B, N, M, H, offset, symmetric, causal):
    """The plain K1 against the JAX einsum SDPA with the ALiBi bias
    materialised."""
    q, k, v, slopes, key_lens, _ = _mqa_inputs(B, N, M, H, symmetric, 1)
    scale = 64 ** -0.5
    n = np.arange(N)[:, None]
    c = np.arange(M)[None, :]
    dist = -np.abs(c - n - offset).astype(np.float32)
    bias = np.where((c <= n + offset)[None], slopes[0][:, None, None] * dist,
                    slopes[1][:, None, None] * dist).astype(np.float32)  # (H, N, M)
    mask = (np.arange(M)[None, :] < key_lens[:, None])[:, None, None, :]
    qh = q.transpose(0, 2, 1, 3)
    ref = jax_sdpa(jnp.asarray(qh), jnp.asarray(k[:, None]), jnp.asarray(v[:, None]),
                   scale=scale, bias=jnp.asarray(bias), mask=jnp.asarray(mask),
                   causal=causal and offset == M - N)
    ref = np.asarray(ref).transpose(0, 2, 1, 3)
    out, _ = mqa_attention_reference(t(q), t(k), t(v), t(slopes), t(key_lens),
                                     scale, offset, causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


ATTN_CFG = {"dim": 64, "heads": 3, "head_dim": 64, "one_kv_head": True,
            "alibi_pos_bias": True}


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("flash", ["auto", "off"])
def test_attention_layer_matches(symmetric, flash):
    """The port's attention layer (both cores) against the JAX layer's CPU
    path, ragged padding mask included."""
    cfg = dict(ATTN_CFG, alibi_symmetric=symmetric)
    jat = JAttention(jax_build_config(JAttentionConfig, cfg), rngs=nnx.Rngs(0))
    at = Attention(build_config(AttentionConfig, dict(cfg, flash=flash)))
    carry(perturb(jat, 6), at)
    rng = np.random.RandomState(2)
    x = rng.randn(2, 19, 64).astype(np.float32)
    mask = np.arange(19)[None, :] < np.array([19, 11])[:, None]
    ref, _, _ = jat(jnp.asarray(x), mask=jnp.asarray(mask))
    out = at(t(x), mask=t(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("adaptive", [False, True])
def test_transformer_stack_matches(adaptive):
    cfg = {"dim": 64, "depth": 2, "emb_dim": 40,
           "transformer_layer": {"attention": ATTN_CFG,
                                 "feed_forward": {"inner_dim": 128, "activation": "gelu"}}}
    if adaptive:
        cfg.update(adaptive_norm=True, condition_dim=8)
    jtr = JTransformer(jax_build_config(JTransformerConfig, cfg), rngs=nnx.Rngs(0))
    tr = Transformer(build_config(TransformerConfig, cfg))
    carry(perturb(jtr, 7), tr)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 23, 40).astype(np.float32)
    mask = np.arange(23)[None, :] < np.array([23, 9])[:, None]
    cond = rng.randn(2, 8).astype(np.float32) if adaptive else None
    ref = jtr(jnp.asarray(x), mask=jnp.asarray(mask),
              adaptive_condition=None if cond is None else jnp.asarray(cond)).out
    out = tr(t(x), mask=t(mask), adaptive_condition=None if cond is None else t(cond))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-4)


def test_transformer_without_alibi_uses_absolute_positions():
    cfg = {"dim": 64, "depth": 1,
           "transformer_layer": {"attention": dict(ATTN_CFG, alibi_pos_bias=False),
                                 "feed_forward": {"inner_dim": 64}}}
    jtr = JTransformer(jax_build_config(JTransformerConfig, cfg), rngs=nnx.Rngs(0))
    tr = Transformer(build_config(TransformerConfig, cfg))
    assert tr.use_abs_pos_emb
    carry(perturb(jtr, 8), tr)
    x = np.random.RandomState(4).randn(1, 12, 64).astype(np.float32)
    np.testing.assert_allclose(tr(t(x)).detach().numpy(),
                               np.asarray(jtr(jnp.asarray(x)).out), atol=1e-4)
