"""Head dims other than 64: the attention kernels' plain versions, the
wrappers' head-dim rule and the attention layer, the port against the JAX
package on the CPU (the small model split as 12 heads x 32 and 2 heads x
128 is in ``test_torch_port_head_dims_model.py``).

The JAX side runs ``flash_attention_mqa`` (K1/K2's TPU kernels) and
``flash_attention`` (K5a/K5b's) in interpret mode, as the JAX package's own
tests do; its layer takes its CPU path (the einsum attention), so the layer
runs with dropout off. Inputs come from numpy seeds, and the JAX parameters
are carried over with ``carry``. Tolerances are float32 rounding: 1e-5
absolute on attention outputs and 1e-5 of the max-abs on their gradients
(sums over rows, and over heads where one key/value head serves all), as
``test_torch_port_mha.py`` holds head dim 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import isp_tts_tpu.ops.flash_attention as jfa
from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.nn.attention import Attention as JAttention
from isp_tts_tpu.nn.attention import AttentionConfig as JAttentionConfig
from isp_tts_tpu.nn.embeddings import alibi_slopes
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.nn.attention import Attention, AttentionConfig
from isp_tts_tpu_torch.ops import flash_attention as fa
from torch_port_common import assert_grads_match, carry, flat_grads, perturb, t

SEED = 4242


def _inputs(B, N, M, H, Hkv, D, seed):
    """q (B, N, H, D), k/v (B, M, D) (``Hkv`` None) or (B, M, Hkv, D), slopes
    (2, H) with asymmetric rows, ragged lengths (row 0 full, a key length
    and a query length short)."""
    rng = np.random.RandomState(seed)
    kv = (B, M, D) if Hkv is None else (B, M, Hkv, D)
    q = rng.randn(B, N, H, D).astype(np.float32)
    k, v = rng.randn(*kv).astype(np.float32), rng.randn(*kv).astype(np.float32)
    sl = np.asarray(alibi_slopes(H), np.float32)
    slopes = np.stack([sl, sl * 0.5 + 0.01]).astype(np.float32)
    key_lens = np.asarray([M] + [max(1, M // 2 + 3 * i) for i in range(1, B)], np.int32)
    q_lens = np.asarray([N] + [max(1, N - 5 * i) for i in range(1, B)], np.int32)
    return q, k, v, slopes, key_lens, q_lens


def _jax_attention(q, k, v, slopes, kl, ql, scale, offset, causal, rate, mqa):
    """The JAX package's kernel entry on the port's layouts: (B, N, H, D) out."""
    seed = jnp.asarray(SEED, jnp.int32) if rate else None
    if mqa:
        return jfa.flash_attention_mqa(q, k, v, slopes, jnp.asarray(kl), scale, offset,
                                       q_lens=jnp.asarray(ql), causal=causal,
                                       dropout_rate=rate, dropout_seed=seed)
    out = jfa.flash_attention(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                              v.transpose(0, 2, 1, 3), slopes, jnp.asarray(kl), scale, offset,
                              q_lens=jnp.asarray(ql), causal=causal, dropout_rate=rate,
                              dropout_seed=seed)
    return out.transpose(0, 2, 1, 3)


#: (B, N, M, H, Hkv, offset, causal, rate): ragged rows and keys, causal at
#: an offset, dropout; Hkv None is the folded-MQA family (K1/K2)
MQA_CASES = [(2, 37, 45, 3, None, 4, True, 0.1), (2, 40, 29, 2, None, -3, False, 0.0)]
HEAD_CASES = [(2, 33, 41, 3, 3, 6, True, 0.1), (2, 30, 38, 2, 1, 0, False, 0.1)]
#: every head dim with one case of each family, the cases taken in turn
KERNEL_CASES = [(D, MQA_CASES[i % 2], HEAD_CASES[(i // 2 + i) % 2])
                for i, D in enumerate((8, 16, 32, 128))]


@pytest.mark.parametrize("D,case", [(D, c) for D, *cases in KERNEL_CASES for c in cases],
                         ids=lambda x: "-".join(map(str, x)) if isinstance(x, tuple) else str(x))
def test_plain_kernels_match_pallas_interpret(D, case):
    """K1/K2's and K5a/K5b's plain versions (the wrappers on CPU tensors,
    under the registered operators' autograd) against the JAX kernels in
    interpret mode at head dim D: the output within 1e-5, and jax.grad's
    dq, dk, dv and slope gradients within 1e-5 of their max-abs."""
    B, N, M, H, Hkv, offset, causal, rate = case
    mqa = Hkv is None
    q, k, v, slopes, kl, ql = _inputs(B, N, M, H, Hkv, D, seed=D + N)
    w = np.random.RandomState(D).randn(B, N, H, D).astype(np.float32)
    scale = D ** -0.5

    def jloss(q_, k_, v_, s_):
        o = _jax_attention(q_, k_, v_, s_, kl, ql, scale, offset, causal, rate, mqa)
        return jnp.sum(o * jnp.asarray(w)), o

    jfa.INTERPRET = True
    try:
        (_, ref), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(a) for a in (q, k, v, slopes)))
    finally:
        jfa.INTERPRET = False
    attn = fa.mqa_attention if mqa else fa.flash_attention
    args = [t(a).requires_grad_() for a in (q, k, v, slopes)]
    out = attn(*args, t(kl), scale, offset, t(ql), causal, rate,
               torch.tensor([SEED], dtype=torch.int32))
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    for name, a, b in zip(("dq", "dk", "dv", "dslopes"), args, jgrads):
        b = np.asarray(b)
        assert np.abs(a.grad.numpy() - b).max() <= 1e-5 * np.abs(b).max(), name


@pytest.mark.parametrize("Hkv", [None, 2, 1])
def test_zero_padding_of_the_head_dim_is_exact(Hkv):
    """The wrappers' rule for a head dim that is not a multiple of 8 (12
    here): q, k, v and dO zero-padded to 16 (``pad_head_dim``), run at the
    caller's scale and sliced back, give the unpadded plain call's o, lse
    and gradients (float32, 1e-6 of the max-abs: the zero columns add exact
    zeros, only the sums' grouping may differ)."""
    B, N, M, H, D = 2, 21, 27, 2, 12
    q, k, v, slopes, kl, ql = (t(a) for a in _inputs(B, N, M, H, Hkv, D, seed=12))
    do = torch.from_numpy(np.random.RandomState(1).randn(B, N, H, D).astype(np.float32))
    seed, scale = torch.tensor([SEED], dtype=torch.int32), D ** -0.5
    fwd, bwd = ((fa.mqa_attention_reference, fa.mqa_bwd_reference) if Hkv is None else
                (fa.flash_attention_reference, fa.flash_bwd_reference))
    padded = fa.pad_head_dim(q, k, v, do)
    assert all(x.shape[-1] == 16 and x.is_contiguous() for x in padded)
    assert all(not x[..., D:].any() for x in padded)
    args = (slopes, kl, scale, 3, ql, True, 0.1, seed)
    o, lse = fwd(q, k, v, *args)
    o_p, lse_p = fwd(*padded[:3], *args)
    np.testing.assert_allclose(o_p[..., :D].numpy(), o.numpy(), atol=1e-6)
    np.testing.assert_array_equal(o_p[..., D:].numpy(), 0.0)
    np.testing.assert_allclose(lse_p.numpy(), lse.numpy(), atol=1e-6)
    grads = bwd(q, k, v, slopes, kl, ql, seed, o, lse, do, scale, 3, True, 0.1)
    o_pad = fa.pad_head_dim(o)[0]
    grads_p = bwd(*padded[:3], slopes, kl, ql, seed, o_pad, lse_p, padded[3], scale, 3, True,
                  0.1)
    for name, a, b in zip(("dq", "dk", "dv", "dslopes"), grads_p, grads):
        a = a[..., :D] if name != "dslopes" else a
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), name


@pytest.mark.parametrize("D,tile", [(1, 16), (8, 16), (12, 16), (16, 16), (17, 32), (32, 32),
                                    (40, 64), (64, 64), (96, 128), (128, 128)])
def test_head_dims_pick_the_least_tile_width(D, tile):
    """A call of head dim D launches its source built at the least tile
    width >= D (``-DATT_TILE_D``), under the library name cuda_build gives
    it."""
    from isp_tts_tpu_torch.ops import cuda_build

    assert fa.head_tile(D) == tile
    name = fa.kernel_library("flash_bwd", D)
    assert name == f"flash_bwd_d{tile}"
    source, defines = cuda_build.unit(name)
    assert source.name == "flash_bwd.cu" and defines == (f"-DATT_TILE_D={tile}",)


@pytest.mark.parametrize("D", [0, 129, 256])
def test_head_dims_past_the_tiles_raise(D):
    """The wrappers refuse a head dim past 128 (and an empty one), naming
    the limit; on a CUDA tensor there is no quiet fallback."""
    with pytest.raises(ValueError, match="head dims up to 128"):
        fa._head_dim(torch.zeros(1, 2, 1, D))
    if D:
        with pytest.raises(ValueError, match="head dims up to 128"):
            fa.head_tile(D)


@pytest.mark.parametrize("one_kv_head", [True, False])
@pytest.mark.parametrize("D", [8, 32, 128])
def test_attention_layer_matches_at_head_dim(D, one_kv_head):
    """The port's attention layer with ``flash: auto`` (the registered
    operators over the kernels' plain versions on the CPU) against the JAX
    layer's CPU path at head dim D, ragged padding mask, dropout off: the
    output within 1e-5 and every parameter's gradient within 1e-5 of its
    max-abs."""
    cfg = {"dim": 48, "heads": 3, "head_dim": D, "one_kv_head": one_kv_head,
           "alibi_pos_bias": True, "alibi_symmetric": False}
    jat = JAttention(jax_build_config(JAttentionConfig, cfg), rngs=nnx.Rngs(0))
    at = Attention(build_config(AttentionConfig, dict(cfg, flash="auto")))
    carry(perturb(jat, 6), at)
    assert at.to_q.weight.shape == (3 * D, 48)
    rng = np.random.RandomState(D)
    x = rng.randn(2, 19, 48).astype(np.float32)
    w = rng.randn(2, 19, 48).astype(np.float32)
    mask = np.arange(19)[None, :] < np.array([19, 11])[:, None]

    def jloss(m):
        out, _, _ = m(jnp.asarray(x), mask=jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), jgrads = nnx.value_and_grad(jloss, has_aux=True)(jat)
    out = at(t(x), mask=t(mask))
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    assert_grads_match(flat_grads(jgrads), at, 1e-5)
