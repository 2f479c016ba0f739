"""The attention layer's whole interface against the JAX package's, on the
CPU: cross-attention (``context``, ``context_mask``, ``context_dim``),
explicit attention masks of rank 2, 3 and 4, KV caches (self-attention
appends, cross-attention reuses) and ``return_cache``, through
``Attention`` and ``Transformer``.

The same seeded numpy inputs and the JAX layer's weights (loaded into the
port) go through both; float32, each output and gradient within 1e-5 of
its max-abs. The JAX layer runs its CPU path (the einsum attention); the
port runs each of its routes: "auto" (the plain masked path for a mask or
a context; the registered operator's plain version otherwise), "on" (the
operator at offset M - N) and "off" (the family's plain version). Where
the two packages refuse a call (``flash: on`` with an attention mask, a
stacked stack with any of these arguments) both raise.

The port's cache holds (B, M, Hkv, D), the JAX package's (B, Hkv, M, D).
A self-attention cache with a padding mask follows the JAX einsum path:
defined at one query a call (the mask's one column broadcast over the
cached keys), refused above it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.nn.attention import Attention as JAttention
from isp_tts_tpu.nn.attention import AttentionConfig as JAttentionConfig
from isp_tts_tpu.nn.transformer import Transformer as JTransformer
from isp_tts_tpu.nn.transformer import TransformerConfig as JTransformerConfig
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.nn.attention import Attention, AttentionConfig
from isp_tts_tpu_torch.nn.transformer import Transformer, TransformerConfig, TransformerOutput
from isp_tts_tpu_torch.parallel.context import parallel_context
from torch_port_common import carry, perturb, t

RTOL = 1e-5
CFG = {"dim": 64, "heads": 3, "head_dim": 64, "alibi_pos_bias": True}
B, N, M, CTX = 2, 13, 21, 48


def close(got, ref, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-12)
    err = np.abs(got - ref).max()
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} * {scale:.3e}"


def pair(flash="auto", seed=6, **over):
    """(JAX layer, port layer) with the same perturbed weights."""
    cfg = dict(CFG, **over)
    jat = JAttention(jax_build_config(JAttentionConfig, cfg), rngs=nnx.Rngs(0))
    at = Attention(build_config(AttentionConfig, dict(cfg, flash=flash)))
    carry(perturb(jat, seed), at)
    return jat, at


def lengths_mask(lens, width):
    return np.arange(width)[None, :] < np.asarray(lens)[:, None]


def inputs(seed=2, n=N, m=M, ctx=CTX):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, n, 64).astype(np.float32), rng.randn(B, m, ctx).astype(np.float32),
            lengths_mask([n, n - 5], n), lengths_mask([m - 7, m], m),
            rng.randn(B, n, 64).astype(np.float32))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("flash", ["auto", "on", "off"])
@pytest.mark.parametrize("one_kv", [True, False])
def test_cross_attention_outputs_and_gradients_match(one_kv, flash, symmetric):
    """Outputs and the gradients of sum(out * w) w.r.t. x and the context."""
    jat, at = pair(flash, one_kv_head=one_kv, context_dim=CTX, alibi_symmetric=symmetric)
    x, c, mask, cmask, w = inputs()

    def jloss(xx, cc):
        out, _, _ = jat(xx, mask=jnp.asarray(mask), context=cc,
                        context_mask=jnp.asarray(cmask))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), (jdx, jdc) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(c))
    xt, ct = t(x).requires_grad_(), t(c).requires_grad_()
    out = at(xt, mask=t(mask), context=ct, context_mask=t(cmask))
    (out * t(w)).sum().backward()
    close(out, ref, what="out")
    close(xt.grad, jdx, what="dx")
    close(ct.grad, jdc, what="dcontext")


@pytest.mark.parametrize("flash", ["auto", "off"])
@pytest.mark.parametrize("one_kv", [True, False])
def test_the_plain_paths_run_in_float64(one_kv, flash):
    """A float64 layer's plain paths (the masked path, the family's plain
    version) compute in float64, slopes included: the exact reference the
    card's checks hold the kernels' f32 results against. Against the JAX
    layer (f32) within 1e-5."""
    jat, at = pair(flash, one_kv_head=one_kv, context_dim=CTX, alibi_symmetric=False)
    at.double()
    x, c, mask, cmask, w = inputs(4)

    def jloss(xx, cc):
        out, _, _ = jat(xx, mask=jnp.asarray(mask), context=cc,
                        context_mask=jnp.asarray(cmask))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), (jdx, jdc) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(c))
    xt, ct = t(x).double().requires_grad_(), t(c).double().requires_grad_()
    out = at(xt, mask=t(mask), context=ct, context_mask=t(cmask))
    (out * t(w).double()).sum().backward()
    assert out.dtype == xt.grad.dtype == at.rel_pos.log_slopes.grad.dtype == torch.float64
    assert at.rel_pos.slopes2().dtype == torch.float64
    close(out, ref, what="out")
    close(xt.grad, jdx, what="dx")
    close(ct.grad, jdc, what="dcontext")


@pytest.mark.parametrize("rank", [2, 3, 4])
@pytest.mark.parametrize("flash", ["auto", "off"])
@pytest.mark.parametrize("one_kv", [True, False])
def test_explicit_attention_masks_match(one_kv, flash, rank):
    """A causal layer's self-attention with a padding mask and a random
    attention mask (a fully masked query row among them) ANDed in."""
    jat, at = pair(flash, one_kv_head=one_kv, causal=True, alibi_symmetric=False)
    x, _, mask, _, w = inputs(3)
    rng = np.random.RandomState(rank)
    shape = {2: (N, N), 3: (3, N, N), 4: (B, 3, N, N)}[rank]
    amask = rng.rand(*shape) < 0.7
    amask[..., 4, :] = False
    xt = t(x).requires_grad_()

    def jloss(xx):
        out, _, _ = jat(xx, mask=jnp.asarray(mask), attention_mask=jnp.asarray(amask))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), jdx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    out = at(xt, mask=t(mask), attention_mask=t(amask))
    (out * t(w)).sum().backward()
    close(out, ref, what="out")
    close(xt.grad, jdx, what="dx")
    assert not out[:, 4].any()


def test_flash_on_with_an_attention_mask_raises_in_both():
    jat, at = pair("on")
    jon = JAttention(jax_build_config(JAttentionConfig, dict(CFG, flash="on")),
                     rngs=nnx.Rngs(0))
    x = np.zeros((1, 4, 64), np.float32)
    amask = np.ones((4, 4), bool)
    with pytest.raises(ValueError, match="attention_mask"):
        jon(jnp.asarray(x), attention_mask=jnp.asarray(amask))
    with pytest.raises(ValueError, match="attention_mask"):
        at(t(x), attention_mask=t(amask))


def decode(at, x, **kw):
    """One query a call through the layer's cache: (outputs, last cache)."""
    cache, outs = None, []
    for i in range(x.shape[1]):
        out, cache = at(x[:, i:i + 1], cache=cache, return_cache=True, **kw)
        outs.append(out)
    return torch.cat(outs, dim=1), cache


@pytest.mark.parametrize("flash", ["auto", "on", "off"])
@pytest.mark.parametrize("one_kv", [True, False])
def test_kv_cache_decode_equals_the_full_causal_call(one_kv, flash):
    """Decoding token by token through the cache (offset M - N on the
    core) equals the full causal call, and JAX's full call; the last cache
    is JAX's (k, v) with the head and key axes swapped."""
    jat, at = pair(flash, one_kv_head=one_kv, causal=True, alibi_symmetric=False)
    x = np.random.RandomState(4).randn(B, 9, 64).astype(np.float32)
    ref, _, (jk, jv) = jat(jnp.asarray(x))
    with torch.no_grad():
        full = at(t(x))
        inc, (k, v) = decode(at, t(x))
    close(full, ref, what="full")
    close(inc, full, what="decode")
    close(k.permute(0, 2, 1, 3), jk, what="k")
    close(v.permute(0, 2, 1, 3), jv, what="v")


def test_kv_cache_in_the_jax_tests_setting():
    """``tests/test_nn.py::test_attention_kv_cache_incremental``: dim 32, 4
    heads of 8 (the plain version: the kernels take head dim 64), causal,
    6 tokens; the port's decode against JAX's decode step by step."""
    cfg = dict(dim=32, heads=4, head_dim=8, causal=True)
    jat = JAttention(jax_build_config(JAttentionConfig, cfg), rngs=nnx.Rngs(0))
    jat.eval()
    at = Attention(build_config(AttentionConfig, dict(cfg, flash="off"))).eval()
    carry(perturb(jat, 9), at)
    x = np.random.RandomState(0).randn(1, 6, 32).astype(np.float32)
    jcache, cache = None, None
    with torch.no_grad():
        for i in range(6):
            ref, _, jcache = jat(jnp.asarray(x[:, i:i + 1]), cache=jcache)
            out, cache = at(t(x[:, i:i + 1]), cache=cache, return_cache=True)
            close(out, ref, what=f"step {i}")
        close(cache[0].permute(0, 2, 1, 3), jcache[0], what="k")
        close(decode(at, t(x))[0], jat(jnp.asarray(x))[0], what="decode vs full")


@pytest.mark.parametrize("flash", ["auto", "on"])
@pytest.mark.parametrize("one_kv", [True, False])
def test_cross_attention_cache_is_reused(one_kv, flash):
    """A cross-attention cache stands for ``to_kv(context)``: a second call
    with it gives the first call's output, as the JAX layer does, and the
    cache is JAX's."""
    jat, at = pair(flash, one_kv_head=one_kv, context_dim=CTX)
    x, c, mask, cmask, _ = inputs(5)
    kw = dict(mask=jnp.asarray(mask), context_mask=jnp.asarray(cmask))
    ref, _, jcache = jat(jnp.asarray(x), context=jnp.asarray(c), **kw)
    ref2, _, _ = jat(jnp.asarray(x), context=jnp.asarray(c), cache=jcache, **kw)
    with torch.no_grad():
        pkw = dict(mask=t(mask), context_mask=t(cmask))
        out, cache = at(t(x), context=t(c), return_cache=True, **pkw)
        # the context's values are not read again: the cache stands for them
        out2, cache2 = at(t(x), context=torch.zeros_like(t(c)), cache=cache,
                          return_cache=True, **pkw)
    close(out, ref, what="first")
    close(out2, ref2, what="reused")
    assert cache2[0] is cache[0]
    close(cache[0].permute(0, 2, 1, 3), jcache[0], what="k")


def stack_config(**attention):
    return {"dim": 64, "depth": 2,
            "transformer_layer": {"attention": dict(CFG, **attention),
                                  "feed_forward": {"inner_dim": 128, "activation": "gelu"}}}


@pytest.mark.parametrize("one_kv", [True, False])
def test_transformer_cross_attention_with_caches_matches(one_kv):
    """``Transformer(context=..., return_cache=True)`` gives JAX's output and
    per-layer caches; fed those caches back it gives JAX's output again."""
    cfg = stack_config(one_kv_head=one_kv, context_dim=CTX)
    jtr = JTransformer(jax_build_config(JTransformerConfig, cfg), rngs=nnx.Rngs(0))
    tr = Transformer(build_config(TransformerConfig, cfg))
    carry(perturb(jtr, 7), tr)
    x, c, mask, cmask, _ = inputs(6)
    kw = dict(mask=jnp.asarray(mask), context=jnp.asarray(c), context_mask=jnp.asarray(cmask))
    ref = jtr(jnp.asarray(x), return_cache=True, **kw)
    ref2 = jtr(jnp.asarray(x), cache=ref.cache, **kw).out
    pkw = dict(mask=t(mask), context=t(c), context_mask=t(cmask))
    with torch.no_grad():
        got = tr(t(x), return_cache=True, **pkw)
        got2 = tr(t(x), cache=got.cache, **pkw)
    assert isinstance(got, TransformerOutput) and isinstance(got2, torch.Tensor)
    close(got.out, ref.out, what="out")
    close(got2, ref2, what="cached")
    assert len(got.cache) == 2
    for (k, v), (jk, jv) in zip(got.cache, ref.cache):
        close(k.permute(0, 2, 1, 3), jk, what="k")
        close(v.permute(0, 2, 1, 3), jv, what="v")


def test_transformer_causal_decode_matches():
    """A causal self-attention stack decoded through its caches, token by
    token, against JAX's decode and the full call (no absolute positions:
    ALiBi carries them)."""
    cfg = stack_config(one_kv_head=True, causal=True)
    jtr = JTransformer(jax_build_config(JTransformerConfig, cfg), rngs=nnx.Rngs(0))
    tr = Transformer(build_config(TransformerConfig, cfg)).eval()
    carry(perturb(jtr, 8), tr)
    x = np.random.RandomState(7).randn(B, 7, 64).astype(np.float32)
    jcache, cache, outs = None, None, []
    with torch.no_grad():
        for i in range(7):
            ref = jtr(jnp.asarray(x[:, i:i + 1]), cache=jcache, return_cache=True)
            got = tr(t(x[:, i:i + 1]), cache=cache, return_cache=True)
            close(got.out, ref.out, what=f"step {i}")
            jcache, cache = ref.cache, got.cache
            outs.append(got.out)
        close(torch.cat(outs, dim=1), jtr(jnp.asarray(x)).out, what="decode vs full")


@pytest.mark.parametrize("arg", ["context", "attention_mask", "cache", "return_cache"])
def test_stacked_stack_refuses_what_jax_refuses(arg):
    cfg = dict(stack_config(context_dim=CTX if arg == "context" else None), pipeline=True)
    jtr = JTransformer(jax_build_config(JTransformerConfig, cfg), rngs=nnx.Rngs(0))
    tr = Transformer(build_config(TransformerConfig, cfg))
    x = np.zeros((1, 4, 64), np.float32)
    value = {"context": np.zeros((1, 3, CTX), np.float32),
             "attention_mask": np.ones((4, 4), bool),
             "cache": [(np.zeros((1, 1, 2, 64), np.float32),) * 2] * 2,
             "return_cache": True}[arg]
    jvalue = value if arg == "return_cache" else jax.tree.map(jnp.asarray, value)
    pvalue = value if arg == "return_cache" else jax.tree.map(t, value)
    with pytest.raises(ValueError, match="pipeline=True"):
        jtr(jnp.asarray(x), **{arg: jvalue})
    with pytest.raises(ValueError, match="pipeline=True"):
        tr(t(x), **{arg: pvalue})


@pytest.mark.parametrize("flash", ["auto", "off"])
def test_a_cache_with_a_padding_mask_follows_the_einsum_path(flash):
    """One query a call: a valid query sees every cached key (JAX's einsum
    path), a padded one gives zeros; more queries with a mask raise."""
    jat, at = pair(flash, one_kv_head=True, causal=True)
    x = np.random.RandomState(8).randn(B, 6, 64).astype(np.float32)
    _, _, jcache = jat(jnp.asarray(x[:, :5]))
    with torch.no_grad():
        _, cache = at(t(x[:, :5]), return_cache=True)
        step = x[:, 5:]
        qmask = np.array([[True], [False]])
        ref, _, _ = jat(jnp.asarray(step), mask=jnp.asarray(qmask), cache=jcache)
        out = at(t(step), mask=t(qmask), cache=cache)
        close(out, ref, what="masked step")
        close(out[0], at(t(step), cache=cache)[0], what="valid row")
        assert not out[1].any()
        with pytest.raises(ValueError, match="one query"):
            at(t(x[:, :2]), mask=t(np.ones((B, 2), bool)), cache=cache)


@pytest.mark.parametrize("call", ["context", "attention_mask", "cache"])
def test_ring_falls_back_to_local_attention(call, caplog):
    """``flash: ring`` on a named seq axis runs what "auto" runs for a call
    the ring does not take (JAX's ``_maybe_ring``), with one warning."""
    over = {"context_dim": CTX} if call == "context" else {"causal": call == "cache"}
    _, ring = pair("ring", one_kv_head=True, **over)
    _, auto = pair("auto", one_kv_head=True, **over)
    x, c, mask, cmask, _ = inputs(9)
    if call == "context":
        kw = dict(mask=t(mask), context=t(c), context_mask=t(cmask))
    elif call == "attention_mask":
        kw = dict(mask=t(mask), attention_mask=t(np.tril(np.ones((N, N), bool))))
    else:
        _, cache = auto(t(x[:, :4]), return_cache=True)
        x, kw = x[:, 4:5], dict(cache=cache)
    with torch.no_grad(), parallel_context(seq_axis="seq"):
        got = ring(t(x), **kw)
        ring(t(x), **kw)
    with torch.no_grad():
        ref = auto(t(x), **kw)
    close(got, ref, rtol=0, what=call)
    if call == "cache":
        assert sum("ring-compatible" in r.message for r in caplog.records) == 1
