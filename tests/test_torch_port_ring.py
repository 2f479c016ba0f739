"""The port's ring attention against the JAX package's, in one process.

``ring_attention_virtual`` runs every rank of an S-rank ring here (the
chunks each rank would be handed); ``ring_attention`` with no group is the
ring of size 1. Both are held to JAX's ``ring_attention_sharded`` on
``make_mesh(seq=S)`` of the conftest's virtual CPU devices, on the cases of
``tests/test_ring_attention.py`` (both families, ``offset``, causal with
``q_lens``, zero slopes, a fully masked batch row): outputs within 1e-5 of
max-abs, gradients of q, k, v and the slopes within 1e-5 of each one's
max-abs (with and without remat). Under dropout the keep mask is bit-equal
to JAX's ``_keep_hash`` over the ring's per-head index, and the port's
S = 1, 2, 4 equal JAX's S = 4 (its mask does not depend on the shard
count) within 1e-5. Then ``Attention(flash="ring")``: it rings on a named
seq axis of size 1 (equal to ``flash="off"``), runs the local kernels with
no seq axis, and falls back with one warning when the sequence does not
divide over the axis.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isp_tts_tpu.nn.embeddings import alibi_slopes
from isp_tts_tpu.ops.flash_attention import _keep_hash
from isp_tts_tpu.ops.ring_attention import ring_attention_sharded
from isp_tts_tpu.parallel.mesh import make_mesh
from isp_tts_tpu_torch.nn.attention import Attention, AttentionConfig
from isp_tts_tpu_torch.ops.flash_attention import dropout_thresh
from isp_tts_tpu_torch.ops.ring_attention import (ring_attention, ring_attention_virtual,
                                                  ring_keep_mask)
from isp_tts_tpu_torch.parallel.context import parallel_context

B, H, N, D = 2, 4, 64, 16


def inputs(hkv, seed=0, key_lens=(N, N - 29)):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, N, D) * 0.4).astype(np.float32)
    k = (rng.randn(B, hkv, N, D) * 0.4).astype(np.float32)
    v = (rng.randn(B, hkv, N, D) * 0.4).astype(np.float32)
    sl = np.asarray(alibi_slopes(H), np.float32)
    slopes = np.stack([sl, 0.5 * sl])  # asymmetric: both sides
    return q, k, v, slopes, np.asarray(key_lens, np.int32), D ** -0.5


def jax_ring(q, k, v, slopes, key_lens, scale, S, **kw):
    mesh = make_mesh(data=8 // S, seq=S)
    kw = {k_: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for k_, x in kw.items()}
    return jax.jit(lambda q, k, v, s: ring_attention_sharded(
        q, k, v, s, jnp.asarray(key_lens), scale, mesh=mesh, axis_name="seq", **kw))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(slopes))


def port_ring(q, k, v, slopes, key_lens, scale, S, **kw):
    """The port's ring of S ranks on JAX-layout arrays (B, H, N, D)."""
    args = [torch.tensor(x).transpose(1, 2) if x.ndim == 4 else torch.tensor(x)
            for x in (q, k, v, slopes, key_lens)] if isinstance(q, np.ndarray) else [
        q, k, v, slopes, key_lens]
    kw = {k_: (torch.tensor(x) if isinstance(x, np.ndarray) else x) for k_, x in kw.items()}
    if S == 1:
        out = ring_attention(*args, scale, **kw)
    else:
        out = ring_attention_virtual(*args, scale, shards=S, **kw)
    return out.transpose(1, 2)


def close(got, ref, bound=1e-5, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= bound, f"{what}: {err:.3e} > {bound:.0e}"


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("hkv", [1, 4])
def test_ring_matches_jax(hkv, S):
    q, k, v, slopes, key_lens, scale = inputs(hkv)
    ref = jax_ring(q, k, v, slopes, key_lens, scale, S)
    close(port_ring(q, k, v, slopes, key_lens, scale, S), ref, what=f"hkv {hkv} S {S}")


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("offset", [0, 3])
def test_ring_causal_offset_and_q_lens_match_jax(offset, S):
    q, k, v, slopes, key_lens, scale = inputs(4, seed=1)
    q_lens = np.asarray([N, 41], np.int32)
    kw = dict(offset=offset, q_lens=q_lens, causal=True)
    ref = jax_ring(q, k, v, slopes, key_lens, scale, 4, **kw)
    got = port_ring(q, k, v, slopes, key_lens, scale, S, **kw)
    close(got, ref, what=f"offset {offset} S {S}")
    assert (got.numpy()[1, :, 41:] == 0).all()


@pytest.mark.parametrize("case", ["zero_slopes", "masked_row"])
def test_ring_zero_slopes_and_a_fully_masked_row_match_jax(case):
    key_lens = (N, 0) if case == "masked_row" else (N, N - 29)
    q, k, v, slopes, key_lens, scale = inputs(4, seed=3, key_lens=key_lens)
    if case == "zero_slopes":
        slopes = np.zeros_like(slopes)
    ref = jax_ring(q, k, v, slopes, key_lens, scale, 2)
    got = port_ring(q, k, v, slopes, key_lens, scale, 2)
    close(got, ref, what=case)
    if case == "masked_row":
        assert (got.numpy()[1] == 0).all()


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("hkv", [1, 4])
def test_ring_gradients_match_jax(hkv, remat):
    q, k, v, slopes, key_lens, scale = inputs(hkv, seed=2)
    q_lens = np.asarray([N, 50], np.int32)
    w = np.random.RandomState(9).randn(B, H, N, D).astype(np.float32)
    mesh = make_mesh(data=2, seq=4)

    def jloss(q, k, v, s):
        out = ring_attention_sharded(q, k, v, s, jnp.asarray(key_lens), scale, mesh=mesh,
                                     axis_name="seq", q_lens=jnp.asarray(q_lens),
                                     remat=remat)
        return jnp.sum(out * w)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(*map(jnp.asarray, (q, k, v, slopes)))
    for S in (1, 4):
        leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v, slopes)]
        out = port_ring(leaves[0].transpose(1, 2), leaves[1].transpose(1, 2),
                        leaves[2].transpose(1, 2), leaves[3], torch.tensor(key_lens), scale,
                        S, q_lens=torch.tensor(q_lens), remat=remat)
        (out * torch.tensor(w)).sum().backward()
        for name, leaf, r in zip(("dq", "dk", "dv", "dslopes"), leaves, ref):
            close(leaf.grad, r, what=f"{name} S {S}")


def test_ring_keep_mask_is_jax_keep_hash_bit_for_bit():
    """The ring's index ((b*HH + h)*N + row)*M + col over a data rank's rows
    and a model rank's heads, against ``_keep_hash`` over JAX's index."""
    seed, rate = 1234, 0.25
    thresh = dropout_thresh(rate)
    b0, h0, hh = 2, 2, 6
    rows, cols = np.arange(16, 48), np.arange(32, 64)
    got = ring_keep_mask(B, H, torch.tensor(rows), torch.tensor(cols),
                         torch.tensor([seed], dtype=torch.int32), thresh,
                         (b0, h0, hh, N, N)).numpy()
    bh = (b0 + np.arange(B))[:, None, None, None] * hh + (h0 + np.arange(H))[None, :, None, None]
    idx = (bh * N + rows[None, None, :, None]) * N + cols[None, None, None, :]
    ref = np.asarray(_keep_hash(jnp.asarray(idx, jnp.int32), jnp.asarray(seed, jnp.int32),
                                thresh))
    assert got.shape == ref.shape and (got == ref).all()
    assert 0.6 < got.mean() < 0.9


@pytest.mark.parametrize("hkv", [1, 4])
def test_ring_dropout_at_any_shard_count_equals_jax_at_4(hkv):
    q, k, v, slopes, key_lens, scale = inputs(hkv, seed=5)
    seed = np.asarray(1234, np.int32)
    ref = jax_ring(q, k, v, slopes, key_lens, scale, 4, dropout_rate=0.25,
                   dropout_seed=jnp.asarray(seed))
    nodrop = jax_ring(q, k, v, slopes, key_lens, scale, 4)
    assert np.abs(np.asarray(ref) - np.asarray(nodrop)).max() > 1e-2  # it drops
    for S in (1, 2, 4):
        got = port_ring(q, k, v, slopes, key_lens, scale, S, dropout_rate=0.25,
                        seed=torch.tensor([int(seed)], dtype=torch.int32))
        close(got, ref, what=f"dropout S {S}")


def _layers(flash, D_model=48, heads=4, dropout=0.0):
    torch.manual_seed(0)
    cfg = dict(dim=D_model, heads=heads, head_dim=64, one_kv_head=True, alibi_pos_bias=True,
               alibi_symmetric=False, dropout=dropout)
    ring = Attention(AttentionConfig(flash=flash, **cfg))
    off = Attention(AttentionConfig(flash="off", **cfg))
    off.load_state_dict(ring.state_dict())
    return ring.eval(), off.eval()


def test_attention_ring_on_a_named_seq_axis_of_size_1_equals_off():
    ring, off = _layers("ring")
    x = torch.randn(2, 32, 48, generator=torch.Generator().manual_seed(1))
    mask = torch.arange(32)[None] < torch.tensor([[32], [19]])
    calls = []
    import isp_tts_tpu_torch.nn.attention as pattn

    real = pattn.ring_attention
    pattn.ring_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        with parallel_context(seq_axis="seq"):
            out = ring(x, mask=mask)
        local = ring(x, mask=mask)  # no seq axis: the local kernels
    finally:
        pattn.ring_attention = real
    assert len(calls) == 1
    ref = off(x, mask=mask)
    close(out.detach(), ref.detach(), what="ring vs off")
    close(local.detach(), ref.detach(), what="local vs off")


def test_attention_ring_with_dropout_draws_like_every_seq_peer():
    """Train mode, dropout 0.3: the ring on a size-1 axis against the
    virtual ring of 2 on the same draws (the seed from the layer's
    generator, as each peer draws it)."""
    ring, _ = _layers("ring", dropout=0.3)
    ring.train()
    x = torch.randn(2, 32, 48, generator=torch.Generator().manual_seed(2))
    mask = torch.arange(32)[None] < torch.tensor([[32], [23]])
    outs = []
    import isp_tts_tpu_torch.nn.attention as pattn

    real = pattn.ring_attention
    for shards in (1, 2):
        pattn.ring_attention = (real if shards == 1 else
                                lambda *a, group=None, **k: ring_attention_virtual(
                                    *a, shards=2, **k))
        try:
            ring.dropout.generator = torch.Generator().manual_seed(7)
            with parallel_context(seq_axis="seq"):
                outs.append(ring(x, mask=mask).detach())
        finally:
            pattn.ring_attention = real
    close(outs[1], outs[0], what="virtual 2 vs 1")


def test_attention_ring_falls_back_once_with_a_warning(caplog):
    """A sequence that does not divide over the axis runs the local
    kernels, with one warning per layer."""
    from isp_tts_tpu_torch.parallel import mesh as pmesh

    ring, off = _layers("ring")
    x = torch.randn(1, 31, 48, generator=torch.Generator().manual_seed(3))
    layout = pmesh.make_mesh(data=1, seq=2, world_size=2)
    ctx = parallel_context(layout=layout, seq_axis="seq", groups={"seq": object()})
    with caplog.at_level(logging.WARNING, logger="isp_tts_tpu_torch"), ctx:
        out = ring(x)
        out2 = ring(x)
    warned = [r for r in caplog.records if "flash='ring'" in r.getMessage()]
    assert len(warned) == 1
    close(out.detach(), off(x).detach(), what="fallback")
    close(out2.detach(), out.detach(), bound=0, what="again")
