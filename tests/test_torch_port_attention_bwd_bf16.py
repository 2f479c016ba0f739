"""The attention backwards' plain versions on bf16 inputs against the JAX
package's Pallas kernels in interpret mode, on the CPU: K2 against
``jax.grad`` through ``flash_attention_mqa`` (``_mqa_dfused_kernel``), K5b
against ``jax.grad`` through ``flash_attention`` (``_dq_kernel`` +
``_dkv_kernel``); and why the bf16 slope gradient is held to the plain
backward fed the kernel's own saved o and lse, not to autograd through the
plain forward.

Both TPU backwards take their residual o in the input dtype (bf16 here) and
compute delta = rowsum(dO * O) from it, as the plain backwards and the
card's kernels do; the plain backwards are fed the JAX forward's saved o
and lse, so the comparison sees the backward arithmetic alone. K5b's TPU
kernels run their products in f32, as the plain version does; K2's
``_mqa_dfused_kernel`` rounds p and ds to bf16 for its products, the plain
version and the card's kernel keep them to ~2^-17 (hi + lo). Inputs come
from numpy seeds; lengths are ragged, with a key length and a query length
of 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isp_tts_tpu.ops.flash_attention as fa
from isp_tts_tpu.nn.embeddings import alibi_slopes
from isp_tts_tpu_torch.ops.flash_attention import (flash_attention_reference,
                                                   flash_bwd_reference,
                                                   mqa_attention_reference, mqa_bwd_reference)

SCALE = 64 ** -0.5
SEED = 4242
# One bf16 rounding of a gradient apart, relative: the two sides' f32 sums
# run in another order, which can move a value across a rounding boundary.
ULP = 2.0 ** -7
# f32 sums in another order, over a few thousand terms with cancellation:
# the slope gradient, f32 on both sides, relative to its max-abs.
F32_SUM = 1e-5
# The plain K2 (p and ds to ~2^-17) against _mqa_dfused_kernel (p and ds
# rounded to bf16, 2^-9 relative each, before its dv, dq and dk products),
# outputs rounded to bf16: the bound the card holds the bf16 kernels to.
BF16_BOUND = 2e-2


def _inputs(B, N, M, H, kv_heads, key_lens, q_lens, seed=0):
    """bf16 q (B, N, H, 64), k/v (B, M, 64) or (B, M, Hkv, 64), dO like q,
    asymmetric slopes (2, H), int32 lengths."""
    rng = np.random.RandomState(seed)
    kv = (B, M, 64) if kv_heads is None else (B, M, kv_heads, 64)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
                   for shape in ((B, N, H, 64), kv, kv, (B, N, H, 64)))
    sl = np.asarray(alibi_slopes(H), np.float32)
    slopes = torch.from_numpy(np.stack([sl, sl * 0.5 + 0.01]).astype(np.float32))
    return (q, k, v, do, slopes, torch.tensor(key_lens, dtype=torch.int32),
            torch.tensor(q_lens, dtype=torch.int32))


def _jax(x):
    """A torch tensor as a JAX array of the same dtype (bf16 or f32)."""
    a = jnp.asarray(x.float().numpy())
    return a.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else a


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dtype)


def _interpret(fn, *args):
    fa.INTERPRET = True
    try:
        return fn(*args)
    finally:
        fa.INTERPRET = False


def _rel(a, b):
    """max |a - b| / max |b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def _one_rounding_apart(a, b):
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= ULP * b.abs() + 1e-6).all())


K2_CASES = [  # B, N, M, H, offset, causal, rate, key_lens, q_lens
    (3, 40, 40, 6, 0, False, 0.1, [40, 0, 27], [40, 31, 0]),
    (3, 64, 64, 4, -5, True, 0.1, [64, 0, 50], [64, 47, 0]),
    (2, 24, 56, 6, 32, False, 0.0, [56, 30], [24, 17]),
]


@pytest.mark.parametrize("B,N,M,H,offset,causal,rate,key_lens,q_lens", K2_CASES)
def test_plain_k2_bf16_matches_jax_grad_through_pallas(B, N, M, H, offset, causal, rate,
                                                       key_lens, q_lens):
    q, k, v, do, slopes, kl, ql = _inputs(B, N, M, H, None, key_lens, q_lens)
    seed = jnp.asarray([SEED], jnp.int32)
    kl_j, ql_j = jnp.asarray(kl.numpy()), jnp.asarray(ql.numpy())

    def loss(q_, k_, v_, s_):
        o = fa.flash_attention_mqa(q_, k_, v_, s_, kl_j, SCALE, offset, q_lens=ql_j,
                                   causal=causal, dropout_rate=rate,
                                   dropout_seed=seed if rate else None)
        return jnp.sum(o.astype(jnp.float32) * _jax(do).astype(jnp.float32))

    out, res = _interpret(fa._mqa_fwd, _jax(q), _jax(k), _jax(v), _jax(slopes), kl_j, ql_j,
                          seed, SCALE, offset, fa.DEF_BLOCK_R, fa.DEF_BLOCK_K_MQA, False,
                          causal, rate)
    ref = _interpret(jax.grad(loss, argnums=(0, 1, 2, 3)), _jax(q), _jax(k), _jax(v),
                     _jax(slopes))
    # the JAX forward's saved o (bf16) and lse, as its backward reads them
    o, lse = _torch(out, torch.bfloat16), _torch(res[-1]).reshape(B, N * H)
    got = mqa_bwd_reference(q, k, v, slopes, kl, ql, torch.tensor([SEED], dtype=torch.int32),
                            o, lse, do, SCALE, offset, causal, rate)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert _rel(a, _torch(b)) <= BF16_BOUND, name
    # the slope gradient takes the f32 ds on both sides, delta on the same o
    assert _rel(got[3], _torch(ref[3])) <= F32_SUM


K5B_CASES = [  # B, N, M, H, Hkv, offset, causal, rate, key_lens, q_lens
    (3, 40, 40, 4, 4, 0, False, 0.1, [40, 0, 27], [40, 31, 0]),
    (3, 40, 40, 4, 1, 0, False, 0.1, [40, 0, 27], [40, 31, 0]),
    (3, 64, 64, 4, 4, -5, True, 0.1, [64, 0, 50], [64, 47, 0]),
    (3, 64, 64, 4, 1, -5, True, 0.1, [64, 0, 50], [64, 47, 0]),
]


@pytest.mark.parametrize("B,N,M,H,Hkv,offset,causal,rate,key_lens,q_lens", K5B_CASES)
def test_plain_k5b_bf16_matches_jax_grad_through_pallas(B, N, M, H, Hkv, offset, causal, rate,
                                                        key_lens, q_lens):
    q, k, v, do, slopes, kl, ql = _inputs(B, N, M, H, Hkv, key_lens, q_lens)
    seed = jnp.asarray([SEED], jnp.int32)
    kl_j, ql_j = jnp.asarray(kl.numpy()), jnp.asarray(ql.numpy())

    def heads_first(x):
        return _jax(x.permute(0, 2, 1, 3).contiguous())

    def loss(q_, k_, v_, s_):
        o = fa.flash_attention(q_, k_, v_, s_, kl_j, SCALE, offset, block_q=128, block_k=128,
                               q_lens=ql_j, causal=causal, dropout_rate=rate,
                               dropout_seed=seed if rate else None)
        return jnp.sum(o.astype(jnp.float32) * heads_first(do).astype(jnp.float32))

    out, res = _interpret(fa._flash_fwd, heads_first(q), heads_first(k), heads_first(v),
                          _jax(slopes), kl_j, ql_j, seed, SCALE, offset, 128, 128, causal, rate)
    ref = _interpret(jax.grad(loss, argnums=(0, 1, 2, 3)), heads_first(q), heads_first(k),
                     heads_first(v), _jax(slopes))
    o = _torch(out, torch.bfloat16).permute(0, 2, 1, 3).contiguous()
    lse = _torch(res[-1]).reshape(B, H, N)
    got = flash_bwd_reference(q, k, v, slopes, kl, ql, torch.tensor([SEED], dtype=torch.int32),
                              o, lse, do, SCALE, offset, causal, rate)
    # f32 products on both sides: one bf16 rounding of each gradient apart
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert _one_rounding_apart(a, _torch(b).permute(0, 2, 1, 3)), name
    assert _rel(got[3], _torch(ref[3])) <= F32_SUM


DELTA_CASES = [  # B, N, M, H, Hkv (None: K2), offset, causal
    (4, 300, 300, 4, 4, -5, True),
    (4, 320, 320, 6, 1, 0, False),
    (4, 320, 320, 6, None, 0, False),
]


@pytest.mark.parametrize("B,N,M,H,Hkv,offset,causal", DELTA_CASES)
def test_bf16_o_moves_the_slope_gradient_through_delta(B, N, M, H, Hkv, offset, causal):
    """From an f32 o the plain backward is autograd through the plain
    forward to f32 rounding (1e-4 of max-abs); from the same o rounded to
    bf16, as the forward kernels and the TPU kernels save it, dslopes moves
    by far more: delta = rowsum(dO * O) shifts by O's rounding, and dslopes
    is a sum with cancellation of ds * dist. So a bf16 kernel's dslopes is
    held to the plain backward on its own saved o, not to autograd."""
    rng = np.random.RandomState(1)
    kv = (B, M, 64) if Hkv is None else (B, M, Hkv, 64)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16().float()
                   for shape in ((B, N, H, 64), kv, kv, (B, N, H, 64)))
    sl = np.asarray(alibi_slopes(H), np.float32)
    slopes = torch.from_numpy(np.stack([sl, sl * 0.5]))
    kl = torch.tensor([M, 0] + [M // 2 + 3] * (B - 2), dtype=torch.int32)
    ql = torch.tensor([N, N // 2 + 1, 0, N - 3], dtype=torch.int32)
    seed = torch.tensor([29], dtype=torch.int32)
    fwd, bwd = ((mqa_attention_reference, mqa_bwd_reference) if Hkv is None
                else (flash_attention_reference, flash_bwd_reference))
    args = [x.clone().requires_grad_() for x in (q, k, v, slopes)]
    o, _ = fwd(*args, kl, SCALE, offset, ql, causal, 0.1, seed)
    (o * do).sum().backward()
    auto = [a.grad for a in args]
    o, lse = fwd(q, k, v, slopes, kl, SCALE, offset, ql, causal, 0.1, seed)
    assert o.dtype == torch.float32
    from_f32 = bwd(q, k, v, slopes, kl, ql, seed, o, lse, do, SCALE, offset, causal, 0.1)
    from_bf16 = bwd(q, k, v, slopes, kl, ql, seed, o.bfloat16(), lse, do, SCALE, offset,
                    causal, 0.1)
    f32_errs = [_rel(a, b) for a, b in zip(from_f32, auto)]
    bf16_errs = [_rel(a, b) for a, b in zip(from_bf16, auto)]
    assert max(f32_errs) <= 1e-4, f32_errs
    # dq, dk and dv stay within the bf16 bound; dslopes moves by more than
    # a hundred times its f32 reading
    assert max(bf16_errs[:3]) <= BF16_BOUND, bf16_errs
    assert bf16_errs[3] > 100 * f32_errs[3] and bf16_errs[3] > 1e-3, (f32_errs, bf16_errs)
