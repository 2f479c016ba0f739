"""The attention forwards' plain versions on bf16 inputs against the JAX
package's Pallas kernels in interpret mode, on the CPU: K1 against
``_mqa_fwd`` (``_mqa_fwd_kernel``), K5a against ``_flash_fwd``
(``_fwd_kernel``).

The two TPU kernels round differently: ``_mqa_fwd_kernel`` rounds the
probabilities P to bf16 for P.V (f32 accumulate); ``_fwd_kernel`` runs P.V
in f32. The plain versions compute P.V in f32, and so, to 16 bits of P
(p_hi + p_lo), do both of the port's kernels on the card: K1's bf16
training step moved past its gate with the TPU kernel's rounding (PERF.md
§6). The K1 test pins that rounding: K1's arithmetic with P rounded to
bf16 is one output rounding from the TPU kernel, and the plain version
within the card's bf16 bound of it. Inputs come from numpy seeds; lengths
are ragged, with a key length and a query length of 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import isp_tts_tpu.ops.flash_attention as fa
from isp_tts_tpu.nn.embeddings import alibi_slopes
from isp_tts_tpu_torch.ops.flash_attention import (drop_params, flash_attention_reference,
                                                   mqa_attention_reference, mqa_keep_mask)

SCALE = 64 ** -0.5
SEED = 4242
# One bf16 rounding of the output apart, relative: the two sides' f32 sums
# run in another order, which can move an output across a rounding boundary.
ULP = 2.0 ** -7
# The plain K1 (P in f32) against the TPU kernel (P rounded to bf16, 2**-9
# relative per probability) and both outputs rounded to bf16: the bound the
# card holds the bf16 kernels to (chip_smoke.BF16_BOUND).
BF16_BOUND = 2e-2


def _inputs(B, N, M, H, kv_heads, key_lens, q_lens, seed=0):
    """bf16 q (B, N, H, 64), k/v (B, M, 64) or (B, M, Hkv, 64), asymmetric
    slopes (2, H), int32 lengths."""
    rng = np.random.RandomState(seed)
    kv = (B, M, 64) if kv_heads is None else (B, M, kv_heads, 64)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
               for shape in ((B, N, H, 64), kv, kv))
    sl = np.asarray(alibi_slopes(H), np.float32)
    slopes = torch.from_numpy(np.stack([sl, sl * 0.5 + 0.01]).astype(np.float32))
    return (q, k, v, slopes, torch.tensor(key_lens, dtype=torch.int32),
            torch.tensor(q_lens, dtype=torch.int32))


def _jax(x):
    """A torch tensor as a JAX array of the same dtype (bf16 or f32)."""
    a = jnp.asarray(x.float().numpy())
    return a.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else a


def _interpret(fn, *args):
    fa.INTERPRET = True
    try:
        return fn(*args)
    finally:
        fa.INTERPRET = False


def _assert_dead_rows_match(lse, lse_ref, o):
    """The same dead rows (lse +inf), and o = 0 on them (o's rows laid out
    as lse's)."""
    dead = np.isinf(lse_ref)
    np.testing.assert_array_equal(np.isinf(lse), dead)
    assert not o[dead].any()


def _p_rounded_k1(q, k, v, slopes, key_lens, q_lens, offset, causal, rate):
    """K1's arithmetic with P rounded to bf16 for P.V, as _mqa_fwd_kernel
    takes it: the normaliser sums the unrounded, undropped P."""
    B, N, H, _ = q.shape
    M = k.shape[1]
    n = torch.arange(N)[:, None]
    c = torch.arange(M)[None, :]
    dist = -(c - n - offset).abs().float()
    lower = c <= n + offset
    bias = torch.where(lower[:, None], slopes[0][None, :, None] * dist[:, None],
                       slopes[1][None, :, None] * dist[:, None])  # (N, H, M)
    s = torch.einsum("bnhd,bmd->bnhm", q.float(), k.float()) * SCALE + bias
    valid = (c[None] < key_lens[:, None, None])[:, :, None]  # (B, 1, 1, M)
    if causal:
        valid = valid & lower[None, :, None]
    s = s.masked_fill(~valid, fa.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * valid
    l = p.sum(-1, keepdim=True)
    drop = drop_params(rate)
    if drop is not None:
        keep = mqa_keep_mask(B, N, H, M, torch.tensor([SEED], dtype=torch.int32), drop[0])
        p = p * keep * drop[1]
    o = torch.einsum("bnhm,bmd->bnhd", p.bfloat16().float(), v.float()) / l.clamp_min(1e-30)
    live = (torch.arange(N)[None, :] < q_lens[:, None])[:, :, None, None] & (l > 0)
    return torch.where(live, o, 0.0).bfloat16()


K1_CASES = [  # B, N, M, H, offset, causal, rate, key_lens, q_lens
    (3, 40, 40, 6, 0, False, 0.1, [40, 0, 27], [40, 31, 0]),
    (3, 37, 45, 4, 0, False, 0.3, [45, 19, 0], [0, 37, 22]),
    (1, 24, 56, 6, 32, False, 0.1, [56], [24]),
    (2, 30, 30, 4, 0, True, 0.0, [30, 23], [30, 17]),
]


@pytest.mark.parametrize("B,N,M,H,offset,causal,rate,key_lens,q_lens", K1_CASES)
def test_plain_k1_bf16_matches_pallas_interpret(B, N, M, H, offset, causal, rate, key_lens,
                                                q_lens):
    q, k, v, slopes, kl, ql = _inputs(B, N, M, H, None, key_lens, q_lens)
    out, res = _interpret(fa._mqa_fwd, _jax(q), _jax(k), _jax(v), _jax(slopes),
                          jnp.asarray(kl.numpy()), jnp.asarray(ql.numpy()),
                          jnp.asarray([SEED], jnp.int32), SCALE, offset, fa.DEF_BLOCK_R,
                          fa.DEF_BLOCK_K_MQA, False, causal, rate)
    ref = np.asarray(out.astype(jnp.float32))
    seed = torch.tensor([SEED], dtype=torch.int32)
    o, lse = mqa_attention_reference(q, k, v, slopes, kl, SCALE, offset, ql, causal, rate,
                                     seed)
    assert o.dtype == torch.bfloat16
    o = o.float().numpy()
    _assert_dead_rows_match(lse.numpy(), np.asarray(res[-1]), o.reshape(B, N * H, 64))
    # the TPU kernel rounds P to bf16: the same arithmetic is one output
    # rounding away from it ...
    rounded = _p_rounded_k1(q, k, v, slopes, kl, ql, offset, causal, rate).float().numpy()
    assert (np.abs(rounded - ref) <= ULP * np.abs(ref) + 1e-6).all()
    # ... and the plain version, P in f32, within the card's bf16 bound
    np.testing.assert_allclose(o, ref, atol=BF16_BOUND, rtol=0)


K5A_CASES = [  # B, N, M, H, Hkv, offset, causal, rate, key_lens, q_lens
    (3, 40, 40, 4, 4, 0, False, 0.1, [40, 0, 27], [40, 31, 0]),
    (3, 37, 45, 6, 1, 0, False, 0.1, [45, 19, 0], [0, 37, 22]),
    (1, 24, 56, 3, 3, 32, True, 0.1, [56], [24]),
    (2, 30, 30, 2, 2, 0, False, 0.0, [30, 23], [30, 17]),
]


@pytest.mark.parametrize("B,N,M,H,Hkv,offset,causal,rate,key_lens,q_lens", K5A_CASES)
def test_plain_k5a_bf16_matches_pallas_interpret(B, N, M, H, Hkv, offset, causal, rate,
                                                 key_lens, q_lens):
    q, k, v, slopes, kl, ql = _inputs(B, N, M, H, Hkv, key_lens, q_lens)

    def heads_first(x):
        return _jax(x.permute(0, 2, 1, 3).contiguous())

    out, res = _interpret(fa._flash_fwd, heads_first(q), heads_first(k), heads_first(v),
                          _jax(slopes), jnp.asarray(kl.numpy()), jnp.asarray(ql.numpy()),
                          jnp.asarray([SEED], jnp.int32), SCALE, offset, 128, 128, causal,
                          rate)
    ref = np.asarray(out.astype(jnp.float32)).transpose(0, 2, 1, 3)
    o, lse = flash_attention_reference(q, k, v, slopes, kl, SCALE, offset, ql, causal, rate,
                                       torch.tensor([SEED], dtype=torch.int32))
    assert o.dtype == torch.bfloat16
    o = o.float().numpy()
    _assert_dead_rows_match(lse.numpy(), np.asarray(res[-1]), o.transpose(0, 2, 1, 3))
    # P.V in f32 on both sides: one output rounding apart
    assert (np.abs(o - ref) <= ULP * np.abs(ref) + 1e-6).all()
