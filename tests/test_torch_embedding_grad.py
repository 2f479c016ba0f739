"""The port's token embedding (``nn/embeddings.py:Embedding``): the plain
lookup forward, and a weight gradient that sums each row's gradients in
float64 and gives the same bits on every call (PyTorch's CUDA embedding
backward adds repeated ids in a run-dependent order past 3072 ids)."""

import numpy as np
import pytest
import torch

from isp_tts_tpu_torch.nn.embeddings import Embedding

# (batch, tokens, padded tail, vocabulary, width): a few ids, and a recipe
# batch's 32 x 192 ids, most of them the padding id 0, at a narrow width
CASES = [(2, 7, 0, 5, 3), (4, 30, 10, 41, 16), (32, 192, 120, 41, 8)]


def _inputs(B, T, pad, V, D, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, V, (B, T))
    if pad:
        ids[:, T - pad:] = 0
    return (torch.from_numpy(ids), torch.from_numpy(rng.randn(V, D).astype(np.float32)),
            torch.from_numpy(rng.randn(B, T, D).astype(np.float32)))


@pytest.mark.parametrize("B,T,pad,V,D", CASES)
def test_weight_gradient_is_the_float64_row_sum_and_repeats(B, T, pad, V, D):
    ids, weight, g = _inputs(B, T, pad, V, D)
    emb = Embedding(V, D)
    emb.weight.data.copy_(weight)
    out = emb(ids)
    assert torch.equal(out, torch.nn.functional.embedding(ids, weight))
    out.backward(g)
    got = emb.weight.grad.clone()
    exact = torch.zeros(V, D, dtype=torch.float64).index_add_(
        0, ids.reshape(-1), g.reshape(-1, D).double())
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), exact, rtol=0, atol=1e-6 * exact.abs().max().item())
    for _ in range(3):
        emb.weight.grad = None
        emb(ids).backward(g)
        assert torch.equal(emb.weight.grad, got)


def test_without_a_gradient_it_is_the_plain_lookup():
    ids, weight, _ = _inputs(4, 30, 10, 41, 16)
    emb = Embedding(41, 16)
    emb.weight.data.copy_(weight)
    with torch.no_grad():
        out = emb(ids)
    assert out.grad_fn is None
    assert torch.equal(out, torch.nn.functional.embedding(ids, weight))


def test_refuses_the_options_it_does_not_take():
    with pytest.raises(ValueError):
        Embedding(5, 3, padding_idx=0)(torch.zeros(2, dtype=torch.long))
