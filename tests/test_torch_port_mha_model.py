"""A small acoustic model with one key/value head per query head in every
attention layer, the port against the JAX package on the CPU: ``infer``
with the same noise, and one float32 training step's loss terms and
gradients, both with dropout off (the JAX layer's CPU path draws its
attention dropout from a PRNG key, not from the hash). Then the same model
with its key/value heads replicated from a one-KV-head model, which must
compute what that model computes."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.models import AcousticModel as JAcousticModel
from isp_tts_tpu.models.acoustic.model import AcousticModelConfig as JAcousticModelConfig
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
from torch_port_common import (SMALL, SMALL_MHA, assert_grads_match, attention_heads,
                               flow_draws, jax_step, perturb, port_step,
                               replicate_kv_heads, t)


def _pair():
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, SMALL_MHA), rngs=nnx.Rngs(0))
    perturb(jm, 14)
    # durations of ~exp(1.5) - 1 frames a token, so expansion has work to do
    b = jm.temporal_adaptor.predictor.linear.bias
    b.value = b.value.at[0].add(1.5)
    pm = AcousticModel(build_config(AcousticModelConfig, SMALL_MHA))
    pm.load_jax_state(jm.state_dict())
    assert pm.encoder.layers[0].attention.to_kv.weight.shape == (2 * 2 * 64, 64)
    return jm, pm


def _batch(seed):
    rng = np.random.RandomState(seed)
    B, T, M = 3, 12, 48
    text_len = np.array([12, 9, 6], np.int32)
    text = rng.randint(2, 11, size=(B, T)).astype(np.int32)
    text[np.arange(T)[None] >= text_len[:, None]] = 0
    return {"text": text, "text_len": text_len,
            "mel": rng.randn(B, M, 16).astype(np.float32),
            "mel_len": np.array([48, 40, 30], np.int32),
            "pitch": rng.randn(B, M).astype(np.float32),
            "energy": rng.randn(B, M).astype(np.float32),
            "speaker": np.array([0, 1, 1], np.int32)}


def _module_norms(named):
    """{top-level module: gradient norm} of (name, gradient) pairs."""
    sq = {}
    for name, g in named:
        top = name.split(".")[0]
        sq[top] = sq.get(top, 0.0) + float((np.asarray(g, np.float64) ** 2).sum())
    return {k: np.sqrt(v) for k, v in sq.items()}


def test_small_multi_kv_head_model_infer_matches():
    """infer with the same noise: durations 1e-5 relative (f32 through
    exp), the mel 1e-3 (the soft path's alignment follows the predicted
    durations), as tests/test_torch_port_model.py holds the MQA model."""
    jm, pm = _pair()
    jm.eval()
    pm.eval()
    rng = np.random.RandomState(0)
    lens = np.array([13, 7, 10], np.int32)
    tokens = rng.randint(2, 11, size=(3, 16)).astype(np.int32)
    tokens[np.arange(16)[None, :] >= lens[:, None]] = 0
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(key, tokens.shape + (3,)))
    speaker = np.array([0, 1, 1], np.int32)
    jmel, jad = jm.infer(jnp.asarray(tokens), text_lengths=jnp.asarray(lens),
                         max_dec_len=96, key=key, speaker=jnp.asarray(speaker))
    with torch.no_grad():
        mel, ad = pm.infer(t(tokens).long(), text_lengths=t(lens), max_dec_len=96,
                           noise=t(noise), speaker=t(speaker).long())
    np.testing.assert_array_equal(ad.dec_lengths.numpy(), np.asarray(jad.dec_lengths))
    assert ad.dec_lengths.numpy().sum() > 0
    np.testing.assert_allclose(ad.duration.numpy(), np.asarray(jad.duration),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), atol=1e-3)


def test_small_multi_kv_head_training_step_matches():
    """One f32 training step: every loss term within 1e-4 relative, each
    top-level module's gradient norm within 1e-3 relative and every
    parameter's gradient within 1e-3 of its max-abs."""
    jm, pm = _pair()
    inputs = _batch(13)
    key = jax.random.PRNGKey(21)
    jl, jlosses, jgrads = jax_step(jm, inputs, key)
    x0, tt = flow_draws(key, 3, 12)
    pl, plosses = port_step(pm, inputs, x0, tt)
    assert set(plosses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(plosses[k], jlosses[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    ref = _module_norms(jgrads.items())
    ours = _module_norms((n, p.grad.numpy()) for n, p in pm.named_parameters())
    assert set(ours) == set(ref)
    for top in ref:
        np.testing.assert_allclose(ours[top], ref[top], rtol=1e-3, err_msg=top)
    assert_grads_match(jgrads, pm, 1e-3)


def test_replicated_kv_heads_compute_the_one_kv_head_model():
    """A multi-KV-head model whose K/V heads are the one-KV-head model's,
    tiled H times, on the plain path: infer gives the same mel, and one
    training step the same loss terms, the same gradients elsewhere, and a
    ``to_kv`` gradient whose H head blocks sum to the one-KV-head one
    (float32, 1e-5 relative / of the max-abs)."""
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, SMALL), rngs=nnx.Rngs(0))
    flat = perturb(jm, 15)
    mqa = AcousticModel(build_config(AcousticModelConfig, SMALL))
    mqa.load_jax_state(flat)
    mha = AcousticModel(build_config(AcousticModelConfig, SMALL_MHA))
    heads = attention_heads(mha)
    assert len(heads) == 7  # 2 encoder + 2 predictor + 1 embedding + 2 decoder layers
    mha.load_jax_state(replicate_kv_heads(flat, heads))

    rng = np.random.RandomState(1)
    lens = np.array([12, 8], np.int32)
    tokens = rng.randint(2, 11, size=(2, 14)).astype(np.int32)
    tokens[np.arange(14)[None, :] >= lens[:, None]] = 0
    noise = t(rng.randn(2, 14, 3).astype(np.float32))
    with torch.no_grad():
        mels = [m.eval().infer(t(tokens).long(), text_lengths=t(lens), max_dec_len=64,
                               noise=noise, speaker=torch.tensor([1, 0]))[0]
                for m in (mqa, mha)]
    np.testing.assert_allclose(mels[1].numpy(), mels[0].numpy(), atol=1e-5)

    inputs = _batch(16)
    x0, tt = flow_draws(jax.random.PRNGKey(3), 3, 12)
    losses = [port_step(m.train(), inputs, x0, tt)[1] for m in (mqa, mha)]
    for k in losses[0]:
        np.testing.assert_allclose(losses[1][k], losses[0][k], rtol=1e-5, err_msg=k)
    mqa_grads = dict(mqa.named_parameters())
    for name, p in mha.named_parameters():
        ref = mqa_grads[name].grad
        g = p.grad
        if name.endswith("to_kv.weight"):  # (2*H*D, dim): K heads, then V heads
            H = heads[name[: -len(".to_kv.weight")]]
            g = g.reshape(2, H, -1, g.shape[-1]).sum(dim=1).reshape(ref.shape)
        scale = ref.abs().max().item()
        assert (g - ref).abs().max().item() <= 1e-5 * max(scale, 1e-12), name
