"""A small acoustic model with the full-width run's head split, encoder
and decoder 12 heads x 32, the adaptor's predictor and feature embedding 2
heads x 128, the port against the JAX package on the CPU: ``infer`` with
injected durations and one float32 training step, dropout off (the JAX
model's CPU path draws its attention dropout from a PRNG key, not from the
hash); and a serving export with two head dims. The JAX parameters are
carried over with ``load_jax_state``; tolerances as
``test_torch_port_model.py`` and ``test_torch_port_train_step.py`` hold the
model at head dim 64.
"""

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
from isp_tts_tpu_torch.nn.attention import Attention
from torch_port_common import SMALL, assert_grads_match, flow_draws, jax_step, perturb, port_step, t


def _split_layer(layer: dict, heads: int, head_dim: int) -> dict:
    return dict(layer, attention=dict(layer["attention"], heads=heads, head_dim=head_dim))


#: SMALL with the full-width run's head split: encoder and decoder 12 heads x
#: 32, the adaptor's predictor and feature embedding 2 heads x 128
SPLIT = dict(
    SMALL,
    encoder=dict(SMALL["encoder"],
                 transformer_layer=_split_layer(SMALL["encoder"]["transformer_layer"], 12, 32)),
    decoder=dict(SMALL["decoder"],
                 transformer_layer=_split_layer(SMALL["decoder"]["transformer_layer"], 12, 32)),
    temporal_adaptor=dict(
        SMALL["temporal_adaptor"],
        predictor=dict(SMALL["temporal_adaptor"]["predictor"], transformer=dict(
            SMALL["temporal_adaptor"]["predictor"]["transformer"],
            transformer_layer=_split_layer(
                SMALL["temporal_adaptor"]["predictor"]["transformer"]["transformer_layer"],
                2, 128))),
        embedding=dict(SMALL["temporal_adaptor"]["embedding"], transformer=dict(
            SMALL["temporal_adaptor"]["embedding"]["transformer"],
            transformer_layer=_split_layer(
                SMALL["temporal_adaptor"]["embedding"]["transformer"]["transformer_layer"],
                2, 128)))))


def _split_pair(seed):
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, SPLIT), rngs=nnx.Rngs(0))
    perturb(jm, seed)
    # durations of ~exp(1.5) - 1 frames a token, so expansion has work to do
    b = jm.temporal_adaptor.predictor.linear.bias
    b.value = b.value.at[0].add(1.5)
    pm = AcousticModel(build_config(AcousticModelConfig, SPLIT))
    pm.load_jax_state(jm.state_dict())
    dims = {name: m.head_dim for name, m in pm.named_modules() if isinstance(m, Attention)}
    assert set(dims.values()) == {32, 128} and all(
        m.flash == "auto" for m in pm.modules() if isinstance(m, Attention))
    return jm, pm


def test_split_head_model_infer_with_injected_durations_matches():
    """``infer`` of the small model split as 12 x 32 / 2 x 128, durations
    fixed by the caller (-1 keeps the prediction), the same flow noise: the
    durations within 1e-5 relative and the mel within 1e-4, as
    ``test_torch_port_model.py`` holds the model at head dim 64."""
    jm, pm = _split_pair(17)
    jm.eval()
    pm.eval()
    rng = np.random.RandomState(1)
    lens = np.array([12, 9], np.int32)
    tokens = rng.randint(2, 11, size=(2, 16)).astype(np.int32)
    tokens[np.arange(16)[None, :] >= lens[:, None]] = 0
    durations = rng.randint(1, 6, size=(2, 16)).astype(np.float32)
    durations[0, 3] = -1.0
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, tokens.shape + (3,)))
    speaker = np.array([1, 0], np.int32)
    jmel, jad = jm.infer(jnp.asarray(tokens), text_lengths=jnp.asarray(lens),
                         max_dec_len=128, key=key, duration_target=jnp.asarray(durations),
                         speaker=jnp.asarray(speaker))
    with torch.no_grad():
        mel, ad = pm.infer(t(tokens).long(), text_lengths=t(lens), max_dec_len=128,
                           noise=t(noise), duration_target=t(durations),
                           speaker=t(speaker).long())
    np.testing.assert_array_equal(ad.dec_lengths.numpy(), np.asarray(jad.dec_lengths))
    assert (ad.dec_lengths.numpy() > 0).all()
    np.testing.assert_allclose(ad.duration.numpy(), np.asarray(jad.duration),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), atol=1e-4)


def test_split_head_model_training_step_matches():
    """One f32 training step of the split model, dropout off: every loss
    term within 1e-4 relative and every parameter gradient within 1e-3 of
    its max-abs, as ``test_torch_port_train_step.py`` holds the model at
    head dim 64."""
    jm, pm = _split_pair(12)
    rng = np.random.RandomState(13)
    B, T, M = 3, 12, 48
    text_len = np.array([12, 9, 6], np.int32)
    text = rng.randint(2, 11, size=(B, T)).astype(np.int32)
    text[np.arange(T)[None] >= text_len[:, None]] = 0
    inputs = {"text": text, "text_len": text_len,
              "mel": rng.randn(B, M, 16).astype(np.float32),
              "mel_len": np.array([48, 40, 30], np.int32),
              "pitch": rng.randn(B, M).astype(np.float32),
              "energy": rng.randn(B, M).astype(np.float32),
              "speaker": np.array([0, 1, 1], np.int32)}
    key = jax.random.PRNGKey(21)
    jl, jlosses, jgrads = jax_step(jm, inputs, key)
    x0, tt = flow_draws(key, B, T)
    pl, plosses = port_step(pm, inputs, x0, tt)
    assert set(plosses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(plosses[k], jlosses[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert_grads_match(jgrads, pm, 1e-3)


def test_export_names_each_head_dims_kernel_library(tmp_path):
    """A serving program exported on the CPU from a model with two head
    dims (12 in the encoder, 64 elsewhere) names the kernel library each
    of its attention nodes launches: the one-KV-head forward at tile widths
    16 and 64; the artifact serves what the live synthesizer does."""
    import copy

    import test_torch_port_export as tx
    from isp_tts_tpu_torch.export import (ExportedSynthesizer, export_serving,
                                          kernel_libraries, kernel_nodes)

    cfg = copy.deepcopy(tx.TINY64)
    cfg["encoder"]["transformer_layer"] = _split_layer(tx._LAYER, 4, 12)
    synth = tx.make_synth(cfg)
    path = tmp_path / "split.zip"
    export_serving(synth, path, tx.TB, tx.FB)
    ex = ExportedSynthesizer(path, device="cpu")
    assert kernel_nodes(tx.program(path)) == {"isp_tts.mqa_fwd.default": tx.ATTENTION_CALLS}
    assert ex.kernel_libraries == kernel_libraries(tx.program(path)) == [
        "mqa_fwd_d16", "mqa_fwd_d64"]
    np.testing.assert_allclose(ex(tx.TEXT, seed=1)[0], synth(tx.TEXT, seed=1)[0], atol=1e-6,
                               rtol=0)
