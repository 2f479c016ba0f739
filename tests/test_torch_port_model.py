"""The port's AcousticModel.infer against the JAX package's, on the CPU.

The JAX model is built (small, random) or loaded (the committed checkpoint),
its parameters are carried over with ``load_jax_state``, and both run
``infer`` on the same tokens with the flow noise drawn as the JAX predictor
draws it (``jax.random.normal(key, (B, T, features))``) and handed to the
port. float32 on both sides. Durations are exp of the flow output, so they
are compared relatively (1e-5, float32 rounding through exp); where the
durations are predicted, the soft path's alignment follows them, so the mel
is held to 1e-3, and where they are injected, to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import nnx

from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.data.providers import TextProvider as JTextProvider
from isp_tts_tpu.data.providers import TextProviderConfig
from isp_tts_tpu.data.text.table import CodingTable as JCodingTable
from isp_tts_tpu.models import AcousticModel as JAcousticModel
from isp_tts_tpu.models.acoustic.model import AcousticModelConfig as JAcousticModelConfig
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
from torch_port_common import jax_flat, perturb, t

CKPT = "docs/assets/scale_r5/acoustic_scratch10k_r5.f16.ckpt"

_LAYER = {"attention": {"heads": 2, "head_dim": 64, "one_kv_head": True,
                        "alibi_pos_bias": True},
          "feed_forward": {"inner_dim": 128, "activation": "gelu"}}
SMALL = {
    "encoding_map": {c: i for i, c in enumerate(["<pad>", "</s>", *"abcdefgh "])},
    "mel_dim": 16,
    "text_dim": 64,
    "encoder": {"dim": 64, "depth": 2, "transformer_layer": _LAYER},
    "decoder": {"dim": 64, "depth": 2, "transformer_layer": _LAYER},
    "temporal_adaptor": {
        "predictor": {"transformer": {"dim": 64, "depth": 2, "transformer_layer": dict(
            _LAYER, attention=dict(_LAYER["attention"], heads=3, alibi_symmetric=False))},
            "time_embedding_dim": 16},
        "embedding": {"transformer": {"dim": 64, "depth": 1, "transformer_layer": _LAYER}},
        "pitch": True, "energy": True},
    "aligner": {"attention_dim": 8, "key_kernel_size": 3, "query_kernel_size": 3},
    "num_speakers": 2,
}


def _pair(soft_duration):
    cfg = dict(SMALL, temporal_adaptor=dict(SMALL["temporal_adaptor"],
                                            soft_duration=soft_duration))
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, cfg), rngs=nnx.Rngs(0))
    jm.eval()
    perturb(jm, 11)
    # durations of ~exp(1.5) - 1 frames a token, so expansion has work to do
    b = jm.temporal_adaptor.predictor.linear.bias
    b.value = b.value.at[0].add(1.5)
    pm = AcousticModel(build_config(AcousticModelConfig, cfg))
    pm.load_jax_state(jm.state_dict())
    return jm, pm.eval()


def _compare(jm, pm, tokens, lens, budget, seed, atol, **controls):
    key = jax.random.PRNGKey(seed)
    noise = np.asarray(jax.random.normal(key, tokens.shape + (3,)))
    jmel, jad = jm.infer(jnp.asarray(tokens), text_lengths=jnp.asarray(lens),
                         max_dec_len=budget, key=key,
                         **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                            for k, v in controls.items()})
    mel, ad = pm.infer(t(tokens).long(), text_lengths=t(lens), max_dec_len=budget,
                       noise=t(noise),
                       **{k: t(v) if isinstance(v, np.ndarray) else v
                          for k, v in controls.items()})
    np.testing.assert_array_equal(ad.dec_lengths.numpy(), np.asarray(jad.dec_lengths))
    np.testing.assert_allclose(ad.duration.numpy(), np.asarray(jad.duration),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), atol=atol)
    return ad


@pytest.mark.parametrize("soft_duration", [True, False])
def test_small_infer_matches(soft_duration):
    jm, pm = _pair(soft_duration)
    rng = np.random.RandomState(0)
    lens = np.array([13, 7, 10], np.int32)
    tokens = rng.randint(2, 11, size=(3, 16)).astype(np.int32)
    tokens[np.arange(16)[None, :] >= lens[:, None]] = 0
    ad = _compare(jm, pm, tokens, lens, 96, 0, 1e-3, speaker=np.array([0, 1, 1]),
                  pitch_factor=1.1, energy_delta=0.2)
    assert (ad.dec_lengths.numpy() > 0).all()


@pytest.mark.parametrize("soft_duration", [True, False])
def test_small_infer_with_injected_durations_matches(soft_duration):
    """Durations fixed by the caller (-1 keeps the prediction): no rounding
    flip at a .5 boundary can stand in for, or hide, a mel difference."""
    jm, pm = _pair(soft_duration)
    rng = np.random.RandomState(1)
    lens = np.array([12, 9], np.int32)
    tokens = rng.randint(2, 11, size=(2, 16)).astype(np.int32)
    tokens[np.arange(16)[None, :] >= lens[:, None]] = 0
    durations = rng.randint(1, 6, size=(2, 16)).astype(np.float32)
    durations[0, 3] = -1.0
    _compare(jm, pm, tokens, lens, 128, 3, 1e-4, duration_target=durations,
             duration_factor=1.3)


def test_full_width_checkpoint_matches():
    """The committed 23M-parameter checkpoint through both packages: one
    sentence, text bucket 32, frame budget 256. The tolerance covers float32
    rounding through 6 + 3x4 + 1 + 6 layers of width 384."""
    jm = JAcousticModel.from_pretrained(CKPT)
    jm.eval()
    pm = AcousticModel.from_pretrained(CKPT, device="cpu")
    prov = JTextProvider(TextProviderConfig(charset=["<pad>"]))
    prov.coding_table = JCodingTable.from_encoding_map(jm.encoding_map)
    enc = prov("The birch canoe slid away.")
    tokens = np.zeros((1, 32), np.int32)
    tokens[0, : enc.vector_len] = enc.vector
    lens = np.array([enc.vector_len], np.int32)
    ad = _compare(jm, pm, tokens, lens, 256, 0, 2e-3)
    assert 0 < int(ad.dec_lengths[0]) < 256
    # the carry used every parameter the JAX model serves with
    assert len(jax_flat(jm)) == len(pm.state_dict()) + sum(
        k.startswith("aligner.") for k in jax_flat(jm))
