"""The port's text front end and Synthesizer bucketing against the JAX
package's, on the CPU, plus the port Synthesizer's own serving behaviour."""

import types

import numpy as np
import pytest

from isp_tts_tpu.data.providers import TextProvider as JTextProvider
from isp_tts_tpu.data.providers import TextProviderConfig
from isp_tts_tpu.data.text.table import CodingTable as JCodingTable
from isp_tts_tpu.serving import Synthesizer as JSynthesizer
from isp_tts_tpu.serving import SynthesizerConfig as JSynthesizerConfig
from isp_tts_tpu_torch.checkpoint import load_checkpoint
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.data.providers import TextProvider
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
from isp_tts_tpu_torch.serving import Synthesizer, SynthesizerConfig, batch_bucket, bucket

CKPT = "docs/assets/scale_r5/acoustic_scratch10k_r5.f16.ckpt"

TEXTS = [
    "Hello world.",
    "  The quick   brown fox — jumps over the lazy dog!  ",
    "«Quoted» “text” with [brackets] {and} braces…",
    "..., leading punctuation? and trailing junk , .",
    "Numbers 123 and ünïcödé letters, plus #hash & <tags>.",
    "Mr. Smith went to Washington; he said: 'no'.",
    "",
]


@pytest.fixture(scope="module")
def encoding_map():
    return load_checkpoint(CKPT)["model"]["config"]["encoding_map"]


def _jax_provider(encoding_map):
    prov = JTextProvider(TextProviderConfig(charset=["<pad>"]))
    prov.coding_table = JCodingTable.from_encoding_map(encoding_map)
    return prov


@pytest.mark.parametrize("text", TEXTS)
def test_token_ids_match_jax_text_provider(encoding_map, text):
    ref = _jax_provider(encoding_map)(text)
    out = TextProvider(encoding_map)(text)
    np.testing.assert_array_equal(out, ref.vector)
    assert out.dtype == np.int32 and out.size == ref.vector_len


def test_bucket_choices_match_jax_synthesizer():
    jcfg = JSynthesizerConfig()
    cfg = SynthesizerConfig()
    fake = types.SimpleNamespace(config=jcfg, _ndev=1)
    for n in range(1, 257):
        for buckets in (cfg.text_buckets, cfg.frame_budgets):
            assert bucket(n, buckets) == JSynthesizer._bucket(fake, n, buckets)
    for n in range(1, 80):
        assert batch_bucket(n, cfg.batch_buckets) == JSynthesizer._batch_bucket(fake, n)
    with pytest.raises(ValueError):
        bucket(257, cfg.text_buckets)


def _tiny_synth(encoding_map, **cfg_kw):
    layer = {"attention": {"heads": 2, "head_dim": 64, "one_kv_head": True,
                           "alibi_pos_bias": True},
             "feed_forward": {"inner_dim": 64, "activation": "gelu"}}
    tr = {"dim": 32, "depth": 1, "transformer_layer": layer}
    cfg = build_config(AcousticModelConfig, {
        "encoding_map": encoding_map, "mel_dim": 8, "text_dim": 32,
        "encoder": tr, "decoder": tr,
        "temporal_adaptor": {"predictor": {"transformer": tr, "time_embedding_dim": 8},
                             "embedding": {"transformer": tr}, "soft_duration": True}})
    import torch

    torch.manual_seed(0)
    model = AcousticModel(cfg)
    return Synthesizer(model, SynthesizerConfig(**cfg_kw))


def test_prepare_pads_as_jax_synthesizer_does(encoding_map):
    synth = _tiny_synth(encoding_map)
    texts = TEXTS[:3]
    tokens, lens, fb, B = synth.prepare(texts, duration_factor=1.5)
    jprov = _jax_provider(encoding_map)
    enc = [jprov(x) for x in texts]
    max_len = max(e.vector_len for e in enc)
    jcfg = JSynthesizerConfig()
    fake = types.SimpleNamespace(config=jcfg, _ndev=1)
    assert tokens.shape == (JSynthesizer._batch_bucket(fake, 3),
                            JSynthesizer._bucket(fake, max_len, jcfg.text_buckets))
    assert fb == JSynthesizer._bucket(
        fake, min(int(max_len * jcfg.frames_per_token * 1.5), jcfg.frame_budgets[-1]),
        jcfg.frame_budgets)
    assert B == 3
    for i, e in enumerate(enc):
        np.testing.assert_array_equal(tokens[i, : e.vector_len], e.vector)
        assert (tokens[i, e.vector_len:] == 0).all() and lens[i] == e.vector_len
    assert (tokens[3:] == 0).all() and (lens[3:] == 1).all()  # one <pad> per pad row


def test_synthesizer_serves_and_retries_a_saturated_budget(encoding_map):
    import torch

    synth = _tiny_synth(encoding_map, frames_per_token=0.1)
    # long durations: every token asks for ~e^3 frames
    with torch.no_grad():
        synth.model.temporal_adaptor.predictor.linear.bias[0] = 3.0
    texts = ["Hello world.", "A second, longer sentence."]
    mel, dec_lens, B = synth._synthesize_mel(texts, seed=1)
    # the estimate picks budget 256; the durations need more, so it reran
    assert mel.shape[1] > 256 and dec_lens.max() > 256
    assert (0 < dec_lens).all() and (dec_lens < mel.shape[1]).all()
    mels = synth(texts, seed=1)
    assert len(mels) == 2
    for m, n in zip(mels, dec_lens):
        assert m.dtype == np.float32 and m.shape == (n, 8) and np.isfinite(m).all()
    again = synth(texts, seed=1)
    for a, b in zip(mels, again):
        np.testing.assert_array_equal(a, b)  # the seed fixes the noise


def test_entry_points_do_not_fall_back_to_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesizer.from_pretrained(CKPT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AcousticModel.from_pretrained(CKPT)
