"""Text -> waveform through the port against the JAX package, on the CPU, and
the port Synthesizer's audio paths.

The slice as a whole: the committed acoustic model with JAX's flow noise
injected, then the committed vocoder on the padded mel, clipped and sliced,
through both packages; the waveforms agree to 5e-3 absolute (the full-width
mel alone is held to 2e-3) and their re-analysed mel L1 to 1e-2. The rest
holds the Synthesizer's behaviour: the audio path is the vocoder on the
padded mel (or, with no vocoder, the matmul Griffin-Lim), long-form
synthesis joins the sentences with pauses, the charset is checked against
the checkpoint, the phonemizer and the CPU fallback are refused.
"""

import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from isp_tts_tpu.models import AcousticModel as JAcousticModel
from isp_tts_tpu.models import VocoderModel as JVocoderModel
from isp_tts_tpu.ops.vocoder import log_mel_matmul as jlog_mel_matmul
from isp_tts_tpu.serving import Synthesizer as JSynthesizer
from isp_tts_tpu.serving import SynthesizerConfig as JSynthesizerConfig
from isp_tts_tpu.serving import split_sentences as jsplit_sentences
from isp_tts_tpu_torch import serving
from isp_tts_tpu_torch.checkpoint import load_checkpoint
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
from isp_tts_tpu_torch.models.vocoder import VocoderModel
from isp_tts_tpu_torch.ops.vocoder import log_mel_matmul, mel_to_audio_tpu
from isp_tts_tpu_torch.serving import Synthesizer, SynthesizerConfig, split_sentences
from torch_port_common import SMALL, t

CKPT = "docs/assets/scale_r5/acoustic_scratch10k_r5.f16.ckpt"
VOCODER = "docs/assets/scale_r5/vocoder_joint10k_r5.f16.ckpt"
CLI_CHARSET = ("<pad>", "</s>", "#punct", "#en")
TEXTS = ["The birch canoe slid away.", "It is easy to tell."]


@pytest.fixture(scope="module")
def jax_models():
    jm = JAcousticModel.from_pretrained(CKPT)
    jm.eval()
    jv = JVocoderModel.from_pretrained(VOCODER)
    jv.eval()
    return jm, jv


def _port_models():
    return (AcousticModel.from_pretrained(CKPT, device="cpu"),
            VocoderModel.from_pretrained(VOCODER, device="cpu"))


@pytest.fixture(scope="module")
def port_synth():
    pm, pv = _port_models()
    return Synthesizer(pm, vocoder=pv)


def _mel_l1(audio, mel):
    """Mean |log-mel of the waveform - the mel it was made from|."""
    return float(np.abs(np.asarray(log_mel_matmul(t(audio))) - mel).mean())


def test_audio_config_is_kept_from_the_checkpoint():
    model = AcousticModel.from_pretrained(CKPT, device="cpu")
    geo = model.config.audio_config
    assert geo == {"sample_rate": 22050, "n_fft": 1024, "hop_length": 256,
                   "win_length": 1024, "f_min": 0.0, "f_max": 8000.0}
    assert geo == load_checkpoint(CKPT)["model"]["config"]["audio_config"]
    features = load_checkpoint(VOCODER)["model"]["config"]["features"]
    assert geo == {k: v for k, v in features.items() if k != "n_mels"}


def test_text_to_waveform_matches_jax(jax_models, port_synth):
    jm, jv = jax_models
    tokens, lens, fb, B = port_synth.prepare(TEXTS)
    assert (tokens.shape, fb) == ((2, 32), 512)  # the serving buckets
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(key, tokens.shape + (3,)))
    jmel, jad = jm.infer(jnp.asarray(tokens), text_lengths=jnp.asarray(lens),
                         max_dec_len=fb, key=key)
    jaudio = np.asarray(jnp.clip(jv.infer(jmel), -1.0, 1.0))
    mel, ad = port_synth.model.infer(t(tokens).long(), text_lengths=t(lens),
                                     max_dec_len=fb, noise=t(noise))
    audio = port_synth._vocode(mel).numpy()
    dec = ad.dec_lengths.numpy()
    np.testing.assert_array_equal(dec, np.asarray(jad.dec_lengths))
    assert (dec > 50).all() and (dec < fb).all()
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), atol=2e-3)
    for i in range(B):
        n = int(dec[i]) * 256
        np.testing.assert_allclose(audio[i, :n], jaudio[i, :n], atol=5e-3)
        ref_mel = np.asarray(jmel)[i, : dec[i]]
        jl1 = float(np.abs(np.asarray(jlog_mel_matmul(jnp.asarray(jaudio[i, :n]))) - ref_mel).mean())
        assert abs(_mel_l1(audio[i, :n], ref_mel) - jl1) <= 1e-2
        assert jl1 < 0.5


def test_synthesize_audio_is_the_vocoder_on_the_padded_mel(port_synth):
    wavs = port_synth.synthesize_audio(TEXTS, seed=3)
    tokens, lens, fb, B = port_synth.prepare(TEXTS)
    gen = torch.Generator().manual_seed(3)
    mel, ad = port_synth.model.infer(t(tokens).long(), text_lengths=t(lens), max_dec_len=fb,
                                     generator=gen)
    ref = torch.clamp(port_synth.vocoder.infer(mel), -1, 1).numpy()
    assert len(wavs) == 2
    for i, w in enumerate(wavs):
        n = int(ad.dec_lengths[i]) * 256
        assert w.shape == (n,) and w.dtype == np.float32 and np.abs(w).max() <= 1.0
        np.testing.assert_array_equal(w, ref[i, :n])
    # the tail of a trimmed mel's waveform differs: the vocoder sees ~27
    # frames each side, so the padded mel is what the audio path vocodes
    n = int(ad.dec_lengths[0])
    trimmed = port_synth.vocoder.infer(mel[:1, :n]).numpy()[0]
    assert np.abs(trimmed[-256:] - ref[0, n * 256 - 256: n * 256]).max() > 1e-6


def test_synthesize_long_joins_the_sentences_with_pauses(port_synth):
    text = "  ".join(TEXTS) + " Glue the sheet!"
    parts = split_sentences(text)
    assert parts == TEXTS + ["Glue the sheet!"]
    long = port_synth.synthesize_long(text, seed=1, pause_s=0.25)
    wavs = port_synth.synthesize_audio(parts, seed=1)
    pause = np.zeros(int(0.25 * 22050), np.float32)
    np.testing.assert_array_equal(long, np.concatenate([wavs[0], pause, wavs[1], pause,
                                                        wavs[2]]))
    with pytest.raises(ValueError):
        port_synth.synthesize_long("   ")


@pytest.mark.parametrize("text", ["One. Two! Three? Four… five", "  no stop here ",
                                  "A.B. c. d!\n\ne?", "", "...!"])
def test_split_sentences_matches_jax(text):
    assert split_sentences(text) == jsplit_sentences(text)


def test_griffin_lim_path_without_a_vocoder():
    synth = Synthesizer(AcousticModel.from_pretrained(CKPT, device="cpu"))
    assert synth.sample_rate == 22050 and synth._hop_length() == 256
    (wav,) = synth.synthesize_audio(TEXTS[0], seed=2)
    tokens, lens, fb, _ = synth.prepare(TEXTS[:1])
    mel, ad = synth.model.infer(t(tokens).long(), text_lengths=t(lens), max_dec_len=fb,
                                generator=torch.Generator().manual_seed(2))
    ref = torch.clamp(mel_to_audio_tpu(mel), -1, 1).numpy()[0]
    n = int(ad.dec_lengths[0]) * 256
    assert wav.shape == (n,) and np.isfinite(wav).all()
    np.testing.assert_array_equal(wav, ref[:n])


def test_weights_dtype_bf16_matches_jax(jax_models):
    """JAX stores the served weights in bf16 and computes in f32: flax
    promotes each bf16 kernel against the f32 activations (its text
    embedding returns f32). The port stores the acoustic model in bf16 (half
    the bytes) and computes the same way: its mel within 1e-3 of the JAX
    Synthesizer's served (jitted) program, measured 9.4e-5 on the CPU. Two
    bf16 computations of this function, JAX's jitted and its op-by-op
    program, differ by 0.061 here: the bound sits well inside that. The
    vocoder stores its weights in bf16 too and computes in f32, as JAX's
    does: 1e-3."""
    jm, jv = jax_models
    pm, pv = _port_models()
    f32_bytes = [sum(p.numel() * p.element_size() for p in m.parameters()) for m in (pm, pv)]
    synth = Synthesizer(pm, SynthesizerConfig(weights_dtype="bf16"), vocoder=pv)
    for model, full in zip((synth.model, synth.vocoder), f32_bytes):
        params = list(model.parameters())
        assert all(p.dtype == torch.bfloat16 for p in params)
        assert 2 * sum(p.numel() * p.element_size() for p in params) == full
    jsynth = JSynthesizer(jm, JSynthesizerConfig(weights_dtype="bf16"), vocoder=jv)
    tokens, lens, fb, _ = synth.prepare(TEXTS[:1])
    key = jax.random.PRNGKey(0)
    noise = np.asarray(jax.random.normal(key, tokens.shape + (3,)))
    served = nnx.merge(jsynth._graphdef, jsynth._state)

    @nnx.jit
    def jax_served(m, tok, ln):
        return m.infer(tok, text_lengths=ln, max_dec_len=fb, key=key)[0]

    jmel16 = np.asarray(jax_served(served, jnp.asarray(tokens), jnp.asarray(lens)), np.float32)
    jmel16_eager = np.asarray(served.infer(jnp.asarray(tokens), text_lengths=jnp.asarray(lens),
                                           max_dec_len=fb, key=key)[0], np.float32)
    mel, _ = synth.model.infer(t(tokens).long(), text_lengths=t(lens), max_dec_len=fb,
                               noise=t(noise))
    assert mel.dtype == torch.float32
    err = np.abs(mel.numpy() - jmel16).max()
    control = np.abs(jmel16_eager - jmel16).max()
    assert err <= 1e-3 and err < 0.1 * control, (err, control)
    jmel = np.asarray(jm.infer(jnp.asarray(tokens), text_lengths=jnp.asarray(lens),
                               max_dec_len=fb, key=key)[0])
    jaudio = np.asarray(nnx.merge(jsynth._voc_graphdef, jsynth._voc_state).infer(jnp.asarray(jmel)))
    np.testing.assert_allclose(synth.vocoder.infer(t(jmel)).numpy(), jaudio, atol=1e-3)


def test_charset_is_checked_against_the_checkpoint(jax_models):
    pm = AcousticModel.from_pretrained(CKPT, device="cpu")
    synth = Synthesizer(pm, SynthesizerConfig(charset=CLI_CHARSET))
    ref = Synthesizer(pm)
    np.testing.assert_array_equal(synth.text_provider(TEXTS[0]), ref.text_provider(TEXTS[0]))
    wrong = ("<pad>", "</s>", "#en", "#punct")
    with pytest.raises(ValueError, match="encoding_map"):
        Synthesizer(pm, SynthesizerConfig(charset=wrong))
    with pytest.raises(ValueError, match="encoding_map"):
        JSynthesizer(jax_models[0], JSynthesizerConfig(charset=wrong))


@pytest.mark.parametrize("charset", [list(CLI_CHARSET), ["</s>", "#en", "<pad>", "<x>", "abca"],
                                     "#ru", ["#ipa_ph", "#marks"], ["#en", "#en", "</s>"]])
def test_coding_table_from_charset_matches_jax(charset):
    from isp_tts_tpu.data.text.table import CodingTable as JCodingTable
    from isp_tts_tpu_torch.data.text.table import CodingTable

    ref = JCodingTable.from_charset(charset).encoding_map
    assert list(CodingTable.from_charset(charset).encoding_map.items()) == list(ref.items())


def test_phonemizer_is_refused(monkeypatch):
    """With no espeak-ng (neither machine has it) and no injected backend,
    a phonemizing Synthesizer raises rather than serve graphemes. The
    package is hidden here, since other test files install a stand-in."""
    monkeypatch.setitem(sys.modules, "phonemizer", None)
    pm = AcousticModel.from_pretrained(CKPT, device="cpu")
    with pytest.raises(ImportError, match="phonemizer"):
        Synthesizer(pm, SynthesizerConfig(phonemizer=True))
    with pytest.raises(ImportError, match="phonemizer"):
        Synthesizer(pm, SynthesizerConfig(charset=CLI_CHARSET, phonemizer=True))


def test_no_cpu_fallback_without_a_card(monkeypatch):
    from isp_tts_tpu_torch import serving_server, synthesize

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesizer.from_pretrained(CKPT, vocoder_path=VOCODER)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VocoderModel.from_pretrained(VOCODER)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthesize.main(["--checkpoint", CKPT, "--text", "hi.", "--output", "/dev/null"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_server.main(["--checkpoint", CKPT])
    with pytest.raises(NotImplementedError, match="export"):
        serving_server.main(["--artifact", "a.zip"])
    # a vocoder on another device than the acoustic model is refused
    pm = AcousticModel.from_pretrained(CKPT, device="cpu")
    with pytest.raises(ValueError, match="the vocoder is on meta"):
        Synthesizer(pm, vocoder=VocoderModel(build_config(VocoderModel.Config, {})).to("meta"))


def test_vocoder_contract_mismatch_warns(caplog):
    pm = AcousticModel.from_pretrained(CKPT, device="cpu")
    small = dict(n_mels=80, dim=16, intermediate_dim=32, num_layers=1)
    other = VocoderModel(build_config(VocoderModel.Config, {
        "generator": small, "features": {"sample_rate": 24000}}))
    with caplog.at_level(logging.WARNING, logger="isp_tts_tpu_torch"):
        synth = Synthesizer(pm, vocoder=other)
    assert "sample_rate 24000 != acoustic 22050" in caplog.text
    assert synth.sample_rate == 24000
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="isp_tts_tpu_torch"):
        Synthesizer(pm, vocoder=VocoderModel(build_config(VocoderModel.Config,
                                                          {"generator": small})))
    assert "contract" not in caplog.text


def test_default_geometry_without_audio_config(caplog):
    torch.manual_seed(0)
    model = AcousticModel(build_config(AcousticModelConfig, SMALL)).eval()
    synth = Synthesizer(model, SynthesizerConfig(text_buckets=(16,), frame_budgets=(32, 64),
                                                 frames_per_token=2.0, steps=1))
    with caplog.at_level(logging.WARNING, logger="isp_tts_tpu_torch"):
        (wav,) = synth.synthesize_audio("abc", seed=0)
    assert "no audio_config" in caplog.text
    assert synth._audio_geometry() == serving.DEFAULT_AUDIO_GEOMETRY
    assert np.isfinite(wav).all() and wav.size % 256 == 0


def test_warmup_runs_every_bucket_and_speaker_variant(monkeypatch):
    torch.manual_seed(0)
    model = AcousticModel(build_config(AcousticModelConfig, SMALL)).eval()
    synth = Synthesizer(model, SynthesizerConfig(text_buckets=(8, 16), frame_budgets=(32, 64),
                                                 steps=1))
    calls = []
    real_infer, real_vocode = synth._infer, synth._vocode
    monkeypatch.setattr(synth, "_infer", lambda tok, lens, fb, spk, seed, *a: calls.append(
        ("infer", tuple(tok.shape), fb, spk is not None)) or real_infer(tok, lens, fb, spk, seed))
    monkeypatch.setattr(synth, "_vocode", lambda mel: calls.append(
        ("vocode", tuple(mel.shape))) or real_vocode(mel))
    synth.warmup(batch_sizes=(1, 3))
    infers = {c[1:] for c in calls if c[0] == "infer"}
    assert infers == {((b, tb), fb, s) for b in (1, 4) for tb in (8, 16) for fb in (32, 64)
                      for s in (False, True)}
    assert not any(c[0] == "vocode" for c in calls)  # no neural vocoder: audio off
    calls.clear()
    synth.warmup(audio=True)
    assert sum(c[0] == "vocode" for c in calls) == 8
