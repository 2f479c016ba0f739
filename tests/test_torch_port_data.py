"""The port's data pipeline against the JAX package's, on the CPU: the
dataset, collator and loader through the batched front end and through
the per-utterance providers, the statistics scan, YIN, the feature cache
and the text cleaners. Synthesized WAVs (seeded numpy), as the JAX
package's end-to-end tests make them.

Tolerances: token ids, lengths, shapes and batch membership exactly equal
under the same seed and epoch; mel within 1e-3 absolute; energy within
1e-3 relative; pitch voiced/unvoiced agreeing on at least 99% of frames
and within 1e-3 relative where both are voiced (YIN picks a discrete lag,
which may flip near the threshold); statistics within 1e-3 relative.
"""

import numpy as np
import pytest
import torch

from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.config import load_recipe
from isp_tts_tpu.data.audio import write_wav
from isp_tts_tpu.data.collator import AcousticCollator as JCollator
from isp_tts_tpu.data.dataset import AcousticDataset as JDataset
from isp_tts_tpu.data.loader import DataLoader as JLoader
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.data.collator import AcousticCollator
from isp_tts_tpu_torch.data.dataset import AcousticDataset
from isp_tts_tpu_torch.data.loader import DataLoader

SR = 22050
TEXTS = ["Hello there, Dr. Smith.", "Nice day!", "How are you?", "Fine, thanks.",
         "Testing “quotes” – and dashes…", "One two three.", "Red, blue, green.",
         "The end.", "Mr. Jones arrived at St. Paul's.", "Is it (really) so?",
         "Yes; no: maybe.", "A longer sentence with several words in it."]
STATS = {"pitch": {"mean": 170.0, "std": 40.0}, "energy": {"mean": 0.0, "std": 1.0}}


def utterance(i: int, rng) -> np.ndarray:
    """Voiced harmonics with a gliding pitch, unvoiced noise and silence."""
    n = int(SR * (0.45 + 0.11 * (i % 5)))
    t = np.arange(n) / SR
    f0 = 110 + 25 * i + 30 * np.sin(2 * np.pi * 1.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(0.5 / k * np.sin(k * phase) for k in (1, 2, 3))
    wav = np.where((t % 0.3) < 0.22, voiced, 0.05 * rng.randn(n))
    wav[: n // 12] = 0.0
    return (0.6 * wav + 0.003 * rng.randn(n)).astype(np.float32)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_data")
    (root / "wavs").mkdir()
    rng = np.random.RandomState(0)
    lines = []
    for i, text in enumerate(TEXTS):
        write_wav(root / "wavs" / f"u{i}.wav", utterance(i, rng), SR)
        lines.append(f"wavs/u{i}.wav|{text}")
    (root / "meta.csv").write_text("\n".join(lines) + "\n", encoding="utf-8")
    return root


def dataset_cfg(root, **over) -> dict:
    cfg = load_recipe("acoustic/core", "recipes", overrides={"dataset": {
        "root": str(root), "stats": STATS, **over}})["dataset"]
    return cfg


def both(root, **over):
    cfg = dataset_cfg(root, **over)
    return (JDataset(jax_build_config(JDataset.Config, dict(cfg))),
            AcousticDataset(build_config(AcousticDataset.Config, dict(cfg)), device="cpu"))


def f0(pitch):
    return np.asarray(pitch, np.float64) * STATS["pitch"]["std"] + STATS["pitch"]["mean"]


def check_features(got_mel, ref_mel, got_energy, ref_energy, got_pitch, ref_pitch):
    np.testing.assert_allclose(got_mel, ref_mel, atol=1e-3)
    np.testing.assert_allclose(got_energy, ref_energy, rtol=1e-3, atol=1e-6)
    gp, rp = f0(got_pitch), f0(ref_pitch)
    gv, rv = gp > 1.0, rp > 1.0
    assert (gv == rv).mean() >= 0.99, (gv != rv).sum()
    both_voiced = gv & rv
    assert both_voiced.sum() > 0.2 * gv.size
    np.testing.assert_allclose(gp[both_voiced], rp[both_voiced], rtol=1e-3)


@pytest.mark.parametrize("fixed", [False, True])
def test_batches_match_jax_through_the_batched_front_end(root, fixed):
    """Two shuffled epochs at batch 4 (and a short last batch kept):
    identical membership, text and lengths; features within tolerance."""
    jds, pds = both(root)
    ccfg = {"text_pad_multiple": 16, "mel_pad_multiple": 32, "max_text_len": 48,
            "max_mel_len": 128, "fixed_shape": fixed}
    jl = JLoader(jds, JCollator(**ccfg), batch_size=5, shuffle=True, drop_last=False, seed=7,
                 prefetch=0)
    pl = DataLoader(pds, AcousticCollator(**ccfg), batch_size=5, shuffle=True,
                    drop_last=False, seed=7)
    for epoch in (0, 3):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == 3
        for j, p in zip(jb, pb):
            assert p["filename"] == j["filename"] and p["text"] == j["text"]
            for key in ("text_vector", "text_vector_len", "mel_len"):
                assert p[key].dtype == j[key].dtype
                np.testing.assert_array_equal(p[key], j[key])
            assert p["mel"].shape == j["mel"].shape and p["pitch"].shape == j["pitch"].shape
            mask = np.arange(p["mel"].shape[1])[None] < p["mel_len"][:, None]
            check_features(p["mel"], j["mel"], p["energy"], j["energy"],
                           p["pitch"][mask], j["pitch"][mask])


def test_per_utterance_providers_match_jax(root):
    jds, pds = both(root, batched_frontend=False)
    for i in (0, 4, 11):
        j, p = jds[i], pds[i]
        np.testing.assert_array_equal(p.text_vector, j.text_vector)
        assert (p.mel_len, p.text_vector_len, p.filename) == (j.mel_len, j.text_vector_len,
                                                              j.filename)
        check_features(p.mel, j.mel, p.energy, j.energy, p.pitch, j.pitch)


@pytest.mark.parametrize("batched", [True, False])
def test_compute_stats_matches_jax(root, tmp_path, batched):
    jds, pds = both(root, batched_frontend=batched)
    ref = jds.compute_stats(save_stats=False, batch_size=5).to_dict()
    got = pds.compute_stats(save_path=str(tmp_path / "stats.json"), batch_size=5).to_dict()
    for feat in ("pitch", "energy"):
        for k in ("min", "max", "mean", "std"):
            np.testing.assert_allclose(got[feat][k], ref[feat][k], rtol=1e-3, err_msg=(feat, k))
    assert (tmp_path / "stats.json").exists()
    assert 40.0 < got["pitch"]["mean"] < 800.0


def test_yin_matches_jax_on_a_batch():
    import jax.numpy as jnp

    from isp_tts_tpu.ops.pitch import yin_pitch as jyin
    from isp_tts_tpu_torch.ops.pitch import yin_pitch

    rng = np.random.RandomState(3)
    x = np.stack([utterance(i, rng)[:12000] for i in (1, 6)])
    ref = np.asarray(jyin(jnp.asarray(x), SR, 42, 800, 256, 0.15))
    got = yin_pitch(torch.from_numpy(x), SR, 42, 800, 256, 0.15).numpy()
    assert got.shape == ref.shape
    voiced = (got > 0) & (ref > 0)
    assert ((got > 0) == (ref > 0)).mean() >= 0.99 and voiced.mean() > 0.3
    np.testing.assert_allclose(got[voiced], ref[voiced], rtol=1e-3)


def test_feature_cache_accounts_bytes_and_evicts_as_jax_does():
    from isp_tts_tpu.data.dataset import AcousticSample as JSample
    from isp_tts_tpu.data.dataset import FeatureCache as JCache
    from isp_tts_tpu_torch.data.dataset import AcousticSample, FeatureCache

    rng = np.random.RandomState(4)
    caches = (FeatureCache(max_items=4, max_bytes=9000), JCache(max_items=4, max_bytes=9000))
    for step in range(12):
        idx = int(rng.randint(0, 6))
        frames = int(rng.randint(5, 20))
        arrays = dict(text_vector=np.zeros(frames // 2, np.int32),
                      mel=np.zeros((frames, 80), np.float32),
                      pitch=np.zeros(frames, np.float32), energy=None)
        for cache, cls in zip(caches, (AcousticSample, JSample)):
            cache.put(idx, cls(filename="f", text="t", text_vector_len=frames // 2,
                               mel_len=frames, **arrays))
            if step % 3 == 0 and idx in cache:
                cache.get(idx)
        assert caches[0].nbytes == caches[1].nbytes
        assert list(caches[0]._data) == list(caches[1]._data)
        assert caches[0].nbytes <= 9000 and len(caches[0]) <= 4


@pytest.mark.parametrize("text", TEXTS + ["  Çafé   naïve—résumé  ", "Capt. Hook & Sgt. Pepper"])
@pytest.mark.parametrize("chain", [None, "basic_cleaners", "english_cleaners"])
def test_text_cleaners_match_jax(text, chain):
    from isp_tts_tpu.data.text.processor import TextProcessor as JProcessor
    from isp_tts_tpu_torch.data.text.processor import TextProcessor

    cleaners = [chain] if chain else None
    assert TextProcessor(cleaners)(text) == JProcessor(cleaners)(text)


def test_metadata_split_and_filters_match_jax(root):
    from isp_tts_tpu.data.metadata import TTSMeta as JMeta
    from isp_tts_tpu_torch.data.metadata import TTSMeta

    path = root / "meta.csv"
    j, p = JMeta.load(path), TTSMeta.load(path)
    for (pa, pb), (ja, jb) in [(p.split(0.25, seed=3), j.split(0.25, seed=3))]:
        assert [r.audio_path for r in pa] == [r.audio_path for r in ja]
        assert [r.audio_path for r in pb] == [r.audio_path for r in jb]
    assert [r.text for r in p.filter_length(10, 25)] == [r.text for r in j.filter_length(10, 25)]
    assert ([r.audio_path for r in p.filter_audio_length(root, 0.5, 0.8)]
            == [r.audio_path for r in j.filter_audio_length(root, 0.5, 0.8)])


def test_inject_data_config_matches_jax(root):
    """The dataset's symbol table, pitch statistics and mel contract land
    in the model config as JAX's ``inject_data_config`` puts them."""
    from isp_tts_tpu.models import AcousticModel as JModel
    from isp_tts_tpu_torch.models.acoustic.model import AcousticModel

    jds, pds = both(root)
    ref = JModel.inject_data_config({"mel_dim": 80}, jds)
    got = AcousticModel.inject_data_config({"mel_dim": 80}, pds)
    assert got == ref and list(got["encoding_map"]) == list(ref["encoding_map"])
