"""The port's serving export (``isp_tts_tpu_torch.export``) on the CPU, at a
tiny width with the kernels' head dim of 64: the exported graph's
registered attention nodes, the artifact against the live Synthesizer, its
metadata against the JAX package's export of the same checkpoint, the
loader's refusals, loading without model code, and the daemon's
``ArtifactServing``."""

import json
import os
import subprocess
import sys
import urllib.request
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.data.text.table import CodingTable
from isp_tts_tpu_torch.export import (ExportedSynthesizer, export_serving, kernel_nodes,
                                      main as export_main)
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel
from isp_tts_tpu_torch.models.vocoder import VocoderModel
from isp_tts_tpu_torch.serving import Synthesizer, SynthesizerConfig
from isp_tts_tpu_torch.serving_server import ArtifactServing, ServerConfig, TTSServer
from torch_port_common import multi_kv_head

ROOT = Path(__file__).resolve().parent.parent
CHARSET = ["<pad>", "</s>", "#punct", "#en"]
TB, FB, STEPS = 16, 64, 2
_LAYER = {"attention": {"heads": 2, "head_dim": 64, "one_kv_head": True,
                        "alibi_pos_bias": True},
          "feed_forward": {"inner_dim": 64}}
#: depths 2 (encoder), 2 (predictor, run STEPS times), 1 (embedding), 1 (decoder)
TINY64 = {
    "encoding_map": dict(CodingTable.from_charset(CHARSET).encoding_map),
    "mel_dim": 16, "text_dim": 64,
    "encoder": {"dim": 64, "depth": 2, "transformer_layer": _LAYER},
    "decoder": {"dim": 64, "depth": 1, "transformer_layer": _LAYER},
    "temporal_adaptor": {
        "predictor": {"time_embedding_dim": 8, "transformer": {
            "dim": 64, "depth": 2, "transformer_layer": _LAYER}},
        "embedding": {"transformer": {"dim": 64, "depth": 1, "transformer_layer": _LAYER}}},
    "aligner": {"attention_dim": 8},
}
ATTENTION_CALLS = 2 + 2 * STEPS + 1 + 1
VOCODER = {"features": {"n_mels": 16}, "generator": {"dim": 16, "intermediate_dim": 32,
                                                     "num_layers": 1},
           "discriminator": {"periods": [2], "resolutions": [[64, 16]],
                             "mpd_channels": [2], "mrd_channels": 2}}
TEXT = "birch canoe."


def make_synth(cfg=TINY64, vocoder=False, seed=0):
    torch.manual_seed(seed)
    model = AcousticModel(build_config(AcousticModel.Config, cfg))
    with torch.no_grad():  # durations of ~exp(1) - 1 frames a token: no empty answer
        model.temporal_adaptor.predictor.linear.bias[0] += 1.0
    voc = VocoderModel(build_config(VocoderModel.Config, VOCODER)) if vocoder else None
    return Synthesizer(model, SynthesizerConfig(
        text_buckets=(TB,), frame_budgets=(FB,), steps=STEPS, charset=tuple(CHARSET)),
        vocoder=voc)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{name: (live synthesizer, artifact path, meta)} for the mel, audio and
    multi-KV-head exports."""
    d = tmp_path_factory.mktemp("export")
    out = {}
    for name, kwargs in (("mel", {}), ("audio", {"vocoder": True}),
                         ("mha", {"cfg": multi_kv_head(TINY64)})):
        synth = make_synth(**kwargs)
        path = d / f"{name}.zip"
        out[name] = synth, path, export_serving(synth, path, TB, FB)
    return out


def program(path):
    from isp_tts_tpu_torch.ops import flash_attention  # noqa: F401 - registers the ops

    with zipfile.ZipFile(path) as z:
        import io

        return torch.export.load(io.BytesIO(z.read("program.pt2")))


@pytest.mark.parametrize("name,op", [("mel", "isp_tts.mqa_fwd.default"),
                                     ("mha", "isp_tts.flash_fwd.default")])
def test_graph_calls_attention_only_through_the_registered_forward(artifacts, name, op):
    ep = program(artifacts[name][1])
    assert kernel_nodes(ep) == {op: ATTENTION_CALLS}
    targets = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert not any("scaled_dot_product" in t or "softmax" in t for t in targets), targets


@pytest.mark.parametrize("name", ["mel", "audio", "mha"])
def test_artifact_matches_the_live_synthesizer(artifacts, name):
    """Two seeds and two duration factors through one artifact: the controls
    are program inputs, not constants, and the noise is the live draw."""
    synth, path, meta = artifacts[name]
    ex = ExportedSynthesizer(path, device="cpu")
    live = synth.synthesize_audio if name == "audio" else synth
    lengths = set()
    for seed in (0, 7):
        for df in (1.0, 1.8):
            got = ex(TEXT, seed=seed, duration_factor=df)[0]
            want = live(TEXT, seed=seed, duration_factor=df)[0]
            assert got.shape == want.shape and got.size > 0
            assert np.abs(got - want).max() <= 1e-6
            lengths.add(got.shape[0])
    assert len(lengths) > 1  # the duration factor reached the program
    if name == "audio":
        assert meta["output"] == "audio" and np.abs(got).max() <= 1.0


def test_meta_matches_the_jax_export(artifacts, tmp_path):
    """The same checkpoint exported by both packages: every shared key of
    meta.json agrees; the port adds only its format keys."""
    from flax import nnx

    from isp_tts_tpu.config.registry import build_config as jbuild
    from isp_tts_tpu.export import export_serving as jexport
    from isp_tts_tpu.models.acoustic import AcousticModel as JModel
    from isp_tts_tpu.models.acoustic import AcousticModelConfig as JConfig
    from isp_tts_tpu.serving import Synthesizer as JSynth
    from isp_tts_tpu.serving import SynthesizerConfig as JSynthConfig

    jm = JModel(jbuild(JConfig, TINY64), rngs=nnx.Rngs(0))
    jm.save_pretrained(tmp_path / "m.ckpt")
    jmeta = jexport(JSynth(jm, JSynthConfig(text_buckets=(TB,), frame_budgets=(FB,),
                                            steps=STEPS, charset=tuple(CHARSET))),
                    tmp_path / "j.zip", TB, FB)
    pm = AcousticModel.from_pretrained(tmp_path / "m.ckpt", device="cpu")
    meta = export_serving(Synthesizer(pm, SynthesizerConfig(
        text_buckets=(TB,), frame_budgets=(FB,), steps=STEPS, charset=tuple(CHARSET))),
        tmp_path / "p.zip", TB, FB)
    shared = set(meta) & set(jmeta)
    assert shared == set(jmeta)
    assert {k: meta[k] for k in shared} == {k: jmeta[k] for k in shared}
    assert set(meta) - shared == {"format", "device", "noise_shape"}
    # and the JAX artifact is refused by the port's loader
    with pytest.raises(ValueError, match="JAX package artifact"):
        ExportedSynthesizer(tmp_path / "j.zip", device="cpu")


def test_loader_refuses_what_the_artifact_cannot_serve(artifacts, tmp_path):
    _, path, meta = artifacts["mel"]
    ex = ExportedSynthesizer(path, device="cpu")
    with pytest.raises(ValueError, match="exceeds the exported bucket"):
        ex("a much longer text than sixteen tokens.")
    with pytest.raises(ValueError, match="exported for batch 1"):
        ex([TEXT, TEXT])
    with pytest.raises(ValueError, match="without speaker support"):
        ex(TEXT, speaker=0)
    # another format version, and a device type the artifact was not made for
    for key, value, match in (("format_version", 2, "unsupported artifact format"),
                              ("platforms", ["cuda"], "exported for")):
        forged = tmp_path / f"{key}.zip"
        rewrite_meta(path, forged, {key: value})
        with pytest.raises(ValueError, match=match):
            ExportedSynthesizer(forged, device="cpu")
    assert meta["platforms"] == ["cpu"]


def rewrite_meta(src, dst, changes):
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for item in zin.namelist():
            data = zin.read(item)
            if item == "meta.json":
                data = json.dumps({**json.loads(data), **changes}).encode()
            zout.writestr(item, data)


def test_phonemizer_artifact_fails_at_load(artifacts, tmp_path, monkeypatch):
    """No espeak-ng on this host: an artifact that needs the phonemizer is
    refused when it loads, not served as graphemes."""
    for name in ("phonemizer", "phonemizer.backend", "phonemizer.separator"):
        monkeypatch.setitem(sys.modules, name, None)
    forged = tmp_path / "phon.zip"
    rewrite_meta(artifacts["mel"][1], forged, {"phonemizer": True})
    with pytest.raises((ImportError, RuntimeError), match="phonemizer"):
        ExportedSynthesizer(forged, device="cpu")


def test_loading_and_serving_import_no_model_code(artifacts):
    path = artifacts["audio"][1]
    code = (
        "import sys\n"
        "from isp_tts_tpu_torch.export import ExportedSynthesizer\n"
        f"ex = ExportedSynthesizer({str(path)!r}, device='cpu')\n"
        f"wav = ex({TEXT!r}, seed=3)[0]\n"
        "assert wav.size > 0\n"
        "bad = sorted(m for m in sys.modules if m.startswith('isp_tts_tpu_torch.models')\n"
        "             or m.split('.')[0] in ('isp_tts_tpu', 'jax', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok', wav.size)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def test_artifact_serving_serves_wav_and_refuses_mel(artifacts):
    with pytest.raises(ValueError, match="needs an audio artifact"):
        ArtifactServing(ExportedSynthesizer(artifacts["mel"][1], device="cpu"))
    synth, path, meta = artifacts["audio"]
    served = ArtifactServing(ExportedSynthesizer(path, device="cpu"))
    assert served.max_batch == 1 and served.sample_rate == meta["sample_rate"]
    with pytest.raises(ValueError, match="mel format is unavailable"):
        served([TEXT])
    srv = TTSServer(served, port=0, config=ServerConfig(max_batch=served.max_batch))
    port = srv.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/synthesize", method="POST",
            data=json.dumps({"text": TEXT, "seed": 5, "format": "wav"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "audio/wav"
            body = r.read()
    finally:
        srv.stop()
    import io
    import wave

    with wave.open(io.BytesIO(body)) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        assert w.getframerate() == meta["sample_rate"]
    want = synth.synthesize_audio(TEXT, seed=5)[0]
    ref = (np.clip(want, -1, 1) * 32767.0).astype("<i2")
    assert pcm.shape == ref.shape and np.abs(pcm.astype(int) - ref).max() <= 1


def test_speaker_variant_and_cli(tmp_path):
    """``--speaker`` exports the speaker id as an input; the CLI writes an
    artifact from a checkpoint on the CPU, and ``--precompile`` there warns
    and embeds nothing."""
    cfg = dict(TINY64, num_speakers=3)
    synth = make_synth(cfg)
    path = tmp_path / "spk.zip"
    export_serving(synth, path, TB, FB, use_speaker=True)
    ex = ExportedSynthesizer(path, device="cpu")
    for spk in (0, 2):
        np.testing.assert_allclose(ex(TEXT, seed=1, speaker=spk)[0],
                                   synth(TEXT, seed=1, speaker=spk)[0], atol=1e-6, rtol=0)
    synth.model.save_pretrained(tmp_path / "m.ckpt")
    out = tmp_path / "cli.zip"
    export_main(["--checkpoint", str(tmp_path / "m.ckpt"), "--output", str(out),
                 "--text-bucket", "16", "--frame-budget", "64", "--steps", "1",
                 "--device", "cpu", "--precompile"])
    with zipfile.ZipFile(out) as z:
        assert sorted(z.namelist()) == ["meta.json", "program.pt2"]
        meta = json.loads(z.read("meta.json"))
    assert meta["steps"] == 1 and "precompiled" not in meta


def test_embedded_libraries_serve_only_their_block():
    """``cuda_build.libraries``, through which an artifact's embedded kernel
    libraries serve its calls: inside the block ``load`` returns them and
    builds nothing; after it they are gone, and the shared cache never held
    them."""
    from isp_tts_tpu_torch.ops import cuda_build

    own = object()
    before = dict(cuda_build._LOADED)
    with cuda_build.libraries({"mqa_fwd": own}):
        assert cuda_build.load("mqa_fwd") is own
    assert cuda_build._OVERRIDE.get() == {}
    assert cuda_build._LOADED == before


def test_a_second_registration_of_an_operator_raises():
    """Registering ``isp_tts::mqa_fwd`` again raises: the one registered
    launches and counts this copy's kernels, and no other copy's."""
    from isp_tts_tpu_torch.ops import flash_attention as fa

    assert fa.NAMESPACE == "isp_tts"
    with pytest.raises(RuntimeError, match="already registered"):
        fa._register("mqa_fwd", "mqa_bwd", lambda B, N, H: (B, N * H))


def test_a_second_copy_registers_its_own_operators(tmp_path):
    """A copy of the package imported under another name (a study tool's
    parent checkout) registers its operators in its own namespace: its
    layers launch and count its own kernels, not this copy's."""
    code = (
        "import importlib, importlib.util, sys, torch\n"
        "import isp_tts_tpu_torch.ops.flash_attention as fa\n"
        f"pkg = {str(ROOT / 'isp_tts_tpu_torch')!r}\n"
        "spec = importlib.util.spec_from_file_location('parent_port', pkg + '/__init__.py',"
        " submodule_search_locations=[pkg])\n"
        "mod = importlib.util.module_from_spec(spec); sys.modules['parent_port'] = mod\n"
        "spec.loader.exec_module(mod)\n"
        "other = importlib.import_module('parent_port.ops.flash_attention')\n"
        "print(fa.NAMESPACE, other.NAMESPACE, fa.mqa_op is not other.mqa_op,\n"
        "      hasattr(torch.ops.parent_port, 'flash_fwd'))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["isp_tts", "parent_port", "True", "True"]
