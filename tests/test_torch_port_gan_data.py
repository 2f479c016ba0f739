"""The vocoder's data path against the JAX package, and the vocoder recipe
through the port's training CLI, on the CPU.

- ``VocoderDataset`` + ``VocoderCollator``: random training crops, centre
  evaluation crops, a clip shorter than a segment and the paired ``mel_dir``
  path (hop-snapped crops, short mels padded with log(1e-5)) bit-equal to
  the JAX package's for one numpy seed, item by item and through the
  batched ``get_batch``; the batch decoded natively.
- ``python -m isp_tts_tpu_torch.train --config-name vocoder/vocos`` at tiny
  widths runs 2 GAN steps on the CPU (``--device cpu``) and writes a
  checkpoint with the discriminators and both optimizers.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from isp_tts_tpu.data.vocoder import VocoderCollator as JCollator
from isp_tts_tpu.data.vocoder import VocoderDataset as JDataset
from isp_tts_tpu.data.vocoder import VocoderDatasetConfig as JConfig
from isp_tts_tpu_torch.checkpoint import load_checkpoint
from isp_tts_tpu_torch.config.yamlio import _flow
from isp_tts_tpu_torch.data import audio as paudio
from isp_tts_tpu_torch.data.vocoder import (VocoderCollator, VocoderDataset,
                                            VocoderDatasetConfig)
from test_torch_port_gan import TINY_MODEL
from torch_port_common import write_toy_dataset

ROOT = Path(__file__).resolve().parent.parent
HOP = 64


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_gan_data")
    write_toy_dataset(root)
    mels = root / "mels"
    mels.mkdir()
    rng = np.random.RandomState(5)
    for i in range(8):
        # paired predicted mels: some shorter than the audio, one very short
        frames = 12 if i == 3 else int(6615 * (0.3 + 0.05 * (i % 4)) / HOP) - 3 * (i % 2)
        np.save(mels / f"u{i}.npy", rng.randn(frames, 16).astype(np.float32))
    return root


CASES = {  # name: config overrides
    "random": {"segment_samples": 2048},
    "centre": {"segment_samples": 2048, "random_crop": False},
    "long segment": {"segment_samples": 12000},
    "paired": {"segment_samples": 2048, "hop_length": HOP, "mel_dir": "mels"},
    "paired centre": {"segment_samples": 2048, "hop_length": HOP, "mel_dir": "mels",
                      "random_crop": False},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_crops_match_jax(toy_root, case):
    over = dict(CASES[case])
    if "mel_dir" in over:
        over["mel_dir"] = str(toy_root / over["mel_dir"])
    jds = JDataset(JConfig(root=str(toy_root), **over))
    pds = VocoderDataset(VocoderDatasetConfig(root=str(toy_root), **over))
    order = [5, 2, 7, 0, 3, 1, 6, 4, 2, 3]
    np.random.seed(1234)
    ref = JCollator()([jds[i] for i in order])
    np.random.seed(1234)
    before = dict(paudio.DECODED)
    got = VocoderCollator()(pds.get_batch(order))
    assert paudio.DECODED["native"] - before["native"] == 8  # each file once, natively
    np.random.seed(1234)
    again = VocoderCollator()([pds[i] for i in order])  # cached
    assert set(got) == set(ref)
    for k in ref:
        for out in (got, again):
            if isinstance(ref[k], np.ndarray):
                assert out[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
            else:
                assert out[k] == ref[k], k
    if case == "long segment":
        assert (got["n_samples"] < 12000).all()
    if case.startswith("paired"):
        assert got["mel"].shape == (len(order), 2048 // HOP, 16)
        assert (got["mel"][order.index(3), 12:] == np.float32(np.log(1e-5))).all()


def test_vocos_recipe_trains_through_the_cli_on_the_cpu(toy_root, tmp_path):
    settings = {"dataset.root": str(toy_root), "dataset.segment_samples": 1024,
                "model": TINY_MODEL, "trainer.max_steps": 2, "trainer.batch_size": 4,
                "trainer.eval_batch_size": 4, "trainer.eval_steps": 2,
                "trainer.save_steps": 2, "trainer.eval_batches": 1,
                "trainer.output_dir": str(tmp_path), "trainer.label": "cli",
                "trainer.log_with": [], "trainer.progress": False,
                # f32: the CPU's bf16 conv2d returns NaN now and then on the
                # 2-frame-wide inputs these tiny widths give the MRD
                "trainer.precision": "fp32"}
    args = []
    for key, value in settings.items():
        args += ["--set", f"{key}={value if isinstance(value, str) else _flow(value)}"]
    proc = subprocess.run([sys.executable, "-m", "isp_tts_tpu_torch.train", "--config-name",
                           "vocoder/vocos", "--device", "cpu", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ckpts = sorted(tmp_path.rglob("checkpoint_last.ckpt"))
    assert len(ckpts) == 1
    blob = load_checkpoint(ckpts[0])
    assert blob["model"]["class"] == "VocoderModel"
    assert blob["experiment"]["state"]["global_step"] == 2
    state = blob["model"]["state"]
    assert any(k.startswith("discriminator.period_discs.") for k in state)
    keyed = blob["optimizer"]["keyed"]
    assert any(k.startswith("['gen']") for k in keyed)
    assert any(k.startswith("['disc']") for k in keyed)
    for k, v in state.items():
        assert np.isfinite(np.asarray(v)).all(), k
