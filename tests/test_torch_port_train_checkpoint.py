"""One training step of the committed 23M-parameter checkpoint at full
width, the port against the JAX package, on the CPU: every loss term and
the gradient norm of each top-level module. float32, dropout off, the flow
predictor's draws injected."""

import jax
import numpy as np

from isp_tts_tpu.data.providers import TextProvider as JTextProvider
from isp_tts_tpu.data.providers import TextProviderConfig
from isp_tts_tpu.data.text.table import CodingTable as JCodingTable
from isp_tts_tpu.models import AcousticModel as JAcousticModel
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel
from torch_port_common import flow_draws, jax_step, port_step

CKPT = "docs/assets/scale_r5/acoustic_scratch10k_r5.f16.ckpt"


def test_full_width_checkpoint_training_step_matches():
    """One training step of the committed checkpoint at full width, B 2,
    text 48, mel 128, float32, dropout off: every loss term within 1e-4
    relative and the gradient norm of each top-level module within 1e-3
    relative (float32 through 6 + 6 layers of width 384, the aligner and
    the flow predictor)."""
    jm = JAcousticModel.from_pretrained(CKPT)
    jm.eval()
    pm = AcousticModel.from_pretrained(CKPT, device="cpu")
    prov = JTextProvider(TextProviderConfig(charset=["<pad>"]))
    prov.coding_table = JCodingTable.from_encoding_map(jm.encoding_map)
    B, T, M = 2, 48, 128
    text = np.zeros((B, T), np.int32)
    text_len = np.zeros((B,), np.int32)
    for i, s in enumerate(["The birch canoe slid on the smooth planks.",
                           "Glue the sheet to the blue sky."]):
        enc = prov(s)
        text[i, :enc.vector_len] = enc.vector
        text_len[i] = enc.vector_len
    rng = np.random.RandomState(16)
    inputs = {"text": text, "text_len": text_len,
              "mel": rng.randn(B, M, 80).astype(np.float32) * 0.5 - 4.0,
              "mel_len": np.array([128, 101], np.int32),
              "pitch": rng.randn(B, M).astype(np.float32),
              "energy": rng.randn(B, M).astype(np.float32),
              "speaker": np.array([0, 2], np.int32)}
    key = jax.random.PRNGKey(5)
    jl, jlosses, jgrads = jax_step(jm, inputs, key)
    x0, tt = flow_draws(key, B, T)
    pl, plosses = port_step(pm.eval(), inputs, x0, tt)
    for k in jlosses:
        np.testing.assert_allclose(plosses[k], jlosses[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    tops = sorted({k.split(".")[0] for k in jgrads})
    assert {"encoder", "aligner", "temporal_adaptor", "decoder", "to_mel"} <= set(tops)
    for top in tops:
        ref = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                          for k, g in jgrads.items() if k.split(".")[0] == top))
        ours = np.sqrt(sum(float((p.grad.double() ** 2).sum())
                           for n, p in pm.named_parameters() if n.split(".")[0] == top))
        np.testing.assert_allclose(ours, ref, rtol=1e-3, err_msg=top)
