"""The masked batch norm (``MaskedBatchNorm1d``, the aligner's
``normalization: batch``) against the JAX package's, on the CPU.

- The norm alone over three train-mode calls (each output, and the
  running ``mean``/``var`` after each) and one eval-mode call (the running
  statistics read, not moved), float32 within 1e-6 of each tensor's
  max-abs;
- the aligner with ``normalization: batch``: its soft and log attention
  maps and durations, the gradients of its parameters, and its norms'
  running statistics after the step, within 1e-5 of max-abs (the
  choose_normalization factory picks the classes JAX's picks);
- a checkpoint round trip: the port's file read by the JAX model gives its
  statistics, the JAX model's file read by the port gives them back;
- two gloo ranks at data 2 (``torch_port_parallel_workers.case_batch_norm``,
  the acoustic model of ``PAR`` with the aligner's batch norm, live
  dropout): the running statistics after each of two steps within 1e-6 of
  one rank's on the global batch (the masked sums and the count are summed
  over the data group before dividing), the steps' metrics within rel 1e-4
  and the first step's gradients within 1e-5 of max-abs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import torch_port_parallel_workers as W
from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.models import AcousticModel as JAcousticModel
from isp_tts_tpu.models.acoustic.aligner import Aligner as JAligner
from isp_tts_tpu.models.acoustic.aligner import AlignerConfig as JAlignerConfig
from isp_tts_tpu.models.acoustic.model import AcousticModelConfig as JAcousticModelConfig
from isp_tts_tpu.nn import layers as jlayers
from isp_tts_tpu.nn.norms import MaskedBatchNorm1d as JMaskedBatchNorm1d
from isp_tts_tpu.training.checkpoint import load_checkpoint as jax_load_checkpoint
from isp_tts_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.models.acoustic.aligner import Aligner, AlignerConfig
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
from isp_tts_tpu_torch.nn import layers as players
from isp_tts_tpu_torch.nn.norms import MaskedBatchNorm1d
from test_torch_port_parallel_two import _grads_close, _metrics_close
from torch_port_common import SMALL, assert_grads_match, carry, flat_grads, perturb, t


def close(got, ref, rtol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= rtol * max(np.abs(ref).max(), 1e-12), f"{what}: {err:.3e}"


def test_choose_normalization_picks_the_same_classes():
    assert players.choose_normalization(None) is None
    for name in ("batch", "instance"):
        assert (players.choose_normalization(name).__name__
                == jlayers.choose_normalization(name).__name__)
    with pytest.raises(KeyError):
        players.choose_normalization("nope")


def test_masked_batch_norm_matches_over_train_and_eval_calls():
    rng = np.random.RandomState(0)
    jbn = JMaskedBatchNorm1d(5)
    bn = MaskedBatchNorm1d(5)
    # affine weights off their init, so they take part
    jbn.scale.value = jnp.asarray(1 + 0.3 * rng.randn(5).astype(np.float32))
    jbn.bias.value = jnp.asarray(0.3 * rng.randn(5).astype(np.float32))
    bn.load_state_dict({"weight": t(jbn.scale.value), "bias": t(jbn.bias.value),
                        "mean": torch.zeros(5), "var": torch.ones(5)})
    bn.train()
    for call in range(4):
        x = (rng.randn(3, 11, 5) * (2 + call) + call).astype(np.float32)
        mask = np.arange(11)[None, :] < np.array([11, 6, 9])[:, None]
        x[~mask] = 1e4  # padding never reaches the statistics
        if call == 3:
            jbn.eval()
            bn.eval()
        ref = jbn(jnp.asarray(x), jnp.asarray(mask))
        out = bn(t(x), t(mask))
        close(out, ref, 1e-6, f"out {call}")
        close(bn.mean, jbn.mean.value, 1e-6, f"mean {call}")
        close(bn.var, jbn.var.value, 1e-6, f"var {call}")
        assert not out[torch.from_numpy(~mask)].any()
    # no mask: every position counts
    jbn.train()
    bn.train()
    x = rng.randn(2, 7, 5).astype(np.float32)
    close(bn(t(x)), jbn(jnp.asarray(x)), 1e-6, "unmasked")
    close(bn.var, jbn.var.value, 1e-6, "unmasked var")


ALIGNER = {"mel_dim": 16, "text_dim": 32, "attention_dim": 8, "key_kernel_size": 5,
           "query_kernel_size": 3, "normalization": "batch"}


def test_aligner_with_batch_norm_matches():
    jal = JAligner(jax_build_config(JAlignerConfig, ALIGNER), rngs=nnx.Rngs(0))
    flat = perturb(jal, 3)
    al = Aligner(build_config(AlignerConfig, ALIGNER)).train()
    carry(flat, al)
    assert isinstance(al.key_proj[0].norm, MaskedBatchNorm1d)
    rng = np.random.RandomState(1)
    mel = rng.randn(3, 40, 16).astype(np.float32)
    enc = rng.randn(3, 12, 32).astype(np.float32)
    mel_len, text_len = np.array([40, 31, 22], np.int32), np.array([12, 9, 7], np.int32)
    w = rng.randn(3, 40, 12).astype(np.float32)
    jin = tuple(jnp.asarray(a) for a in (mel, enc, mel_len, text_len))

    def loss_fn(m):
        out = m(*jin)
        return jnp.sum(out.attn_soft * jnp.asarray(w)) + 0.01 * jnp.sum(
            jnp.where(out.attn_logits > -1e8, out.attn_logits, 0.0)), out

    (_, ref), grads = nnx.value_and_grad(loss_fn, has_aux=True)(jal)
    out = al(t(mel), t(enc), t(mel_len), t(text_len))
    loss = (out.attn_soft * t(w)).sum() + 0.01 * torch.where(
        out.attn_logits > -1e8, out.attn_logits, 0.0).sum()
    loss.backward()
    close(out.attn_soft, ref.attn_soft, 1e-5, "soft")
    close(out.attn_logits, ref.attn_logits, 1e-5, "logits")
    np.testing.assert_array_equal(out.attn_hard_duration.numpy(),
                                  np.asarray(ref.attn_hard_duration))
    assert_grads_match(flat_grads(grads), al, 1e-5)
    after = {k: v for k, v in dict(nnx.to_flat_state(nnx.state(jal, nnx.BatchStat))).items()}
    assert after
    for path, var in after.items():
        name = ".".join(str(p) for p in path)
        close(al.get_buffer(name), var.value, 1e-5, name)


def test_checkpoint_round_trip_carries_the_statistics(tmp_path):
    cfg = dict(SMALL, aligner=dict(SMALL["aligner"], normalization="batch"))
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, cfg), rngs=nnx.Rngs(0))
    pm = AcousticModel(build_config(AcousticModelConfig, cfg))
    pm.load_jax_state(perturb(jm, 4))
    rng = np.random.RandomState(2)
    with torch.no_grad():
        for buf_name, buf in pm.named_buffers():
            if buf_name.endswith((".norm.mean", ".norm.var")):
                buf.copy_(torch.from_numpy(rng.rand(*buf.shape).astype(np.float32) + 0.5))
    stats = {k: v.numpy().copy() for k, v in pm.named_buffers()
             if k.endswith((".norm.mean", ".norm.var"))}
    assert len(stats) == 6  # 3 normalised convolutions x (mean, var)
    pm.save_pretrained(tmp_path / "port.ckpt")
    ckpt = jax_load_checkpoint(tmp_path / "port.ckpt")
    jm.load_params(ckpt["model"]["state"], ignore_mismatched=False)
    jstate = jm.state_dict()
    for k, v in stats.items():
        np.testing.assert_array_equal(jstate[k], v, err_msg=k)
    for k in stats:
        jstate[k] = jstate[k] * 2
    jax_save_checkpoint(tmp_path / "jax.ckpt", {
        "format": "isp_tts_tpu.v1", "model": {"class": "AcousticModel", "config": cfg,
                                              "state": jstate}})
    back = AcousticModel.from_pretrained(tmp_path / "jax.ckpt", device="cpu")
    for k, v in stats.items():
        np.testing.assert_array_equal(back.get_buffer(k).numpy(), 2 * v, err_msg=k)
    assert {k: np.asarray(v) for k, v in back.jax_state().items() if k in stats}.keys() \
        == stats.keys()


@pytest.fixture(scope="module")
def data_2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bn2")
    jm = JAcousticModel(jax_build_config(JAcousticModelConfig, W.PAR_BN), rngs=nnx.Rngs(0))
    W.save_inputs(tmp / "inputs.npz", {}, W.global_batch(), wb=perturb(jm, 14))
    procs = W.spawn(2, tmp / "inputs.npz", tmp, ["batch_norm"], tmp)
    try:
        inputs = dict(np.load(tmp / "inputs.npz"))
        one = W.one_thread(W.case_batch_norm, inputs, tmp / "one")
    finally:
        W.join(procs, tmp, timeout=120.0)
    return dict(np.load(tmp / "batch_norm.npz")), one


def test_data_2_statistics_equal_one_rank_on_the_global_batch(data_2):
    got, one = data_2
    keys = [k for k in one if k.startswith("s::")]
    assert len(keys) == 6
    for k in keys:
        assert got[k].shape == (2, *one[k].shape[1:])
        close(got[k], one[k], 1e-6, k)
    # the statistics moved from their init, step by step
    assert all(np.abs(one[k][1] - one[k][0]).max() > 0 for k in keys)


def test_data_2_steps_with_batch_norm_equal_one_rank(data_2):
    got, one = data_2
    _metrics_close(got, one, 1e-4)
    _grads_close(got, one, 1e-5)
