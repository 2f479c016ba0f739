"""Settings the port either computes as the JAX package does or refuses,
and the bf16 residual stream, on the CPU.

- ``build_config`` raises on a key its dataclass does not declare, on a
  value no package takes (a mesh axis below 1), and a declared option the
  port does not compute (a head dim past 128 with the kernels, ``flash``
  not ``off``) raises at any value but the JAX default; head dims up to
  128 build with the kernels, cross-attention's ``context_dim`` and a model
  axis beside a pipeline axis build. Keys that cannot change what the port computes are listed per
  dataclass (``IGNORED_KEYS``); the committed checkpoint's embedded config
  has no other undeclared key.
- ``sigma`` and ``detach_inputs`` of the adaptor's temporal modules give
  JAX's loss, outputs and input gradients (float32, 1e-5).
- Under bf16 the transformer's residual stream runs in bf16, as the JAX
  policy's ``stream_dtype`` does.
"""

import dataclasses
import typing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.models.acoustic import adaptor as jadaptor
from isp_tts_tpu.nn.policy import compute_dtype
from isp_tts_tpu.nn.transformer import Transformer as JTransformer
from isp_tts_tpu.nn.transformer import TransformerConfig as JTransformerConfig
from isp_tts_tpu_torch.checkpoint import load_checkpoint
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.models.acoustic import adaptor as padaptor
from isp_tts_tpu_torch.models.acoustic.loss import AcousticLossConfig
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
from isp_tts_tpu_torch.nn.attention import AttentionConfig
from isp_tts_tpu_torch.nn.transformer import Transformer, TransformerConfig
from isp_tts_tpu_torch.training.trainer_config import TrainerConfig
from torch_port_common import SMALL, carry, perturb, t

CKPT = "docs/assets/scale_r5/acoustic_scratch10k_r5.f16.ckpt"


@pytest.mark.parametrize("cls,cfg,error", [
    (TrainerConfig, {"mesh_model_axis": 0, "mesh_pipeline_axis": 2}, ValueError),
    (TrainerConfig, {"pipeline_microbatches": 0}, ValueError),
    (TrainerConfig, {"precision": "int8"}, ValueError),
    (TrainerConfig, {"deepspeed": True}, ValueError),
    (AttentionConfig, {"kv_cache": True}, ValueError),
    (AcousticModelConfig, dict(SMALL, vocoder="vocos"), ValueError),
    (AttentionConfig, {"heads": 2, "head_dim": 256, "flash": "auto"}, NotImplementedError),
])
def test_options_the_port_does_not_compute_raise(cls, cfg, error):
    with pytest.raises(error):
        build_config(cls, cfg)


def test_head_dims_other_than_64_build_with_flash_off():
    """The refusal is of the kernels: the plain version takes any head dim,
    past the kernels' 128 too."""
    cfg = build_config(AttentionConfig, {"heads": 2, "head_dim": 256, "flash": "off"})
    assert cfg.head_dim == 256
    assert build_config(AttentionConfig, {"dim": 256, "heads": 4, "head_dim": None}).dim == 256


@pytest.mark.parametrize("head_dim", [8, 12, 32, 128])
def test_head_dims_up_to_128_build_with_the_kernels(head_dim):
    """Head dims up to 128 build with ``flash: auto`` (the kernels launch
    multiples of 8 as they are and zero-pad the others), in a layer, in
    cross-attention, in a model's stack, and as ``dim // heads``."""
    cfg = build_config(AttentionConfig, {"heads": 2, "head_dim": head_dim, "flash": "auto"})
    assert cfg.head_dim == head_dim
    assert build_config(AttentionConfig, {"dim": 2 * head_dim, "heads": 2,
                                          "head_dim": None}).dim == 2 * head_dim
    assert build_config(AttentionConfig, {"context_dim": 128, "heads": 2,
                                          "head_dim": head_dim}).context_dim == 128
    layer = SMALL["encoder"]["transformer_layer"]
    model = build_config(AcousticModelConfig, dict(SMALL, encoder=dict(
        SMALL["encoder"], transformer_layer=dict(layer, attention=dict(
            layer["attention"], head_dim=head_dim)))))
    assert model.encoder.transformer_layer.attention.head_dim == head_dim


def test_defaults_ignored_and_meta_keys_build():
    """JAX's defaults of the refused options, the ignore set and the
    loader's ``_``-prefixed meta keys build without complaint; the options
    ported since (the freeze mask, fp16) build at any value."""
    cfg = build_config(TrainerConfig, {"_name_": "Trainer", "finetune_layers": [],
                                       "precision": "fp32", "logging_steps": 5,
                                       "steps_per_call": 8})
    assert (cfg.precision, cfg.finetune_layers) == ("fp32", [])
    cfg = build_config(TrainerConfig, {"finetune_layers": ["decoder"], "precision": "fp16",
                                       "resume_from_checkpoint": "run/last.ckpt"})
    assert (cfg.precision, cfg.finetune_layers) == ("fp16", ["decoder"])
    assert build_config(AttentionConfig, {"context_dim": None}).context_dim is None
    assert build_config(AttentionConfig, {"context_dim": 128}).context_dim == 128
    cfg = build_config(TrainerConfig, {"mesh_model_axis": 2, "mesh_pipeline_axis": 2})
    assert (cfg.mesh_model_axis, cfg.mesh_pipeline_axis) == (2, 2)
    assert build_config(AcousticModelConfig, dict(SMALL, audio_config={"n_fft": 1024}))


def _undeclared(cls, cfg: dict, path: str) -> list[str]:
    """Keys of ``cfg`` (recursively) that ``cls`` neither declares nor
    ignores; ``_``-prefixed meta keys excepted."""
    hints = typing.get_type_hints(cls)
    fields = {f.name for f in dataclasses.fields(cls)}
    ignored = getattr(cls, "IGNORED_KEYS", frozenset())
    out = []
    for key, value in cfg.items():
        if key.startswith("_") or key in ignored:
            continue
        if key not in fields:
            out.append(f"{path}.{key}")
            continue
        hint = hints[key]
        sub = next((a for a in (hint, *typing.get_args(hint))
                    if dataclasses.is_dataclass(a)), None)
        if sub is not None and isinstance(value, dict):
            out += _undeclared(sub, value, f"{path}.{key}")
    return out


def test_checkpoint_config_has_no_undeclared_key():
    """Every key of the committed checkpoint's model, trainer and loss
    configs is declared or in an ignore set, so the checkpoint builds and
    trains exactly as before."""
    blob = load_checkpoint(CKPT)
    experiment = blob["experiment"]["config"]
    for cls, cfg, path in ((AcousticModelConfig, blob["model"]["config"], "model"),
                           (TrainerConfig, experiment["trainer"], "trainer"),
                           (AcousticLossConfig, experiment["criterion"], "criterion")):
        assert _undeclared(cls, cfg, path) == []
        build_config(cls, cfg)
    model = AcousticModel.from_pretrained(CKPT, device="cpu")
    assert model.temporal_adaptor.predictor.sigma == 1e-5
    assert not model.temporal_adaptor.predictor.detach_inputs


_FLOW_CFG = dict(SMALL["temporal_adaptor"]["predictor"], input_dim=64, output_dim=3)


@pytest.mark.parametrize("sigma", [1e-5, 0.2])
@pytest.mark.parametrize("detach", [False, True])
def test_flow_module_sigma_and_detach_inputs_match_jax(sigma, detach):
    """The OT-CFM training forward with a non-default ``sigma`` and with
    ``detach_inputs`` (no flow-loss gradient into the condition): the loss
    and its gradient with respect to the condition, JAX's x0 and t injected."""
    cfg = dict(_FLOW_CFG, sigma=sigma, detach_inputs=detach)
    jm = jadaptor.FlowTransformerTemporalModule(
        jax_build_config(jadaptor.FlowTemporalModuleConfig, cfg), rngs=nnx.Rngs(0))
    pm = padaptor.FlowTransformerTemporalModule(
        build_config(padaptor.FlowTemporalModuleConfig, cfg))
    carry(perturb(jm, 17), pm)
    rng = np.random.RandomState(18)
    B, T = 2, 9
    x = rng.randn(B, T, 64).astype(np.float32)
    targets = rng.randn(B, T, 3).astype(np.float32)
    mask = np.arange(T)[None] < np.array([9, 6])[:, None]
    key = jax.random.PRNGKey(19)

    def jloss(xj):
        return jm(xj, jnp.asarray(targets), jnp.asarray(mask), key=key)[1]["flow_loss"]

    jl, jgx = jax.value_and_grad(jloss)(jnp.asarray(x))
    noise_key, time_key = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(noise_key, (B, T, 3)))
    tt = np.asarray(jax.random.uniform(time_key, (B,)))
    xp = t(x).requires_grad_()
    _, losses = pm(xp, t(targets), t(mask), noise=t(x0), t=t(tt))
    losses["flow_loss"].backward()
    np.testing.assert_allclose(losses["flow_loss"].item(), float(jl), rtol=1e-5)
    gx = np.zeros_like(x) if xp.grad is None else xp.grad.numpy()
    np.testing.assert_allclose(gx, np.asarray(jgx), atol=1e-5 * max(np.abs(jgx).max(), 1.0))
    assert (np.abs(gx).max() == 0) == detach


@pytest.mark.parametrize("detach", [False, True])
def test_embedding_module_detach_inputs_matches_jax(detach):
    """The pitch/energy embedding network with ``detach_inputs``: output and
    the gradient with respect to its input features."""
    cfg = dict(SMALL["temporal_adaptor"]["embedding"], input_dim=2, output_dim=64,
               detach_inputs=detach)
    jm = jadaptor.TransformerTemporalModule(
        jax_build_config(jadaptor.TemporalModuleConfig, cfg), rngs=nnx.Rngs(0))
    pm = padaptor.TransformerTemporalModule(build_config(padaptor.TemporalModuleConfig, cfg))
    carry(perturb(jm, 20), pm)
    rng = np.random.RandomState(21)
    x = rng.randn(2, 7, 2).astype(np.float32)
    mask = np.arange(7)[None] < np.array([7, 5])[:, None]
    w = rng.randn(2, 7, 64).astype(np.float32)

    def jloss(xj):
        out = jm(xj, jnp.asarray(mask))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, jout), jgx = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    xp = t(x).requires_grad_()
    out = pm(xp, t(mask))
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    gx = np.zeros_like(x) if xp.grad is None else xp.grad.numpy()
    np.testing.assert_allclose(gx, np.asarray(jgx), atol=1e-5 * max(np.abs(jgx).max(), 1.0))
    assert (np.abs(gx).max() == 0) == detach


def test_bf16_residual_stream_matches_jax_policy():
    """A 2-layer transformer under bf16: the port's layers (under bf16
    autocast) carry a bf16 stream, as the JAX layers do under the bf16
    policy, and the output is f32 in both. The two bf16 outputs round the
    same f32 function independently (summation order, fused elementwise
    tails, the JAX CPU path's bf16 probabilities), so they are held to twice
    the control: how far bf16 moves the JAX output from its f32 output."""
    cfg = {"dim": 64, "depth": 2, "emb_dim": 40,
           "transformer_layer": {"attention": {"heads": 2, "head_dim": 64,
                                               "one_kv_head": False,
                                               "alibi_pos_bias": True},
                                 "feed_forward": {"inner_dim": 128, "activation": "gelu"}}}
    with compute_dtype(jnp.bfloat16):
        jtr = JTransformer(jax_build_config(JTransformerConfig, cfg), rngs=nnx.Rngs(0))
    jf32 = JTransformer(jax_build_config(JTransformerConfig, cfg), rngs=nnx.Rngs(0))
    tr = Transformer(build_config(TransformerConfig, cfg))
    carry(perturb(jtr, 22), tr)
    perturb(jf32, 22)
    rng = np.random.RandomState(23)
    x = rng.randn(2, 17, 40).astype(np.float32)
    mask = np.arange(17)[None] < np.array([17, 11])[:, None]
    jref = jtr(jnp.asarray(x), mask=jnp.asarray(mask)).out
    control = np.abs(np.asarray(jref) - np.asarray(jf32(jnp.asarray(x),
                                                        mask=jnp.asarray(mask)).out)).max()
    stream = jtr.project_emb(jnp.asarray(x)).astype(jtr.stream_dtype)
    jlayer_dtype = jtr.layers[0](stream, mask=jnp.asarray(mask))[0].dtype

    dtypes = []
    hook = tr.layers[0].register_forward_hook(lambda m, i, o: dtypes.append(o.dtype))
    with torch.autocast("cpu", dtype=torch.bfloat16), torch.no_grad():
        out = tr(t(x), mask=t(mask))
    hook.remove()
    assert jlayer_dtype == jnp.bfloat16
    assert dtypes == [torch.bfloat16]
    assert out.dtype == torch.float32 and jref.dtype == jnp.float32
    assert 0 < control < 0.1
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), atol=2 * control)
