"""The port's training modules against the JAX package's, on the CPU.

Aligner, loss terms, the adaptor's training forward, one AdamW update
against the optax chain, and the trainer's loop (whole training steps
against JAX are in ``test_torch_port_train_step.py`` and
``test_torch_port_train_checkpoint.py``). float32 on both
sides, dropout off, the flow predictor's noise and time drawn as JAX draws
them (``split(key)``, then ``normal`` and ``uniform``) and handed to the
port. Tolerances are stated where they are used; they are float32
rounding through the stated depth, relative to the quantity's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from isp_tts_tpu.config import build_config as jax_build_config
from isp_tts_tpu.models.acoustic import loss as jloss
from isp_tts_tpu.models.acoustic.adaptor import FlowTemporalAdaptor as JAdaptor
from isp_tts_tpu.models.acoustic.adaptor import FlowTemporalAdaptorConfig as JAdaptorConfig
from isp_tts_tpu.models.acoustic.aligner import Aligner as JAligner
from isp_tts_tpu.models.acoustic.aligner import AlignerConfig as JAlignerConfig
from isp_tts_tpu.training.optimizers import OptimizationConfig as JOptimizationConfig
from isp_tts_tpu.training.optimizers import build_optimizer as jax_build_optimizer
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.models.acoustic import loss as ploss
from isp_tts_tpu_torch.models.acoustic.adaptor import FlowTemporalAdaptor, FlowTemporalAdaptorConfig
from isp_tts_tpu_torch.models.acoustic.aligner import Aligner, AlignerConfig
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
from isp_tts_tpu_torch.models.base import torch_name
from isp_tts_tpu_torch.training.optimizers import OptimizationConfig, build_optimizer, clip_grad_norm
from isp_tts_tpu_torch.training.trainer import Trainer
from isp_tts_tpu_torch.training.trainer_config import TrainerConfig
from torch_port_common import SMALL, carry, perturb, t

def _aligner_batch(B, M, T, mel_dim, text_dim, seed):
    rng = np.random.RandomState(seed)
    mel = rng.randn(B, M, mel_dim).astype(np.float32)
    enc = rng.randn(B, T, text_dim).astype(np.float32)
    text_len = rng.randint(T // 2, T + 1, size=B).astype(np.int32)
    mel_len = rng.randint(M // 2, M + 1, size=B).astype(np.int32)
    text_len[0], mel_len[0] = T, M
    return mel, enc, mel_len, text_len


def test_conv_kernel_layout_carries_to_conv1d():
    """flax Conv kernel (K, Cin, Cout) -> torch Conv1d weight (Cout, Cin, K):
    the same reversal of axes as a Dense kernel, and the same result."""
    assert torch_name("aligner.key_proj.0.conv.kernel") == (
        "aligner.key_proj.0.conv.weight", True)
    conv = nnx.Conv(6, 10, kernel_size=(5,), padding="SAME", use_bias=False,
                    rngs=nnx.Rngs(0))
    x = np.random.RandomState(0).randn(2, 13, 6).astype(np.float32)
    ref = np.asarray(conv(jnp.asarray(x)))
    w = torch.from_numpy(np.asarray(conv.kernel.value).T.copy())
    assert w.shape == (10, 6, 5)
    out = torch.nn.functional.conv1d(torch.nn.functional.pad(t(x).transpose(1, 2), (2, 2)),
                                     w).transpose(1, 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("mas_impl", ["auto", "scan"])
def test_aligner_matches(mas_impl):
    """Soft and hard attention, logits and durations from a carried JAX
    state (ragged batch): 1e-5 on the maps, exact on the hard path."""
    cfg = {"mel_dim": 12, "text_dim": 20, "attention_dim": 8, "key_kernel_size": 5,
           "query_kernel_size": (3, 5)}
    jal = JAligner(jax_build_config(JAlignerConfig, cfg), rngs=nnx.Rngs(0))
    al = Aligner(build_config(AlignerConfig, dict(cfg, mas_impl=mas_impl)))
    carry(perturb(jal, 3), al)
    mel, enc, mel_len, text_len = _aligner_batch(3, 40, 11, 12, 20, 4)
    ref = jal(jnp.asarray(mel), jnp.asarray(enc), jnp.asarray(mel_len),
              jnp.asarray(text_len))
    out = al(t(mel), t(enc), t(mel_len), t(text_len))
    for name in ("attn_soft", "attn_logits"):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(out.attn_hard.numpy(), np.asarray(ref.attn_hard))
    np.testing.assert_array_equal(out.attn_hard_duration.numpy(),
                                  np.asarray(ref.attn_hard_duration))
    np.testing.assert_array_equal(out.attn_hard_duration.sum(1).numpy(), mel_len)


def test_loss_terms_match():
    rng = np.random.RandomState(5)
    B, M, T = 3, 30, 9
    mel_out, mel_t = rng.randn(2, B, M, 7).astype(np.float32)
    mel_len = np.array([30, 21, 5], np.int32)  # sample 2: mel shorter than text
    text_len = np.array([9, 6, 8], np.int32)
    logits = rng.randn(B, M, T).astype(np.float32)
    soft = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=2))
    hard = (rng.rand(B, M, T) > 0.8).astype(np.float32)
    pairs = [
        (ploss.mel_loss_fn(t(mel_out), t(mel_t), t(mel_len)),
         jloss.mel_loss_fn(jnp.asarray(mel_out), jnp.asarray(mel_t), jnp.asarray(mel_len))),
        (ploss.attention_binarization_loss_fn(t(soft), t(hard)),
         jloss.attention_binarization_loss_fn(jnp.asarray(soft), jnp.asarray(hard))),
    ]
    for impl in ("auto", "scan"):
        pairs.append((
            ploss.attention_ctc_loss_fn(t(logits), t(text_len), t(mel_len), -1.0, impl),
            jloss.attention_ctc_loss_fn(jnp.asarray(logits), jnp.asarray(text_len),
                                        jnp.asarray(mel_len), -1.0, "scan")))
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-5)
    cfg = ploss.WeightedLossConfig(weight=2.5, skip_steps=3)
    jcfg = jloss.WeightedLossConfig(weight=2.5, skip_steps=3)
    for step in (0, 2, 3, 7):
        assert ploss.weight_loss(torch.tensor(1.5), cfg, step).item() == float(
            jloss.weight_loss(jnp.asarray(1.5), jcfg, step))


@pytest.mark.parametrize("soft_duration", [True, False])
def test_adaptor_training_forward_matches(soft_duration):
    """The OT-CFM training forward with JAX's own x0 and t injected: the
    flow loss, the predictions and the regulated states, 1e-5 absolute or
    relative (durations are exp of the flow output, up to ~100 frames)."""
    cfg = dict(SMALL["temporal_adaptor"], encoder_dim=64, soft_duration=soft_duration)
    jad = JAdaptor(jax_build_config(JAdaptorConfig, cfg), rngs=nnx.Rngs(0))
    ad = FlowTemporalAdaptor(build_config(FlowTemporalAdaptorConfig, cfg))
    carry(perturb(jad, 8), ad)
    rng = np.random.RandomState(9)
    B, T, M = 2, 10, 40
    enc = rng.randn(B, T, 64).astype(np.float32)
    enc_mask = np.arange(T)[None] < np.array([10, 7])[:, None]
    dur = rng.randint(1, 5, size=(B, T)).astype(np.float32) * enc_mask
    align = rng.rand(B, M, T).astype(np.float32) * enc_mask[:, None]
    pitch, energy = rng.randn(2, B, M).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jad(jnp.asarray(enc), jnp.asarray(enc_mask), M, jnp.asarray(dur),
              jnp.asarray(align), jnp.asarray(pitch), jnp.asarray(energy), key=key)
    noise_key, time_key = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(noise_key, (B, T, 3)))
    tt = np.asarray(jax.random.uniform(time_key, (B,)))
    out = ad(t(enc), t(enc_mask), M, t(dur), t(align), t(pitch), t(energy),
             noise=t(x0), t=t(tt))
    np.testing.assert_allclose(out.losses["flow_loss"].item(),
                               float(ref.losses["flow_loss"]), rtol=1e-5)
    for name in ("enc_out", "log_duration", "duration", "pitch", "energy",
                 "pitch_target", "energy_target"):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_array_equal(out.dec_lengths.numpy(), np.asarray(ref.dec_lengths))





def test_adamw_update_matches_optax_chain():
    """Clip, AdamW and decoupled decay on ndim >= 2 only, two steps (the
    first clipped, the second not), against the JAX package's optax chain:
    1e-6 absolute on parameters of unit scale."""
    rng = np.random.RandomState(14)
    shapes = {"w": (5, 3), "conv": (4, 3, 2), "b": (3,), "s": (2, 1, 1)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}
             for scale in (3.0, 0.01)]
    cfg = {"learning_rate": 2e-3, "weight_decay": 0.1, "grad_clip_norm": 1.0}
    tx, _ = jax_build_optimizer(JOptimizationConfig(**cfg), params)
    state = tx.init(params)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)

    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(t(v)))
    opt, _ = build_optimizer(build_config(OptimizationConfig, cfg), module)
    norms = []
    for g in grads:
        for k, v in g.items():
            module.get_parameter(k).grad = t(v)
        norms.append(clip_grad_norm(list(module.parameters()), 1.0).item())
        opt.step()
    assert norms[0] > 1.0 > norms[1]
    for k in params:
        np.testing.assert_allclose(module.get_parameter(k).detach().numpy(),
                                   np.asarray(jp[k]), atol=1e-6, err_msg=k)


def test_trainer_takes_steps_on_cpu_when_asked():
    """The trainer's loop on a small model: the JAX metric names, finite
    values, the checkpoint's optimizer settings, and the loss going down
    on a fixed batch."""
    pm = AcousticModel(build_config(AcousticModelConfig, SMALL))
    cfg = build_config(TrainerConfig, {"precision": "fp32", "optimization": {
        "learning_rate": 2e-3, "lr_scheduler": {"_target_": "exponential", "gamma": 0.5}}})
    trainer = Trainer(pm, ploss.AcousticModelLoss(), cfg, device="cpu")
    rng = np.random.RandomState(15)
    B, T, M = 2, 10, 40
    batch = {"text_vector": t(rng.randint(2, 11, size=(B, T))),
             "text_vector_len": t(np.array([10, 7])), "mel": t(rng.randn(B, M, 16).astype(np.float32)),
             "mel_len": t(np.array([40, 31])), "pitch": t(rng.randn(B, M).astype(np.float32)),
             "energy": t(rng.randn(B, M).astype(np.float32))}
    history = trainer.train([batch, batch], 4)
    assert set(history[0]) == {"loss", "model/mel_loss", "adaptor/flow_loss",
                               "aligner/attention_loss", "aligner/kl_loss",
                               "stats/grad_norm", "stats/learning_rate"}
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert [h["stats/learning_rate"] for h in history] == [2e-3, 2e-3, 1e-3, 1e-3]
    assert history[-1]["model/mel_loss"] < history[0]["model/mel_loss"]
    _, metrics = trainer.eval_step(batch)
    assert np.isfinite(metrics["loss"].item())
    if not torch.cuda.is_available():  # entry points run on the card unless asked
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(pm, ploss.AcousticModelLoss(), cfg)


def test_fast_dropout_keeps_the_8bit_quantised_share_and_switches_with_mode():
    """FastDropout keeps round((1 - rate) * 256) / 256 of the values, as the
    JAX ``_keep_mask`` does, scales them by 1 / (1 - rate), draws from its
    generator, and is a no-op in eval mode or at a rate that quantises to
    keep-everything."""
    from isp_tts_tpu.nn.layers import _keep_mask
    from isp_tts_tpu_torch.nn.layers import FastDropout, set_dropout_generator

    x = torch.ones((64, 1000))
    for rate in (0.1, 0.3):
        drop = FastDropout(rate)
        set_dropout_generator(drop, torch.Generator().manual_seed(0))
        y = drop(x)
        kept = (y != 0).float().mean().item()
        ref = float(np.asarray(_keep_mask(jax.random.PRNGKey(0), rate, x.shape)).mean())
        thresh = round((1 - rate) * 256)
        assert abs(kept - thresh / 256) < 0.005 and abs(ref - thresh / 256) < 0.005
        assert torch.allclose(y[y != 0], torch.tensor(1 / (1 - rate)))
        set_dropout_generator(drop, torch.Generator().manual_seed(0))
        assert torch.equal(drop(x), y)  # the same generator state, the same mask
        assert torch.equal(drop.eval()(x), x)
    assert torch.equal(FastDropout(1e-3)(x), x)  # 256/256: keep everything


def test_attention_dropout_follows_train_and_eval_mode():
    """In train mode a layer's attention dropout changes its output (both
    cores, one mask); in eval mode the output is the dropout-free one."""
    from isp_tts_tpu_torch.nn.attention import Attention, AttentionConfig
    from isp_tts_tpu_torch.nn.layers import set_dropout_generator

    cfg = {"dim": 64, "heads": 4, "head_dim": 64, "one_kv_head": True,
           "alibi_pos_bias": True}
    torch.manual_seed(0)
    plain = Attention(build_config(AttentionConfig, cfg)).eval()
    x = torch.randn(2, 17, 64)
    mask = torch.arange(17)[None] < torch.tensor([17, 11])[:, None]
    ref = plain(x, mask)
    outs = []
    for flash in ("auto", "off"):
        layer = Attention(build_config(AttentionConfig, dict(cfg, dropout=0.2, flash=flash)))
        layer.load_state_dict(plain.state_dict())
        set_dropout_generator(layer, torch.Generator().manual_seed(3))
        outs.append(layer.train()(x, mask))
        assert torch.allclose(layer.eval()(x, mask), ref, atol=1e-6)
    assert (outs[0] - ref).abs().max() > 1e-2
    assert torch.allclose(outs[0], outs[1], atol=1e-5)


@pytest.mark.parametrize("sched", [
    {"_target_": "none"},
    {"_target_": "exponential", "gamma": 0.995},
    {"_target_": "exponential-step", "gamma": 0.9, "step_size": 3},
    {"_target_": "warmup", "warmup_steps": 5, "scale": 2.0, "anneal_steps": (8, 12)},
])
def test_schedule_matches_jax(sched):
    from isp_tts_tpu.training.optimizers import LRSchedulerConfig as JLRSchedulerConfig
    from isp_tts_tpu.training.optimizers import Schedule as JSchedule
    from isp_tts_tpu_torch.training.optimizers import LRSchedulerConfig, Schedule

    ours = Schedule(build_config(LRSchedulerConfig, sched), 2e-4)
    ref = JSchedule(JLRSchedulerConfig(**sched), 2e-4)
    for step, epoch in [(0, 0), (1, 0), (4, 1), (7, 2), (11, 3), (30, 9)]:
        assert ours(step, epoch) == pytest.approx(ref(step, epoch), rel=1e-12)


def test_grad_norm_is_nan_on_non_finite_gradients():
    from isp_tts_tpu_torch.training.optimizers import global_grad_norm

    a, b = torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2, 2))
    a.grad, b.grad = torch.tensor([3.0, 0.0, 0.0]), torch.full((2, 2), 2.0)
    assert global_grad_norm([a, b]).item() == pytest.approx(5.0)
    b.grad[0, 0] = float("inf")
    assert torch.isnan(global_grad_norm([a, b]))


def test_checkpoint_training_setup_rebuilds():
    """The committed checkpoint's own trainer and loss settings build the
    port's configs: bf16, AdamW 2e-4 / 0.01 / clip 1.0, exponential 0.995."""
    from isp_tts_tpu_torch.checkpoint import load_checkpoint

    exp = load_checkpoint("docs/assets/scale_r5/acoustic_scratch10k_r5.f16.ckpt")[
        "experiment"]["config"]
    cfg = build_config(TrainerConfig, exp["trainer"])
    opt = cfg.optimization
    assert (cfg.precision, cfg.seed) == ("bf16", 42)
    assert (opt._target_, opt.learning_rate, opt.weight_decay, opt.grad_clip_norm) == (
        "adamw", 2e-4, 0.01, 1.0)
    assert (opt.lr_scheduler._target_, opt.lr_scheduler.gamma) == ("exponential", 0.995)
    loss = build_config(ploss.AcousticLossConfig, exp["criterion"])
    assert loss.attention_loss.blank_logprob == -1 and loss.attention_kl_loss.weight == 1.0


BF16_CASES = ["aligner_logits", "average_by_alignment", "adaln", "length_regulate"]


@pytest.mark.parametrize("case", BF16_CASES)
def test_bf16_autocast_keeps_the_f32_products_of_the_jax_policy(case):
    """Under a bf16 step's autocast, the products that the JAX package's
    bf16 policy keeps in f32 stay f32 here: the aligner's logits (bf16
    projections summed in f32, its ``preferred_element_type``), the
    soft-alignment token averages and the length regulators (f32 inputs,
    computed in their dtype there) and AdaLN's condition maps (built
    without a compute dtype there). Each is held to float64 arithmetic on
    the same inputs at 1e-5 of its scale; a bf16 product is ~4e-3 off."""
    from isp_tts_tpu_torch.models.acoustic import adaptor as padaptor
    from isp_tts_tpu_torch.models.acoustic.aligner import batch_diagonal_prior
    from isp_tts_tpu_torch.nn.norms import AdaptiveLayerNorm
    from isp_tts_tpu_torch.utils.masks import get_mask_from_lengths

    torch.manual_seed(0)
    rng = np.random.RandomState(5)
    autocast = torch.autocast("cpu", dtype=torch.bfloat16)
    if case == "aligner_logits":
        al = Aligner(build_config(AlignerConfig, {
            "mel_dim": 12, "text_dim": 20, "attention_dim": 16, "key_kernel_size": 5,
            "query_kernel_size": (3, 5)}))
        mel, enc, mel_len, text_len = (t(a) for a in _aligner_batch(3, 40, 11, 12, 20, 4))
        with autocast:
            _, got = al.attention(mel, enc, mel_len, text_len)
            keys, queries = enc, mel
            for conv in al.key_proj:
                keys = conv(keys, get_mask_from_lengths(text_len, 11))
            for conv in al.query_proj:
                queries = conv(queries, get_mask_from_lengths(mel_len, 40))
        assert queries.dtype == keys.dtype == torch.bfloat16
        raw = torch.einsum("bma,bta->bmt", queries.double(), keys.double()) * al.scale
        prior = batch_diagonal_prior(text_len, mel_len, 11, 40).double()
        ref = raw.log_softmax(dim=2) + torch.log(prior + 1e-6)
    elif case == "average_by_alignment":
        x = t(rng.randn(2, 30).astype(np.float32))
        a = t(rng.randn(2, 30, 7).astype(np.float32)).softmax(dim=2)
        with autocast:
            got = padaptor.average_by_alignment(x, a)
        ref = (torch.einsum("bm,bmt->bt", x.double(), a.double())
               / (a.double().sum(dim=1) + 1e-5))
    elif case == "adaln":
        norm = AdaptiveLayerNorm(16, 8)
        x = t(rng.randn(2, 5, 16).astype(np.float32))
        cond = t(rng.randn(2, 8).astype(np.float32)).bfloat16()  # a bf16 time embedding
        with autocast, torch.no_grad():
            got = norm(x, cond)
        xd = x.double()
        normed = (xd - xd.mean(-1, keepdim=True)) / torch.sqrt(
            xd.var(-1, keepdim=True, unbiased=False) + norm.eps)
        c = cond.double()[:, None, :]
        w, b = norm.weight, norm.bias
        ref = ((c @ w.weight.double().T + w.bias.double()) * normed
               + c @ b.weight.double().T + b.bias.double())
    else:
        x = t(rng.randn(2, 4, 6).astype(np.float32))
        dur = t(np.array([[1, 2, 0, 3], [2, 2, 1, 1]], np.float32))
        with autocast:
            got, _ = padaptor.length_regulate_hard(x, dur, 8)
        idx = torch.tensor([[0, 1, 1, 3, 3, 3], [0, 0, 1, 1, 2, 3]])
        ref = torch.zeros((2, 8, 6), dtype=torch.float64)
        ref[:, :6] = torch.stack([x[i, idx[i]] for i in range(2)]).double()
    assert got.dtype == torch.float32
    assert (got.double() - ref).abs().max() <= 1e-5 * ref.abs().max()
