"""The port's GPipe schedule and stacked layer stacks against the JAX
package, in one process.

- ``pipeline_apply_virtual`` (every stage of an S-stage schedule here) and
  ``pipeline_apply`` with no group (one stage) against JAX's
  ``pipeline_apply`` over ``shard_map`` on a ``stage`` mesh of the
  conftest's virtual CPU devices, on the cases of ``tests/test_pipeline.py``
  (a GELU MLP stack): outputs within 1e-5, gradients of the weights, the
  biases and the input within 1e-5 of each one's max-abs, with and
  without remat;
- ``Transformer(pipeline=True)`` (stacked storage ``stack.*``): locally
  against the per-layer transformer with the same weights (1e-5), against
  JAX's stacked transformer on the same flat state, without dropout
  (1e-5), on a named stage axis of size 1 (the schedule of one stage)
  against the local path, and, with live dropout, the same at 1 and 4
  microbatches (its dropout is keyed by step, layer and global row);
- the layer-stack translation against JAX's ``_translate_layer_stacking``
  on the same flat dict, both ways, bit-equal; a stacked model's flat
  state names and shapes equal JAX's ``pipeline: true`` model's; a JAX
  per-layer checkpoint loads into the port's stacked model and back
  bit-equal, and a stacked checkpoint the port writes loads into JAX's
  stacked and per-layer models bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from isp_tts_tpu.config import build_config as jbuild
from isp_tts_tpu.models.acoustic.model import AcousticModel as JAcousticModel
from isp_tts_tpu.models.acoustic.model import AcousticModelConfig as JAcousticModelConfig
from isp_tts_tpu.models.base import _translate_layer_stacking
from isp_tts_tpu.nn.transformer import Transformer as JTransformer
from isp_tts_tpu.nn.transformer import TransformerConfig as JTransformerConfig
from isp_tts_tpu.parallel.pipeline import microbatch as jmicrobatch
from isp_tts_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply
from isp_tts_tpu_torch.config import build_config
from isp_tts_tpu_torch.models.acoustic.model import AcousticModel, AcousticModelConfig
from isp_tts_tpu_torch.models.base import translate_layer_stacking
from isp_tts_tpu_torch.nn.transformer import Transformer, TransformerConfig
from isp_tts_tpu_torch.parallel.context import parallel_context
from isp_tts_tpu_torch.parallel.pipeline import (microbatch, pipeline_apply,
                                                 pipeline_apply_virtual)
from torch_port_common import SMALL, jax_flat, perturb

P = jax.sharding.PartitionSpec


def close(got, ref, bound=1e-5, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= bound, f"{what}: {err:.3e} > {bound:.0e}"


def stack(S, D, seed=0):
    rng = np.random.RandomState(seed)
    return ((rng.randn(S, D, D) / np.sqrt(D)).astype(np.float32),
            (rng.randn(S, D) * 0.1).astype(np.float32))


def jax_pipelined(W, b, x, n_micro, S, remat=True):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:S]), ("stage",))

    def fn(W, b, xm):
        return jpipeline_apply(lambda p, h: jax.nn.gelu(h @ p[0][0] + p[1][0]), (W, b), xm,
                               axis_name="stage", remat=remat)

    out = jax.shard_map(fn, mesh=mesh, in_specs=(P("stage"), P("stage"), P()),
                        out_specs=P())(W, b, jmicrobatch(x, n_micro))
    return out.reshape(x.shape)


jax_pipelined_jit = jax.jit(jax_pipelined, static_argnums=(3, 4, 5))


def port_pipelined(W, b, x, n_micro, S, remat=True):
    """S stages of one layer each; one stage through ``pipeline_apply``."""
    def layer(s):
        # tanh GELU, as jax.nn.gelu's default
        return lambda h, mb: torch.nn.functional.gelu(h @ W[s] + b[s], approximate="tanh")

    xm = microbatch(x, n_micro)
    if S == 1:
        out = pipeline_apply(layer(0), xm, remat=remat)
    else:
        out = pipeline_apply_virtual([layer(s) for s in range(S)], xm, remat=remat)
    return out.reshape(x.shape)


@pytest.mark.parametrize("S,n_micro", [(4, 1), (4, 4), (4, 8), (8, 4), (1, 4)])
def test_schedule_matches_jax(S, n_micro):
    W, b = stack(S, 16)
    x = np.random.RandomState(1).randn(16, 16).astype(np.float32)
    ref = jax_pipelined_jit(jnp.asarray(W), jnp.asarray(b), jnp.asarray(x), n_micro, S)
    got = port_pipelined(torch.tensor(W), torch.tensor(b), torch.tensor(x), n_micro, S)
    close(got, ref, what=f"S {S} n_micro {n_micro}")


@pytest.mark.parametrize("remat", [True, False])
def test_schedule_gradients_match_jax(remat):
    S, D, B, n_micro = 4, 12, 8, 4
    W, b = stack(S, D, seed=4)
    x = np.random.RandomState(5).randn(B, D).astype(np.float32)
    w = np.random.RandomState(6).randn(B, D).astype(np.float32)

    def jloss(W, b, x):
        return jnp.sum(jax_pipelined(W, b, x, n_micro, S, remat=remat) * w)

    ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*map(jnp.asarray, (W, b, x)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (W, b, x)]
    (port_pipelined(*leaves, n_micro, S, remat=remat) * torch.tensor(w)).sum().backward()
    for name, leaf, r in zip(("dW", "db", "dx"), leaves, ref):
        close(leaf.grad, r, what=name)


LAYER = {"attention": {"heads": 2, "head_dim": 64, "one_kv_head": True,
                       "alibi_pos_bias": True, "alibi_symmetric": False},
         "feed_forward": {"inner_dim": 64, "activation": "gelu"}}


def transformers(dropout=0.0, depth=4):
    layer = {k: dict(v, dropout=dropout) for k, v in LAYER.items()}
    cfg = {"dim": 32, "depth": depth, "transformer_layer": layer}
    torch.manual_seed(0)
    per_layer = Transformer(build_config(TransformerConfig, cfg))
    stacked = Transformer(build_config(TransformerConfig, dict(cfg, pipeline=True)))
    return per_layer, stacked, cfg


def layer_state(per_layer: Transformer) -> dict:
    """The per-layer transformer's state as the stacked one's."""
    out = {}
    for name, t in per_layer.state_dict().items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            out.setdefault(f"stack.{rest}", [None] * len(per_layer.layers))[int(i)] = t
        else:
            out[name] = t
    return {k: torch.stack(v) if isinstance(v, list) else v for k, v in out.items()}


def inputs(B=4, N=16, D=32):
    x = torch.randn(B, N, D, generator=torch.Generator().manual_seed(2))
    mask = torch.arange(N)[None] < torch.tensor([[N], [N - 3], [N], [N - 7]])[:B]
    return x, mask


def test_stacked_transformer_names_and_shapes():
    per_layer, stacked, _ = transformers()
    names = dict(stacked.named_parameters())
    assert "stack.attention.to_q.weight" in names and stacked.layers is None
    assert names["stack.attention.to_q.weight"].shape == (4, 128, 32)
    assert set(stacked.state_dict()) == set(layer_state(per_layer))


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_stacked_transformer_locally_equals_per_layer(n_micro):
    per_layer, stacked, _ = transformers()
    stacked.load_state_dict(layer_state(per_layer))
    x, mask = inputs()
    ref = per_layer.eval()(x, mask)
    close(stacked.eval()(x, mask).detach(), ref.detach(), what="no stage axis")
    with parallel_context(n_micro=n_micro, stage_axis="stage"):  # the schedule of one stage
        close(stacked.eval()(x, mask).detach(), ref.detach(), what=f"n_micro {n_micro}")


def test_stacked_transformer_gradients_equal_per_layer():
    per_layer, stacked, _ = transformers()
    stacked.load_state_dict(layer_state(per_layer))
    x, mask = inputs()
    w = torch.randn(4, 16, 32, generator=torch.Generator().manual_seed(3))
    (per_layer.train()(x, mask) * w).sum().backward()
    with parallel_context(n_micro=2, stage_axis="stage"):  # the schedule of one stage
        (stacked.train()(x, mask) * w).sum().backward()
    grads = layer_state(type("G", (), {"state_dict": lambda self: {
        n: p.grad for n, p in per_layer.named_parameters()}, "layers": per_layer.layers})())
    for name, p in stacked.named_parameters():
        close(p.grad, grads[name], what=name)


def test_stacked_transformer_equals_jax_stacked_transformer():
    _, stacked, cfg = transformers()
    jt = JTransformer(jbuild(JTransformerConfig, dict(cfg, pipeline=True)), rngs=nnx.Rngs(0))
    flat = perturb(jt, 3)
    from isp_tts_tpu_torch.models.base import Model

    class Holder(Model):
        def __init__(self, t):
            super().__init__()
            self.t = t

    holder = Holder(stacked)
    holder.load_jax_state({f"t.{k}": v for k, v in flat.items()})
    assert set(holder.jax_state()) == {f"t.{k}" for k in flat}
    for k, v in flat.items():
        assert np.array_equal(holder.jax_state()[f"t.{k}"], v), k
    x, mask = inputs()
    jt.eval()
    ref = jt(jnp.asarray(x.numpy()), mask=jnp.asarray(mask.numpy())).out
    close(stacked.eval()(x, mask).detach(), ref, what="stacked vs JAX")


def test_stacked_dropout_does_not_depend_on_the_microbatch_count():
    per_layer, stacked, _ = transformers(dropout=0.3)
    stacked.train()
    x, mask = inputs()
    outs = []
    for kw in ({}, {"n_micro": 4, "stage_axis": "stage"}):  # one microbatch, then four
        stacked.step_dropout.generator = torch.Generator().manual_seed(11)
        with parallel_context(**kw):
            outs.append(stacked(x, mask).detach())
    stacked.eval()
    plain = stacked(x, mask).detach()
    assert (outs[0] - plain).abs().max() > 1e-2  # it drops
    close(outs[1], outs[0], what="n_micro 4 vs 1")


def test_stacked_batch_not_divisible_degrades_locally():
    _, stacked, _ = transformers()
    x, mask = inputs(B=3)
    with parallel_context(n_micro=2, stage_axis="stage"):
        assert stacked.eval()(x, mask[:3]).shape == x.shape


def flat_dict(seed=0):
    rng = np.random.RandomState(seed)
    flat = {f"dec.layers.{i}.attention.to_q.kernel": rng.randn(8, 4).astype(np.float32)
            for i in range(3)}
    flat.update({f"dec.layers.{i}.norm.scale": rng.randn(8).astype(np.float32)
                 for i in range(3)})
    flat["enc.layers.0.w"] = rng.randn(2, 2).astype(np.float32)
    return flat


def test_translation_matches_jax_both_ways():
    flat = flat_dict()
    stacked_cur = {"dec.stack.attention.to_q.kernel": np.zeros((3, 8, 4), np.float32),
                   "dec.stack.norm.scale": np.zeros((3, 8), np.float32),
                   "enc.layers.0.w": np.zeros((2, 2), np.float32)}
    got, ref = translate_layer_stacking(flat, stacked_cur), _translate_layer_stacking(
        flat, stacked_cur)
    assert set(got) == set(ref) == set(stacked_cur)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k
    back_cur = {k: np.zeros_like(v) for k, v in flat.items()}
    got2, ref2 = translate_layer_stacking(got, back_cur), _translate_layer_stacking(
        ref, back_cur)
    assert set(got2) == set(ref2) == set(flat)
    for k in flat:
        assert np.array_equal(got2[k], flat[k]) and np.array_equal(ref2[k], flat[k]), k


def piped(cfg):
    return dict(cfg, decoder=dict(cfg["decoder"], pipeline=True))


def test_checkpoints_cross_between_layouts_and_packages(tmp_path):
    """JAX per-layer weights -> the port's stacked model -> its checkpoint
    -> JAX's stacked and per-layer models and the port's per-layer model:
    every tensor bit-equal."""
    jplain = JAcousticModel(jbuild(JAcousticModelConfig, SMALL), rngs=nnx.Rngs(0))
    flat = perturb(jplain, 4)
    model = AcousticModel(build_config(AcousticModelConfig, piped(SMALL)))
    model.load_jax_state(flat)
    state = model.jax_state()
    assert any(".stack." in k for k in state)
    model.save_pretrained(tmp_path / "stacked.ckpt")
    jpiped = JAcousticModel.from_pretrained(str(tmp_path / "stacked.ckpt"))
    assert jax_flat(jpiped).keys() == state.keys()
    for k, v in jax_flat(jpiped).items():
        assert np.array_equal(v, state[k]), k
    back = JAcousticModel(jbuild(JAcousticModelConfig, SMALL), rngs=nnx.Rngs(1))
    back.load_params(state)
    for k, v in jax_flat(back).items():
        assert np.array_equal(v, flat[k]), k
    port_plain = AcousticModel(build_config(AcousticModelConfig, SMALL))
    port_plain.load_jax_state(state)
    for k, v in port_plain.jax_state().items():
        assert np.array_equal(v, flat[k]), k
