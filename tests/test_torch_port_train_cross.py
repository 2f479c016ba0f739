"""Checkpoints and optimizer updates across the two packages, on the CPU.

- The port's checkpoint is a flax msgpack document: ``flax.serialization``
  and the JAX ``load_checkpoint`` read it to the same tree, bit-equal, and
  flax writes that tree back to the same bytes.
- A two-step JAX run is resumed by the port's trainer, and a two-step port
  run by JAX's: step, epoch, learning rate and every optimizer moment agree
  exactly; then one more step each, with the same flow draws and dropout
  off, agrees to 1e-5 (float32): loss relative, parameters absolute.
- One update of each optimizer variant (gradient accumulation k = 2, the
  freeze mask, both together, SGD with momentum, with and without decay)
  against optax, 1e-6 absolute on parameters of unit scale, with optax's
  tree paths for every leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx, serialization

from isp_tts_tpu.training.checkpoint import load_checkpoint as jax_load_checkpoint
from isp_tts_tpu.training.experiment import ExperimentModules as JExperimentModules
from isp_tts_tpu_torch.checkpoint import load_checkpoint
from isp_tts_tpu_torch.training.experiment import ExperimentModules
from torch_port_common import flow_draws, t, toy_overrides, write_toy_dataset


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cross")
    write_toy_dataset(root)
    return root


def _over(root, outdir, **trainer):
    return toy_overrides(root, outdir, **dict(dict(epochs=1, batch_size=4), **trainer))


def port_trainer(root, outdir, **trainer):
    return ExperimentModules("acoustic/core", "recipes", overrides=_over(root, outdir, **trainer),
                             device="cpu").init_modules().build_trainer()


def jax_trainer(root, outdir, **trainer):
    modules = JExperimentModules("acoustic/core", "recipes",
                                 overrides=_over(root, outdir, num_devices=1, **trainer))
    modules.init_modules()
    return modules.build_trainer()


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype and a.shape == np.shape(b), path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), path


def test_port_checkpoint_is_read_by_flax_and_jax(toy_root, tmp_path):
    pt = port_trainer(toy_root, tmp_path, epochs=2)
    pt.train()
    path = pt.run_dir / "checkpoint_last.ckpt"
    data = path.read_bytes()
    ref = serialization.msgpack_restore(data)
    _tree_equal(jax_load_checkpoint(path), ref)
    assert serialization.msgpack_serialize(ref) == data
    assert ref["format"] == "isp_tts_tpu.v1" and ref["model"]["class"] == "AcousticModel"
    ours = load_checkpoint(path)
    _tree_equal(ours["model"]["state"], ref["model"]["state"])
    _tree_equal(ours["optimizer"], ref["optimizer"])
    for name, arr in pt.model.jax_state().items():
        np.testing.assert_array_equal(ref["model"]["state"][name], arr, err_msg=name)


def jax_step(jt, batch, key):
    """One JAX training step of ``jt``'s model on ``batch`` with the flow
    draws of ``key``; returns the loss."""
    m = jt.model
    m.train()
    inputs = {k: jnp.asarray(v) for k, v in m.prepare_inputs(batch).items() if v is not None}
    step = jt.state.global_step

    def loss_fn(mod):
        loss, losses = jt.criterion(inputs, mod(**inputs, key=key), step)
        return loss, losses

    (loss, _), grads = nnx.value_and_grad(loss_fn, has_aux=True)(m)
    jt.opt_state = jt._apply_lr(jt.schedule(step, int(jt.state.epoch)))
    params = nnx.state(m, nnx.Param)
    updates, jt.opt_state = jt.tx.update(grads, jt.opt_state, params)
    nnx.update(m, optax.apply_updates(params, updates))
    return float(loss)


def port_step(pt, batch, key):
    x0, tt = flow_draws(key, batch["text_vector"].shape[0], batch["text_vector"].shape[1])
    pt.optimizer.lr = pt.schedule(pt.state.global_step, int(pt.state.epoch))
    metrics, _ = pt._update(batch, noise=t(x0), t=t(tt))
    return float(metrics["loss"])


def check_resumed_pair(jt, pt, keyed):
    assert pt.state.global_step == jt.state.global_step == 4
    assert pt.state.epoch == jt.state.epoch
    assert pt.state.learning_rate == jt.state.learning_rate
    assert pt.schedule.base_lr == jt.schedule.base_lr
    got = pt.optimizer.keyed_state()
    paths, _ = jax.tree_util.tree_flatten_with_path(jt.opt_state)
    assert set(got) == {jax.tree_util.keystr(p) for p, _ in paths} == set(keyed)
    for p, leaf in paths:
        k = jax.tree_util.keystr(p)
        np.testing.assert_array_equal(got[k], np.asarray(leaf), err_msg=k)
    batch = next(iter(pt.train_loader))
    key = jax.random.PRNGKey(11)
    jl, pl = jax_step(jt, batch, key), port_step(pt, batch, key)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    ref = jt.model.state_dict()
    for name, arr in pt.model.jax_state().items():
        np.testing.assert_allclose(arr, np.asarray(ref[name]), atol=1e-5, err_msg=name)


def test_jax_run_is_resumed_by_the_port(toy_root, tmp_path):
    jrun = jax_trainer(toy_root, tmp_path / "jax", epochs=2)
    jrun.train()
    ckpt = str(jrun.run_dir / "checkpoint_last.ckpt")
    keyed = jax_load_checkpoint(ckpt)["optimizer"]["keyed"]
    pt = port_trainer(toy_root, tmp_path / "port", epochs=3, resume_from_checkpoint=ckpt)
    jt = jax_trainer(toy_root, tmp_path / "jax2", epochs=3, resume_from_checkpoint=ckpt)
    check_resumed_pair(jt, pt, keyed)


def test_port_run_is_resumed_by_jax(toy_root, tmp_path):
    prun = port_trainer(toy_root, tmp_path / "port", epochs=2)
    prun.train()
    ckpt = str(prun.run_dir / "checkpoint_last.ckpt")
    keyed = load_checkpoint(ckpt)["optimizer"]["keyed"]
    jt = jax_trainer(toy_root, tmp_path / "jax", epochs=3, resume_from_checkpoint=ckpt)
    pt = port_trainer(toy_root, tmp_path / "port2", epochs=3, resume_from_checkpoint=ckpt)
    check_resumed_pair(jt, pt, keyed)


@pytest.mark.parametrize("cfg,frozen", [
    ({"grad_accum_steps": 2}, False),
    ({}, True),
    ({"grad_accum_steps": 2, "grad_clip_norm": None}, True),
    ({"_target_": "sgd", "momentum": 0.9, "weight_decay": 0.0}, False),
    ({"_target_": "sgd", "momentum": 0.8, "weight_decay": 0.1}, True),
])
def test_optimizer_variants_match_optax(cfg, frozen):
    """Four micro-steps of seeded gradients (the first clipped, the rest
    not) against optax, with the same tree paths and leaf values."""
    from isp_tts_tpu.training.optimizers import OptimizationConfig as JConfig
    from isp_tts_tpu.training.optimizers import build_optimizer as jax_build_optimizer
    from isp_tts_tpu_torch.config import build_config
    from isp_tts_tpu_torch.training.optimizers import OptimizationConfig, build_optimizer

    rng = np.random.RandomState(21)
    shapes = {"enc": {"w": (5, 3), "b": (3,)}, "dec": {"conv": (4, 3, 2), "s": (2, 1, 1)}}
    params = {m: {k: rng.randn(*s).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()}
    grads = [{m: {k: (scale * rng.randn(*s)).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()} for scale in (3.0, 0.01, 0.02, 0.05)]
    full = dict({"learning_rate": 2e-3, "weight_decay": 0.1, "grad_clip_norm": 1.0}, **cfg)
    mask = ({m: {k: m == "dec" for k in d} for m, d in shapes.items()} if frozen else None)
    tx, _ = jax_build_optimizer(JConfig(**full), params, mask)
    state = tx.init(params)
    jp = jax.tree.map(jnp.asarray, params)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)

    module = torch.nn.Module()
    for m, d in params.items():
        sub = torch.nn.Module()
        for k, v in d.items():
            sub.register_parameter(k, torch.nn.Parameter(t(v)))
        module.add_module(m, sub)
    trainable = {f"dec.{k}" for k in shapes["dec"]} if frozen else None
    opt, _ = build_optimizer(build_config(OptimizationConfig, full), module, trainable)
    for g in grads:
        for m, d in g.items():
            for k, v in d.items():
                module.get_parameter(f"{m}.{k}").grad = t(v)
        opt.step()
    for m, d in params.items():
        for k in d:
            np.testing.assert_allclose(module.get_parameter(f"{m}.{k}").detach().numpy(),
                                       np.asarray(jp[m][k]), atol=1e-6, err_msg=f"{m}.{k}")
    # the module's parameter names are not nnx paths: compare by leaf order
    paths, _ = jax.tree_util.tree_flatten_with_path(state)
    ours = opt.keyed_state()
    ref = {jax.tree_util.keystr(p).replace(".value", ""): np.asarray(v) for p, v in paths}
    ours = {k.replace(".value", ""): v for k, v in ours.items()}
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-6, err_msg=k)
