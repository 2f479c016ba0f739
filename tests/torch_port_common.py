"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: carry a JAX module's parameters into its port counterpart,
perturb JAX parameters so zero-initialised ones (AdaLN) carry signal, and
run one training step (forward, loss, gradients) on each side."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from isp_tts_tpu.models.acoustic import loss as jloss
from isp_tts_tpu.models.base import flatten_state
from isp_tts_tpu_torch.models.acoustic import loss as ploss
from isp_tts_tpu_torch.models.base import torch_name
# the multi-KV-head scaffolding the smoke run uses on the committed checkpoint
from chip_smoke import attention_heads, multi_kv_head, replicate_kv_heads  # noqa: F401


#: a small acoustic model with every training module, soft durations on
_SMALL_LAYER = {"attention": {"heads": 2, "head_dim": 64, "one_kv_head": True,
                        "alibi_pos_bias": True},
          "feed_forward": {"inner_dim": 128, "activation": "gelu"}}
SMALL = {
    "encoding_map": {c: i for i, c in enumerate(["<pad>", "</s>", *"abcdefgh "])},
    "mel_dim": 16,
    "text_dim": 64,
    "encoder": {"dim": 64, "depth": 2, "transformer_layer": _SMALL_LAYER},
    "decoder": {"dim": 64, "depth": 2, "transformer_layer": _SMALL_LAYER},
    "temporal_adaptor": {
        "predictor": {"transformer": {"dim": 64, "depth": 2, "transformer_layer": dict(
            _SMALL_LAYER, attention=dict(_SMALL_LAYER["attention"], heads=3, alibi_symmetric=False))},
            "time_embedding_dim": 16},
        "embedding": {"transformer": {"dim": 64, "depth": 1, "transformer_layer": _SMALL_LAYER}},
        "pitch": True, "energy": True, "soft_duration": True},
    "aligner": {"attention_dim": 8, "key_kernel_size": 5, "query_kernel_size": 3},
    "num_speakers": 2,
}


#: SMALL with one key/value head per query head in every attention layer
SMALL_MHA = multi_kv_head(SMALL)


def jax_flat(module) -> dict[str, np.ndarray]:
    """A JAX module's parameters as {dotted name: np.ndarray}."""
    state = nnx.state(module, nnx.Not(nnx.RngState))
    pure = state.to_pure_dict() if hasattr(state, "to_pure_dict") else state
    return {k: np.asarray(v) for k, v in flatten_state(pure).items()}


def perturb(module, seed: int, scale: float = 0.1) -> dict[str, np.ndarray]:
    """Add seeded noise to every float parameter of a JAX module, in place;
    returns the new flat parameters."""
    rng = np.random.RandomState(seed)
    flat = {k: (v + scale * rng.randn(*v.shape)).astype(v.dtype)
            if np.issubdtype(v.dtype, np.floating) else v
            for k, v in jax_flat(module).items()}
    state = nnx.state(module, nnx.Not(nnx.RngState))
    _set(state, flat)
    nnx.update(module, state)
    return flat


def _set(state, flat, prefix=""):
    for k, v in state.items():
        name = f"{prefix}{k}"
        if hasattr(v, "items"):
            _set(v, flat, name + ".")
        elif name in flat:
            v.value = jnp.asarray(flat[name])


def carry(flat: dict[str, np.ndarray], module: torch.nn.Module) -> None:
    """Load JAX flat parameters into a port module (strict), through the
    same name and layout mapping as ``Model.load_jax_state``."""
    own = module.state_dict()
    out = {}
    for key, value in flat.items():
        name, transpose = torch_name(key)
        arr = np.asarray(value).T if transpose else np.asarray(value)
        out[name] = torch.from_numpy(np.array(arr)).to(own[name].dtype)
    module.load_state_dict(out, strict=True)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def flat_grads(grads) -> dict[str, np.ndarray]:
    pure = grads.to_pure_dict() if hasattr(grads, "to_pure_dict") else grads
    return {k: np.asarray(v) for k, v in flatten_state(pure).items()}


def assert_grads_match(jgrads: dict, model: torch.nn.Module, rtol: float):
    """Every JAX gradient against the port's, in the port's layout, to
    ``rtol`` of its max-abs."""
    assert len(jgrads) == len(list(model.parameters()))
    for key, g in jgrads.items():
        name, transpose = torch_name(key)
        ref = g.T if transpose else g
        ours = model.get_parameter(name).grad
        assert ours is not None, name
        scale = max(np.abs(ref).max(), 1e-12)
        err = np.abs(ours.numpy() - ref).max()
        assert err <= rtol * scale, f"{name}: {err:.3e} > {rtol} * {scale:.3e}"


def jax_step(jm, inputs, key):
    """(loss, loss dict, flat grads) of the JAX training step."""
    crit = jloss.AcousticModelLoss()

    def loss_fn(m):
        outputs = m(**{k: jnp.asarray(v) for k, v in inputs.items()}, key=key)
        return crit({k: jnp.asarray(v) for k, v in inputs.items()}, outputs, 0)

    # one compiled program: op-by-op autodiff of the whole model is slower
    (loss, losses), grads = nnx.jit(nnx.value_and_grad(loss_fn, has_aux=True))(jm)
    return float(loss), {k: float(v) for k, v in losses.items()}, flat_grads(grads)


def port_step(pm, inputs, x0, tt):
    """(loss, loss dict) of the port's step; gradients land in .grad."""
    crit = ploss.AcousticModelLoss()
    tin = {k: t(v) for k, v in inputs.items()}
    tin["text"] = tin["text"].long()
    tin["speaker"] = tin["speaker"].long()
    outputs = pm(**tin, noise=t(x0), t=t(tt))
    loss, losses = crit(tin, outputs, 0)
    loss.backward()
    return loss.item(), {k: v.item() for k, v in losses.items()}


def flow_draws(key, B, T):
    """The flow predictor's (x0, t) as the JAX model draws them from ``key``."""
    noise_key, time_key = jax.random.split(key)
    return (np.asarray(jax.random.normal(noise_key, (B, T, 3))),
            np.asarray(jax.random.uniform(time_key, (B,))))


#: the JAX end-to-end tests' tiny recipe model, at the head dim the port's
#: attention kernels take (64) and with every dropout off
_TINY_LAYER = {"attention": {"heads": 2, "head_dim": 64, "one_kv_head": True,
                             "alibi_pos_bias": True, "dropout": 0.0},
               "feed_forward": {"inner_dim": 32, "activation": "gelu", "dropout": 0.0}}
TINY_MODEL = {
    "_charset_": ["<pad>", "</s>", "#punct", "#en"],
    "text_dim": 16,
    "encoder": {"dim": 16, "depth": 1, "transformer_layer": _TINY_LAYER},
    "decoder": "${model.encoder}",
    "temporal_adaptor": {
        "predictor": {"time_embedding_dim": 8, "transformer": {
            "dim": 16, "depth": 1, "transformer_layer": _TINY_LAYER}},
        "embedding": {"transformer": {"dim": 16, "depth": 1, "transformer_layer": _TINY_LAYER}},
        "soft_duration": True},
    "aligner": {"attention_dim": 8, "key_kernel_size": 3, "query_kernel_size": 3},
}
SR = 22050


def write_toy_dataset(root, n: int = 8) -> None:
    """``n`` short sine-plus-noise WAVs and a ``meta.csv``: the JAX
    end-to-end tests' toy set, with a vibrato so that pitch statistics have
    a spread to keep past their outlier cut."""
    from isp_tts_tpu_torch.data.audio import write_wav

    (root / "wavs").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    texts = ["hello there.", "nice day!", "how are you?", "fine thanks.",
             "testing tts.", "one two three.", "red blue green.", "the end."]
    lines = []
    for i in range(n):
        k = int(SR * (0.3 + 0.05 * (i % 4)))
        tt = np.arange(k) / SR
        phase = 2 * np.pi * np.cumsum(130 + 20 * i + 15 * np.sin(2 * np.pi * 4 * tt)) / SR
        wav = 0.4 * np.sin(phase) + 0.03 * rng.randn(k)
        write_wav(root / "wavs" / f"u{i}.wav", wav.astype(np.float32), SR)
        lines.append(f"wavs/u{i}.wav|{texts[i % len(texts)]}")
    (root / "meta.csv").write_text("\n".join(lines) + "\n")


def toy_overrides(root, outdir, **trainer_over) -> dict:
    """Recipe overrides of ``acoustic/core`` for the toy set, both packages."""
    return {
        "dataset": {"root": str(root),
                    "stats": {"pitch": {"mean": 170.0, "std": 40.0},
                              "energy": {"mean": 0.0, "std": 1.0}}},
        "collator": {"text_pad_multiple": 16, "mel_pad_multiple": 32,
                     "max_mel_len": 64, "max_text_len": 16},
        "model": TINY_MODEL,
        "trainer": dict({"output_dir": str(outdir), "experiment_name": "e2e", "label": "run",
                         "epochs": 1, "batch_size": 4, "eval_batch_size": 4,
                         "eval_strategy": "no", "save_strategy": "no", "logging_steps": 1,
                         "progress": False, "log_with": [], "precision": "fp32",
                         "callbacks": {}}, **trainer_over),
    }
