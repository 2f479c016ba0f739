"""Reference ``.pt`` interop for the acoustic model: the reference's
parameter names onto the port's, and back.

Counterpart of ``isp_tts_tpu/models/acoustic/interop.py``. The port keeps
torch layouts (Linear ``(out, in)``, Conv1d ``(out, in, k)``, Embedding
``(vocab, dim)``, LayerNorm ``weight``), so a reference tensor moves as it
is and only its name changes. The rules, copied from the JAX package's:

- ``aligner.attention.X`` -> ``aligner.X`` (ConvAttention folded into the
  Aligner);
- ``feed_forward.net.0`` / ``.net.3`` -> ``feed_forward.fc1`` / ``.fc2``;
- ``rel_pos.learned_logslopes`` -> ``rel_pos.log_slopes``;
- ``linear_layer`` -> ``linear``; ``time_embedding.mlp.0`` / ``.mlp.2`` ->
  ``time_embedding.fc1`` / ``.fc2``;
- a plain LayerNorm ``attention_norm.weight`` / ``feed_forward_norm.bias``
  -> ``attention_norm.norm.weight`` / ``feed_forward_norm.norm.bias`` (the
  port's wrapper nests it); the AdaLN Linears, literally named
  ``..._norm.weight.weight`` and so on, keep their names;
- the buffers ``...freq_emb.freq_scale`` and ``...attend...`` do not travel.

:func:`export_torch_state` is the inverse, and adds the flow time
embedding's ``freq_scale`` buffer the reference's strict load expects.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# reference -> port rewrites, applied in order
_NAME_RULES: list[tuple[str, str]] = [
    (r"^aligner\.attention\.", "aligner."),
    (r"\.feed_forward\.net\.0\.", ".feed_forward.fc1."),
    (r"\.feed_forward\.net\.3\.", ".feed_forward.fc2."),
    (r"\.rel_pos\.learned_logslopes$", ".rel_pos.log_slopes"),
    (r"\.linear_layer\.", ".linear."),
    (r"\.time_embedding\.mlp\.0\.", ".time_embedding.fc1."),
    (r"\.time_embedding\.mlp\.2\.", ".time_embedding.fc2."),
    # a plain LayerNorm directly under the layer's norm slot (AdaLN's
    # Linears sit one level deeper and do not match)
    (r"^(.*(?:attention_norm|feed_forward_norm))\.(weight|bias)$", r"\1.norm.\2"),
]

# port -> reference rewrites, the inverse of _NAME_RULES
_EXPORT_NAME_RULES: list[tuple[str, str]] = [
    (r"^(.*(?:attention_norm|feed_forward_norm))\.norm\.(weight|bias)$", r"\1.\2"),
    (r"^aligner\.", "aligner.attention."),
    (r"\.feed_forward\.fc1\.", ".feed_forward.net.0."),
    (r"\.feed_forward\.fc2\.", ".feed_forward.net.3."),
    (r"\.rel_pos\.log_slopes$", ".rel_pos.learned_logslopes"),
    (r"\.linear\.", ".linear_layer."),
    (r"\.time_embedding\.fc1\.", ".time_embedding.mlp.0."),
    (r"\.time_embedding\.fc2\.", ".time_embedding.mlp.2."),
]

#: the port's 0-d buffers
_SCALARS = ("pitch_mean", "pitch_std")
FREQ_SCALE_KEY = "temporal_adaptor.predictor.time_embedding.freq_emb.freq_scale"


def _rewrite(name: str, rules) -> str:
    for pattern, repl in rules:
        name = re.sub(pattern, repl, name)
    return name


def _numpy(value) -> np.ndarray:
    if hasattr(value, "detach"):
        value = value.detach().cpu()
        # numpy has no bfloat16: widen it exactly
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    return np.asarray(value)


def convert_torch_state(torch_state: dict) -> dict[str, np.ndarray]:
    """{reference name: tensor or array} -> {port name: array}, layouts kept."""
    out: dict[str, np.ndarray] = {}
    for name, value in torch_state.items():
        # buffers that don't travel as parameters
        if name.endswith(".freq_emb.freq_scale") or ".attend." in name:
            continue
        value = _numpy(value)
        if name in _SCALARS and value.size == 1:
            value = value.reshape(())  # written (1,): ascontiguousarray lifts 0-d arrays
        out[_rewrite(name, _NAME_RULES)] = value
    return out


def export_torch_state(state: dict, freq_scale: float | None = 1000.0) -> dict[str, np.ndarray]:
    """{port name: tensor or array} -> {reference name: array}: the inverse
    of :func:`convert_torch_state`. ``freq_scale`` fills the flow time
    embedding's persistent buffer (the reference's default is 1000) when
    the predictor is present."""
    out = {_rewrite(name, _EXPORT_NAME_RULES): _numpy(value)
           for name, value in state.items()}
    if freq_scale is not None and any(".predictor.time_embedding." in k for k in out):
        out[FREQ_SCALE_KEY] = np.asarray([freq_scale], dtype=np.float32)
    return out


# the reference's one "gelu" is exact erf; the port's "gelu" is the tanh
# approximation and "gelu_exact" the erf one, as in the JAX package
_TORCH_ACTIVATIONS = {"gelu_exact": "gelu", "gelu": "gelu"}


def _map_activations(node, fix):
    if isinstance(node, dict):
        return {k: (fix(v) if k == "activation" else _map_activations(v, fix))
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map_activations(v, fix) for v in node]
    return node


def export_torch_config(config: dict) -> dict:
    """A port model config in the reference's schema: the same keys, with
    both GELU flavours named ``gelu``."""
    return _map_activations(config, lambda v: _TORCH_ACTIVATIONS.get(v, v))


def import_torch_config(config: dict) -> dict:
    """The inverse of :func:`export_torch_config`: a reference ``gelu`` is
    torch's exact ``nn.GELU``, so the port builds ``gelu_exact``."""
    return _map_activations(config, lambda v: "gelu_exact" if v == "gelu" else v)
