"""Torch Vocos checkpoint interop: an official-layout Vocos generator as the
port's :class:`~isp_tts_tpu_torch.models.vocoder.model.VocoderModel`, and
back.

Counterpart of ``isp_tts_tpu/models/vocoder/interop.py``. Inputs are
TorchScript files (``.pts``, or a ``.pt`` that ``torch.jit.load`` reads) and
plain state dicts (``.pt``, ``.pth``, ``pytorch_model.bin``), optionally
under a ``state_dict`` key or one shared wrapper prefix. State dicts load
with ``weights_only=True`` only: a pickled module is refused, never
unpickled.

The port keeps torch layouts, so tensors move as they are and only names
change (the JAX package's rules):

- ``backbone.embed`` -> ``generator.embed``;
- ``backbone.norm`` -> ``generator.norm_pre``;
- ``backbone.convnext.{i}`` -> ``generator.blocks.{i}`` (dwconv, norm,
  pwconv1, pwconv2, gamma);
- ``backbone.final_layer_norm`` -> ``generator.norm_post``;
- ``head.out`` -> ``generator.head``;
- ``feature_extractor.*`` and the ``head.istft.*`` buffers are dropped (the
  port builds its own mel front end and iSTFT window).

The loaded generator runs torch Vocos's own math: erf GELU
(``gelu="exact"``) and the log-magnitude clipped from above only, at
log(100) (``min_log_mag=None``).
"""

from __future__ import annotations

import logging
import re
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("isp_tts_tpu_torch")

# official Vocos -> port rewrites; the first that matches applies
_NAME_RULES: list[tuple[str, str]] = [
    (r"^backbone\.embed\.", "generator.embed."),
    (r"^backbone\.norm\.", "generator.norm_pre."),
    (r"^backbone\.convnext\.(\d+)\.", r"generator.blocks.\1."),
    (r"^backbone\.final_layer_norm\.", "generator.norm_post."),
    (r"^head\.out\.", "generator.head."),
]

# port -> official Vocos rewrites, the inverse
_EXPORT_NAME_RULES: list[tuple[str, str]] = [
    (r"^generator\.embed\.", "backbone.embed."),
    (r"^generator\.norm_pre\.", "backbone.norm."),
    (r"^generator\.blocks\.(\d+)\.", r"backbone.convnext.\1."),
    (r"^generator\.norm_post\.", "backbone.final_layer_norm."),
    (r"^generator\.head\.", "head.out."),
]

#: buffers the port builds itself (mel filterbank, iSTFT window)
_DROP = re.compile(r"^(feature_extractor\.|head\.istft\.)")

TORCH_SUFFIXES = (".pt", ".pts", ".pth", ".bin")


def _first_rule(name: str, rules) -> str | None:
    for pattern, repl in rules:
        new = re.sub(pattern, repl, name)
        if new != name:
            return new
    return None


def _float32(value) -> np.ndarray:
    if hasattr(value, "detach"):
        return value.detach().cpu().float().numpy()
    return np.asarray(value, dtype=np.float32)


def _strip_wrapper_prefix(state: dict) -> dict:
    """Strip one wrapper attribute shared by every key (``model.backbone...``)
    when no key starts with an official root."""
    roots = ("backbone.", "head.", "feature_extractor.")
    if any(k.startswith(roots) for k in state):
        return state
    prefixes = {k.split(".", 1)[0] for k in state if "." in k}
    if len(prefixes) == 1:
        p = next(iter(prefixes)) + "."
        inner = {k[len(p):]: v for k, v in state.items() if k.startswith(p)}
        if any(k.startswith(roots) for k in inner):
            return inner
    return state


def convert_vocos_state(torch_state: dict) -> dict[str, np.ndarray]:
    """{official Vocos name: tensor or array} -> {port name: float32 array}.

    Unrecognised keys are dropped with a warning; :func:`load_torch_vocoder`
    then requires exact coverage of the generator, so another network
    raises rather than half-loads."""
    out: dict[str, np.ndarray] = {}
    for name, value in _strip_wrapper_prefix({str(k): v for k, v in torch_state.items()}
                                             ).items():
        if _DROP.match(name):
            continue
        new = _first_rule(name, _NAME_RULES)
        if new is None:
            logger.warning("convert_vocos_state: unrecognized key %s", name)
            continue
        out[new] = _float32(value)
    return out


def infer_generator_config(flat: dict[str, np.ndarray], hop_length: int) -> dict:
    """The generator config of converted weights, from their shapes."""
    embed = flat["generator.embed.weight"]  # (dim, n_mels, 7)
    head = flat["generator.head.weight"]  # (n_fft + 2, dim)
    pw1 = flat["generator.blocks.0.pwconv1.weight"]  # (intermediate, dim)
    num_layers = 1 + max(int(m.group(1)) for k in flat
                         if (m := re.match(r"generator\.blocks\.(\d+)\.", k)))
    return {"n_mels": int(embed.shape[1]), "dim": int(embed.shape[0]),
            "intermediate_dim": int(pw1.shape[0]), "num_layers": num_layers,
            "n_fft": int(head.shape[0]) - 2, "hop_length": hop_length,
            # torch Vocos's math: erf GELU, magnitude clipped from above at 1e2
            "gelu": "exact", "max_log_mag": float(np.log(100.0)), "min_log_mag": None}


def features_config(gen_cfg: dict, hop_length: int, sample_rate: int, f_min: float,
                    f_max: float | None) -> dict:
    """The mel contract of a Vocos generator: what the weights do not say
    (hop, sample rate, band) is given."""
    return {"sample_rate": sample_rate, "n_fft": gen_cfg["n_fft"], "hop_length": hop_length,
            "win_length": gen_cfg["n_fft"], "n_mels": gen_cfg["n_mels"], "f_min": f_min,
            "f_max": f_max}


def export_vocos_state(state: dict) -> dict[str, np.ndarray]:
    """{port name: tensor or array} -> {official Vocos name: float32 array},
    the inverse of :func:`convert_vocos_state`; the discriminators have no
    counterpart in a Vocos checkpoint and are left out."""
    out = {}
    for name, value in state.items():
        new = _first_rule(name, _EXPORT_NAME_RULES)
        if new is not None:
            out[new] = _float32(value)
    return out


def save_torch_vocoder(model, path: str | Path, fp16: bool = False) -> None:
    """Write a port :class:`VocoderModel`'s generator as a torch Vocos state
    dict (the official ``charactr/vocos`` names and layouts); ``fp16``
    halves the tensors as the reference's ``vocos_ms_fp16.pts`` does. Warns
    where the generator's GELU or magnitude clip is not torch Vocos's: the
    weights load there all the same, but run torch Vocos's math."""
    cfg = model.generator.config
    if cfg.gelu != "exact":
        logger.warning("save_torch_vocoder: generator uses tanh GELU; official torch Vocos "
                       "applies exact-erf GELU to these weights")
    if cfg.min_log_mag is not None or not np.isclose(cfg.max_log_mag, np.log(100.0)):
        logger.warning("save_torch_vocoder: generator clips log-magnitude to [%s, %s]; "
                       "official torch Vocos clips only from above at log(100)",
                       cfg.min_log_mag, cfg.max_log_mag)
    tensors = {k: torch.from_numpy(v) for k, v in export_vocos_state(model.state_dict()).items()}
    if fp16:
        tensors = {k: v.half() for k, v in tensors.items()}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(tensors, str(path))
    logger.info("saved torch Vocos state dict to %s (%d tensors%s)", path, len(tensors),
                ", fp16" if fp16 else "")


def read_torch_vocos(path: str | Path) -> dict:
    """The tensors of a TorchScript module or of a plain state dict."""
    p = Path(path)
    try:
        return dict(torch.jit.load(str(p), map_location="cpu").state_dict())
    except Exception:  # noqa: BLE001 - not TorchScript: a state dict, or refused
        pass
    try:
        obj = torch.load(str(p), map_location="cpu", weights_only=True)
    except Exception as e:
        raise ValueError(f"{p}: neither TorchScript nor a plain tensor state dict ({e}). "
                         "Pickled torch modules are not loaded (they run code from the "
                         "file); save the module's .state_dict() instead") from e
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"{p}: not a torch module or state dict")
    return obj


def load_torch_vocoder(path: str | Path, hop_length: int = 256, sample_rate: int = 22050,
                       f_min: float = 0.0, f_max: float | None = 8000.0,
                       device: str | torch.device | None = None):
    """A torch Vocos checkpoint as a port :class:`VocoderModel` in eval mode
    on ``device`` (CUDA unless named). The hop, sample rate and band are
    not in the weights; the defaults are the reference's mel contract
    (22.05 kHz, hop 256). Raises ``ValueError`` unless the converted weights
    cover every generator tensor, no more and no fewer; the discriminators
    keep their initial values."""
    from ...config import build_config
    from ...utils.device import resolve_device
    from .model import VocoderModel, VocoderModelConfig

    dev = resolve_device(device)
    state = read_torch_vocos(path)
    flat = convert_vocos_state(state)
    if "generator.embed.weight" not in flat:
        raise ValueError(f"{path}: no Vocos backbone found (keys: {sorted(state)[:5]}...)")
    gen_cfg = infer_generator_config(flat, hop_length)
    model = VocoderModel(build_config(VocoderModelConfig, {
        "generator": gen_cfg,
        "features": features_config(gen_cfg, hop_length, sample_rate, f_min, f_max)}))
    own = model.state_dict()
    want = {k for k in own if k.startswith("generator.")}
    missing, extra = sorted(want - set(flat)), sorted(set(flat) - want)
    if missing or extra:
        raise ValueError(f"{path}: not an exact Vocos generator layout: missing "
                         f"{missing[:4]}{'...' if len(missing) > 4 else ''}, unmapped "
                         f"{extra[:4]}{'...' if len(extra) > 4 else ''}")
    model.load_port_state({**{k: v for k, v in own.items() if k not in want}, **flat})
    logger.info("loaded torch Vocos vocoder from %s: %d tensors, dim=%d, layers=%d, n_fft=%d",
                path, len(flat), gen_cfg["dim"], gen_cfg["num_layers"], gen_cfg["n_fft"])
    return model.to(dev).eval()
