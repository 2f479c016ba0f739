"""Acoustic model loss: mel MSE + flow loss + CTC alignment + binarization.

Counterpart of ``isp_tts_tpu/models/acoustic/loss.py``, with its loss-dict
names. The CTC term runs kernel K4 (``ops/ctc.py``) with ``ctc_impl``
"auto" or "pallas", and the plain scan, differentiated by autograd, with
"scan". Every term is computed in float32.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ...ops.ctc import ordered_ctc_neg_logp, ordered_ctc_neg_logp_reference
from ...utils.autocast import no_autocast
from ...utils.masks import get_mask_from_lengths, masked_mean


@dataclass
class WeightedLossConfig:
    weight: float = 1.0
    skip_steps: int = 0


def weight_loss(loss: torch.Tensor, cfg: WeightedLossConfig, step: int | None = None):
    """Scale by the weight; zero until ``skip_steps``."""
    if step is not None and cfg.skip_steps > 0 and step < cfg.skip_steps:
        return torch.zeros_like(loss)
    return cfg.weight * loss


@dataclass
class AttentionCTCLossConfig(WeightedLossConfig):
    blank_logprob: float = -1.0
    ctc_impl: str = "auto"  # auto | pallas: kernel K4; scan: the plain scan


@dataclass
class AttentionBinarizationLossConfig(WeightedLossConfig):
    eps: float = 1e-6


@dataclass
class AcousticLossConfig:
    mel_loss: WeightedLossConfig = field(default_factory=WeightedLossConfig)
    attention_loss: AttentionCTCLossConfig | None = field(
        default_factory=AttentionCTCLossConfig)
    attention_kl_loss: AttentionBinarizationLossConfig | None = field(
        default_factory=AttentionBinarizationLossConfig)


@no_autocast
def mel_loss_fn(mel_out, mel_target, mel_lens):
    """Masked MSE over valid frames (per-sample means, then the batch
    mean). mel: (B, M, n_mels)."""
    mask = get_mask_from_lengths(mel_lens, mel_out.shape[1])[..., None]
    return masked_mean((mel_out.float() - mel_target.float()) ** 2, mask)


@no_autocast
def attention_ctc_loss_fn(attn_logits, text_lens, mel_lens, blank_logprob=-1.0,
                          ctc_impl="auto"):
    """CTC forcing each text token to be visited in order: a blank column
    of fixed log-probability is put in front of (B, M, T), log-softmax over
    T+1, targets [1..text_len]; per-sample loss / text_len, batch mean, with
    infeasible (mel_len < text_len) or non-finite samples zeroed."""
    if ctc_impl not in ("auto", "pallas", "scan"):
        raise ValueError(f"unknown ctc_impl {ctc_impl!r}")
    padded = torch.nn.functional.pad(attn_logits.float(), (1, 0), value=blank_logprob)
    logprobs = padded.log_softmax(dim=2)
    tl = text_lens.to(torch.int32)
    ml = mel_lens.to(torch.int32)
    ctc = ordered_ctc_neg_logp_reference if ctc_impl == "scan" else ordered_ctc_neg_logp
    per_example = ctc(logprobs, tl, ml)
    per_example = per_example / text_lens.float().clamp_min(1.0)
    ok = (mel_lens >= text_lens) & torch.isfinite(per_example)
    return torch.where(ok, per_example, 0.0).mean()


@no_autocast
def attention_binarization_loss_fn(attn_soft, attn_hard, eps=1e-6):
    """-mean log(soft attention) at the hard-attention positions."""
    log_soft = torch.log(attn_soft.float().clamp_min(eps))
    return -(log_soft * attn_hard).sum() / attn_hard.sum().clamp_min(1.0)


class AcousticModelLoss:
    """Callable criterion: (inputs, outputs, step) -> (loss, loss_dict)."""

    Config = AcousticLossConfig

    def __init__(self, config: AcousticLossConfig | None = None):
        self.config = config or AcousticLossConfig()

    def __call__(self, inputs: dict, outputs, step: int | None = None):
        cfg = self.config
        losses = {}
        loss = losses["model/mel_loss"] = weight_loss(
            mel_loss_fn(outputs.mel, inputs["mel"], inputs["mel_len"]), cfg.mel_loss, step)
        for key, value in (outputs.adaptor_output.losses or {}).items():
            losses[f"adaptor/{key}"] = value
            loss = loss + value
        aligned = outputs.aligner_output
        if cfg.attention_loss is not None and aligned is not None:
            attn = weight_loss(attention_ctc_loss_fn(
                aligned.attn_logits, inputs["text_len"], inputs["mel_len"],
                cfg.attention_loss.blank_logprob, cfg.attention_loss.ctc_impl),
                cfg.attention_loss, step)
            losses["aligner/attention_loss"] = attn
            loss = loss + attn
        if cfg.attention_kl_loss is not None and aligned is not None:
            kl = weight_loss(attention_binarization_loss_fn(
                aligned.attn_soft, aligned.attn_hard, cfg.attention_kl_loss.eps),
                cfg.attention_kl_loss, step)
            losses["aligner/kl_loss"] = kl
            loss = loss + kl
        return loss, losses
