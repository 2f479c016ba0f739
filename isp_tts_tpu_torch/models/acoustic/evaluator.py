"""Acoustic model metrics: MCD-13 and the alignment's length and strength
(counterpart of ``isp_tts_tpu/models/acoustic/evaluator.py``).

MCD: an ortho DCT-II of the log-mel to 13 cepstra, c0 dropped, the per-frame
L2 distance times 10 * sqrt(2) / ln(10), summed over valid frames over the
length, averaged over the batch. Alignment length: the argmax track's path
length over the diagonal's; strength: the mean of the per-frame maximum
attention. The evaluation dashboards draw with matplotlib where it is
installed and are skipped where it is not.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ...utils.masks import get_mask_from_lengths

logger = logging.getLogger("isp_tts_tpu_torch")

_LOGDB_CONST = 10.0 * np.sqrt(2.0) / np.log(10.0)


def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Ortho DCT-II basis, (n_mels, n_mfcc) float32
    (``torchaudio.functional.create_dct``)."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    basis = np.cos(np.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    basis[:, 0] *= 1.0 / np.sqrt(n_mels)
    basis[:, 1:] *= np.sqrt(2.0 / n_mels)
    return basis.astype(np.float32)


@torch.no_grad()
def mcd(mels_out: torch.Tensor, mels_target: torch.Tensor, mel_lens: torch.Tensor,
        n_mfcc: int = 13) -> torch.Tensor:
    """Mel-cepstral distortion of (B, M, n_mels) mels, a 0-dim tensor."""
    dct = torch.from_numpy(dct_matrix(n_mfcc, mels_out.shape[-1])).to(mels_out.device)
    mf_out = (mels_out.float() @ dct)[..., 1:]
    mf_tgt = (mels_target.float() @ dct)[..., 1:]
    mask = get_mask_from_lengths(mel_lens, mels_out.shape[1])
    frame_dist = torch.sqrt(((mf_out - mf_tgt) ** 2).sum(dim=2)) * mask
    return (_LOGDB_CONST * frame_dist.sum(dim=1) / mel_lens).mean()


@torch.no_grad()
def alignment_metrics(attn_soft: torch.Tensor, mel_lens: torch.Tensor,
                      text_lens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(alignment_length, alignment_strength) of soft attention (B, M, T)."""
    attn_soft = attn_soft.float()
    M = attn_soft.shape[1]
    track = torch.argmax(attn_soft, dim=2)
    diffs = (track[:, 1:] - track[:, :-1]).float()
    steps = torch.sqrt(1.0 + diffs ** 2) * get_mask_from_lengths(mel_lens, M)[:, 1:]
    diag_len = torch.sqrt(text_lens.float() ** 2 + mel_lens.float() ** 2)
    alignment_length = (steps.sum(dim=1) / diag_len).mean()
    max_attn = attn_soft.max(dim=2).values * get_mask_from_lengths(mel_lens, M)
    return alignment_length, max_attn.sum() / mel_lens.sum()


class AcousticModelEvaluator:
    """Per-batch metrics, and the first evaluation batch's figures."""

    def __init__(self, model=None, n_mfcc: int = 13):
        self.model = model
        self.n_mfcc = n_mfcc

    def __call__(self, inputs: dict, outputs) -> dict:
        metrics = {f"metrics/mcd_{self.n_mfcc}": mcd(
            outputs.mel, inputs["mel"], inputs["mel_len"], self.n_mfcc)}
        if outputs.aligner_output is not None:
            a_len, a_str = alignment_metrics(outputs.aligner_output.attn_soft,
                                             inputs["mel_len"], inputs["text_len"])
            metrics["metrics/alignment_length"] = a_len
            metrics["metrics/alignment_strength"] = a_str
        return metrics

    def on_eval_epoch_end(self, inputs: dict, outputs) -> dict:
        try:
            from ...utils.plotting import plot_attention, plot_spectrogram
            import matplotlib  # noqa: F401
        except ImportError:
            logger.info("matplotlib is not installed: no evaluation figures")
            return {}
        idx = 0
        filenames = inputs.get("filename")
        name = str(filenames[idx]) if filenames is not None else None
        text_len = int(inputs["text_vector_len"][idx] if "text_vector_len" in inputs
                       else inputs["text_len"][idx])
        mel_len = int(inputs["mel_len"][idx])

        def host(x):
            return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        images = {}
        if outputs.aligner_output is not None:
            al = outputs.aligner_output
            images["images/eval/alignment"] = plot_attention({
                "soft": host(al.attn_soft[idx, :mel_len, :text_len]).T,
                "hard": host(al.attn_hard[idx, :mel_len, :text_len]).T}, title=name)
        target = host(inputs["mel"][idx, :mel_len]).T
        pred = np.clip(host(outputs.mel[idx, :mel_len]).T, target.min(), target.max())
        images["images/eval/mel_spectrogram"] = plot_spectrogram(
            {"target": target, "predicted": pred}, title=name)
        return images
