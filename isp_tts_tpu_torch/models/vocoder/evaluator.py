"""Vocoder evaluation metrics: the multi-resolution STFT distance, and a
real-against-generated mel figure (counterpart of
``isp_tts_tpu/models/vocoder/evaluator.py``).

The UnivNet/Parallel-WaveGAN multi-resolution STFT distance: spectral
convergence (each utterance's Frobenius ratio, then the batch mean) and the
log-magnitude L1, each averaged over three resolutions, through the matmul
STFT in float32. The figure needs matplotlib and is skipped without it.
"""

from __future__ import annotations

import logging

import torch

from ...ops.vocoder import _stft_matmul, log_mel_matmul

logger = logging.getLogger("isp_tts_tpu_torch")

_RESOLUTIONS = ((1024, 256), (2048, 512), (512, 128))


@torch.no_grad()
def multires_stft_distance(fake: torch.Tensor, real: torch.Tensor):
    """(spectral_convergence, log_mag_l1), 0-dim tensors averaged over
    three resolutions."""
    with torch.autocast(fake.device.type, enabled=False):
        fake, real = fake.float(), real.float()
        sc_total = torch.zeros((), device=fake.device)
        mag_total = torch.zeros((), device=fake.device)
        for n_fft, hop in _RESOLUTIONS:
            pad = (n_fft - hop) // 2
            fr, fi = _stft_matmul(fake, n_fft, hop, n_fft, pad)
            rr, ri = _stft_matmul(real, n_fft, hop, n_fft, pad)
            mag_f = torch.sqrt(fr * fr + fi * fi + 1e-9)
            mag_r = torch.sqrt(rr * rr + ri * ri + 1e-9)
            axes = tuple(range(1, mag_r.ndim))
            num = torch.sqrt(((mag_r - mag_f) ** 2).sum(dim=axes))
            den = torch.sqrt((mag_r ** 2).sum(dim=axes))
            sc_total = sc_total + (num / torch.clamp(den, min=1e-6)).mean()
            mag_total = mag_total + (torch.log(mag_f) - torch.log(mag_r)).abs().mean()
        n = float(len(_RESOLUTIONS))
        return sc_total / n, mag_total / n


class VocoderEvaluator:
    def __init__(self, model=None):
        self.model = model

    def __call__(self, inputs: dict, outputs) -> dict:
        sc, mag = multires_stft_distance(outputs.audio_fake, inputs["audio"])
        return {"metrics/spectral_convergence": sc, "metrics/log_stft_l1": mag}

    @torch.no_grad()
    def on_eval_epoch_end(self, inputs: dict, outputs) -> dict:
        f = self.model.features_config if self.model is not None else None
        if f is None:
            return {}
        try:
            from ...utils.plotting import plot_spectrogram
            import matplotlib  # noqa: F401
        except ImportError:
            logger.info("matplotlib is not installed: no evaluation figures")
            return {}

        def mel(audio):
            with torch.autocast(audio.device.type, enabled=False):
                return log_mel_matmul(audio[:1].float(), f.sample_rate, f.n_fft, f.hop_length,
                                      f.win_length, f.n_mels, f.f_min, f.f_max)[0].T

        return {"images/eval/vocoder_mel": plot_spectrogram({
            "real": mel(inputs["audio"]).cpu().numpy(),
            "generated": mel(outputs.audio_fake).cpu().numpy()})}
