"""Vocoder GAN losses: adversarial, feature matching and mel reconstruction.

Counterpart of ``isp_tts_tpu/models/vocoder/loss.py`` (HiFi-GAN/Vocos):

- generator: L_adv(G) + fm_weight * L_fm + mel_weight * L_mel;
- discriminator: L_adv(D);

``adversarial`` selects LSGAN or hinge. Each logit and feature is taken to
float32 before its mean. The mel loss is L1 on the matmul log-mel
(:func:`~isp_tts_tpu_torch.ops.vocoder.log_mel_matmul`) with autocast off,
as the JAX package computes it in float32. ``__call__`` is the trainer's
criterion contract for evaluation batches (the generator's reconstruction
metrics).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ...ops.vocoder import log_mel_matmul


@dataclass
class VocoderGANLossConfig:
    mel_weight: float = 45.0
    fm_weight: float = 2.0
    adversarial: str = "lsgan"  # or "hinge"
    #: the mel contract of the reconstruction loss; the GANTrainer copies
    #: the model's feature config over these
    sample_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float | None = 8000.0


class VocoderGANLoss:
    Config = VocoderGANLossConfig

    def __init__(self, config: VocoderGANLossConfig | None = None, **kw):
        self.config = config or VocoderGANLossConfig(**kw)
        if self.config.adversarial not in ("lsgan", "hinge"):
            raise KeyError(f"Unknown adversarial loss {self.config.adversarial!r}")

    def _mel(self, audio: torch.Tensor) -> torch.Tensor:
        c = self.config
        with torch.autocast(audio.device.type, enabled=False):
            return log_mel_matmul(audio.float(), c.sample_rate, c.n_fft, c.hop_length,
                                  c.win_length, c.n_mels, c.f_min, c.f_max)

    def mel_loss(self, fake: torch.Tensor, mel_real: torch.Tensor) -> torch.Tensor:
        return (self._mel(fake) - mel_real.float()).abs().mean()

    def disc_loss(self, discriminator, real: torch.Tensor, fake: torch.Tensor):
        """(loss, metrics); ``fake`` must be detached by the caller."""
        logits_r, _ = discriminator(real)
        logits_f, _ = discriminator(fake)
        loss = torch.zeros((), device=real.device)
        for lr, lf in zip(logits_r, logits_f):
            lr, lf = lr.float(), lf.float()
            if self.config.adversarial == "lsgan":
                loss = loss + ((1.0 - lr) ** 2).mean() + (lf ** 2).mean()
            else:
                loss = loss + torch.relu(1.0 - lr).mean() + torch.relu(1.0 + lf).mean()
        return loss, {"losses/disc": loss}

    def gen_loss(self, discriminator, real: torch.Tensor, fake: torch.Tensor,
                 mel_real: torch.Tensor, feats_real=None):
        """(loss, metrics): adversarial + feature matching on the real
        features (detached) + mel. ``feats_real`` reuses the real audio's
        features when the caller has them."""
        cfg = self.config
        logits_f, feats_f = discriminator(fake)
        if feats_real is None:
            _, feats_real = discriminator(real.detach())
        adv = torch.zeros((), device=fake.device)
        for lf in logits_f:
            lf = lf.float()
            adv = adv + (((1.0 - lf) ** 2).mean() if cfg.adversarial == "lsgan" else -lf.mean())
        fm = torch.zeros((), device=fake.device)
        for fr_list, ff_list in zip(feats_real, feats_f):
            for fr, ff in zip(fr_list, ff_list):
                fm = fm + (ff.float() - fr.detach().float()).abs().mean()
        mel = self.mel_loss(fake, mel_real)
        total = adv + cfg.fm_weight * fm + cfg.mel_weight * mel
        return total, {"losses/gen_adv": adv, "losses/feature_matching": fm,
                       "losses/mel": mel}

    def __call__(self, inputs: dict, outputs, step=None):
        """The generator's evaluation: mel reconstruction and waveform L1."""
        mel = self.mel_loss(outputs.audio_fake, outputs.mel)
        wave_l1 = (outputs.audio_fake.float() - inputs["audio"].float()).abs().mean()
        return self.config.mel_weight * mel, {"losses/mel": mel, "losses/wave_l1": wave_l1}
