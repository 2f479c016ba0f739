"""The acoustic model's synthesis path: text ids -> mel.

Counterpart of ``isp_tts_tpu/models/acoustic/model.py:AcousticModel.infer``:
text embedding, ALiBi-MQA encoder, optional speaker embedding, the flow
temporal adaptor, length regulation, the decoder and ``to_mel``. The
aligner is a training module and is not built here. The mel is channel-last,
(B, frames, mel_dim), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch import nn

from ...config import as_dict, build_config
from ...nn.transformer import Transformer, TransformerConfig
from ...utils.masks import get_mask_from_lengths
from ..base import Model
from .adaptor import FlowTemporalAdaptor, FlowTemporalAdaptorConfig, TemporalAdaptorOutput


@dataclass
class AcousticModelConfig:
    encoding_map: dict = None  # type: ignore  # the checkpoint's symbol -> id table
    mel_dim: int = 80
    text_dim: int = 384
    encoder: TransformerConfig = field(default_factory=TransformerConfig)
    decoder: TransformerConfig = field(default_factory=TransformerConfig)
    temporal_adaptor: FlowTemporalAdaptorConfig = field(
        default_factory=FlowTemporalAdaptorConfig)
    num_speakers: int | None = 0
    pitch_mean: float | None = None
    pitch_std: float | None = None


class AcousticModel(Model):
    Config = AcousticModelConfig
    #: parameter prefixes of training-only modules: a checkpoint's tensors
    #: under them are not loaded for synthesis
    training_only = ("aligner.",)

    def __init__(self, config: AcousticModelConfig):
        super().__init__()
        cfg = config
        if cfg.encoding_map is None:
            raise ValueError("encoding_map is required")
        self.config = cfg
        self.encoding_map = dict(cfg.encoding_map)
        self.mel_dim = cfg.mel_dim
        self.text_embedding = nn.Embedding(len(cfg.encoding_map), cfg.text_dim)
        enc_cfg = build_config(TransformerConfig, as_dict(cfg.encoder), emb_dim=cfg.text_dim)
        self.encoder = Transformer(enc_cfg)
        num_speakers = cfg.num_speakers or 0
        self.speaker_embedding = (nn.Embedding(num_speakers, enc_cfg.dim)
                                  if num_speakers > 0 else None)
        self.temporal_adaptor = FlowTemporalAdaptor(
            build_config(FlowTemporalAdaptorConfig, as_dict(cfg.temporal_adaptor),
                         encoder_dim=enc_cfg.dim))
        dec_cfg = build_config(TransformerConfig, as_dict(cfg.decoder), emb_dim=enc_cfg.dim)
        self.decoder = Transformer(dec_cfg)
        self.to_mel = nn.Linear(dec_cfg.dim, cfg.mel_dim)
        self.register_buffer("pitch_mean", torch.tensor(float(cfg.pitch_mean or 0.0)))
        self.register_buffer("pitch_std", torch.tensor(float(cfg.pitch_std or 1.0)))

    @torch.no_grad()
    def infer(self, input_sequence: torch.Tensor,
              text_lengths: torch.Tensor | None = None,
              max_dec_len: int = 2048,
              duration_target: torch.Tensor | None = None,
              duration_factor: float = 1.0,
              pitch_target: torch.Tensor | None = None,
              pitch_factor: float = 1.0,
              pitch_delta: float = 0.0,
              pitch_normalize: bool = False,
              energy_target: torch.Tensor | None = None,
              energy_factor: float = 1.0,
              energy_delta: float = 0.0,
              steps: int = 4,
              speaker: torch.Tensor | None = None,
              noise: torch.Tensor | None = None,
              generator: torch.Generator | None = None
              ) -> tuple[torch.Tensor, TemporalAdaptorOutput]:
        """(B, T) token ids -> ((B, max_dec_len, mel_dim) mel, adaptor output).

        Frames past ``adaptor_output.dec_lengths`` are zero. ``noise`` is the
        flow predictor's start point, (B, T, features); without it the noise
        is drawn from ``generator``.
        """
        B, T = input_sequence.shape
        if text_lengths is None:
            text_lengths = torch.full((B,), T, dtype=torch.int32,
                                      device=input_sequence.device)
        enc_mask = get_mask_from_lengths(text_lengths, T)
        enc_out = self.encoder(self.text_embedding(input_sequence), mask=enc_mask)
        if self.speaker_embedding is not None and speaker is not None:
            enc_out = enc_out + self.speaker_embedding(speaker)[:, None, :]
        if pitch_normalize:
            if pitch_target is not None:
                pitch_target = (pitch_target - self.pitch_mean) / self.pitch_std
            pitch_delta = pitch_delta / self.pitch_std
        ad = self.temporal_adaptor.infer(
            enc_out, enc_mask, max_dec_len=max_dec_len,
            duration_target=duration_target, duration_factor=duration_factor,
            pitch_target=pitch_target, pitch_factor=pitch_factor,
            pitch_delta=pitch_delta, energy_target=energy_target,
            energy_factor=energy_factor, energy_delta=energy_delta, steps=steps,
            noise=noise, generator=generator)
        dec_mask = get_mask_from_lengths(ad.dec_lengths, max_dec_len)
        mel = self.to_mel(self.decoder(ad.enc_out, mask=dec_mask))
        return mel * dec_mask[..., None].to(mel.dtype), ad
