"""The acoustic model: text ids -> mel, for training and synthesis.

Counterpart of ``isp_tts_tpu/models/acoustic/model.py:AcousticModel``: text
embedding, ALiBi-MQA encoder, the aligner on the detached encoder output
(training), optional speaker embedding, the flow temporal adaptor, length
regulation, the decoder and ``to_mel``. ``forward`` is the training
forward (``__call__`` there), ``infer`` the synthesis path. The mel is
channel-last, (B, frames, mel_dim), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch
from torch import nn

from ...config import as_dict, build_config
from ...nn.transformer import Transformer, TransformerConfig
from ...utils.masks import get_mask_from_lengths
from ..base import Model
from .adaptor import FlowTemporalAdaptor, FlowTemporalAdaptorConfig, TemporalAdaptorOutput
from .aligner import Aligner, AlignerConfig, AlignerOutput


class AcousticModelOutput(NamedTuple):
    mel: torch.Tensor  # (B, M, mel_dim)
    adaptor_output: TemporalAdaptorOutput
    aligner_output: AlignerOutput | None


@dataclass
class AcousticModelConfig:
    encoding_map: dict = None  # type: ignore  # the checkpoint's symbol -> id table
    mel_dim: int = 80
    text_dim: int = 384
    encoder: TransformerConfig = field(default_factory=TransformerConfig)
    decoder: TransformerConfig = field(default_factory=TransformerConfig)
    temporal_adaptor: FlowTemporalAdaptorConfig = field(
        default_factory=FlowTemporalAdaptorConfig)
    aligner: AlignerConfig = field(default_factory=AlignerConfig)
    num_speakers: int | None = 0
    pitch_mean: float | None = None
    pitch_std: float | None = None
    #: the mel contract the model was trained under (sample_rate, n_fft,
    #: hop_length, win_length, f_min, f_max); serving's Griffin-Lim and
    #: vocoder check read it, the model does not
    audio_config: dict | None = None


class AcousticModel(Model):
    Config = AcousticModelConfig

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
        self.aligner = Aligner(build_config(AlignerConfig, as_dict(cfg.aligner),
                                            mel_dim=cfg.mel_dim, text_dim=enc_cfg.dim))
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

    def forward(self, text: torch.Tensor, text_len: torch.Tensor, mel: torch.Tensor,
                mel_len: torch.Tensor, pitch: torch.Tensor | None = None,
                energy: torch.Tensor | None = None, speaker: torch.Tensor | None = None,
                noise: torch.Tensor | None = None, t: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> AcousticModelOutput:
        """Training forward.

        text (B, T) token ids, text_len (B,); mel (B, M, mel_dim) target mel
        (channel-last), mel_len (B,); pitch / energy (B, M) frame targets;
        speaker (B,) ids; noise (B, T, features) / t (B,) / generator: the
        flow predictor's draws.
        """
        T, M = text.shape[1], mel.shape[1]
        enc_mask = get_mask_from_lengths(text_len, T)
        enc_out = self.encoder(self.text_embedding(text), mask=enc_mask)
        aligner_output = self.aligner(mel, enc_out.detach(), mel_len, text_len)
        if self.speaker_embedding is not None and speaker is not None:
            enc_out = enc_out + self.speaker_embedding(speaker)[:, None, :]
        ad = self.temporal_adaptor(
            enc_out, enc_mask, M, aligner_output.attn_hard_duration,
            alignment=aligner_output.attn_soft, pitch_target_dense=pitch,
            energy_target_dense=energy, noise=noise, t=t, generator=generator)
        dec_mask = get_mask_from_lengths(ad.dec_lengths, M)
        mel_out = self.to_mel(self.decoder(ad.enc_out, mask=dec_mask))
        mel_out = mel_out * dec_mask[..., None].to(mel_out.dtype)
        return AcousticModelOutput(mel=mel_out, adaptor_output=ad,
                                   aligner_output=aligner_output)

    @staticmethod
    def inject_data_config(config: dict, dataset) -> dict:
        """The dataset's symbol table, pitch statistics and mel contract
        into the model config."""
        config["encoding_map"] = dict(dataset.text_provider.coding_table.encoding_map)
        if getattr(dataset, "stats", None) is not None:
            config["pitch_mean"] = float(dataset.stats.pitch.mean)
            config["pitch_std"] = float(dataset.stats.pitch.std)
        spec = getattr(dataset, "spec_provider", None)
        mel = getattr(dataset, "mel_scale_provider", None)
        audio = getattr(dataset, "audio_provider", None)
        if spec is not None and mel is not None and audio is not None:
            config["audio_config"] = {
                "sample_rate": int(audio.config.sample_rate),
                "n_fft": int(spec.config.n_fft),
                "hop_length": int(spec.config.hop_length),
                "win_length": int(spec.config.win_length),
                "f_min": float(mel.config.f_min),
                "f_max": None if mel.config.f_max is None else float(mel.config.f_max),
            }
        return config

    @classmethod
    def convert_torch_checkpoint(cls, config: dict, state: dict) -> tuple[dict, dict]:
        """A reference ``.pt``'s config and state in the port's schema and
        names, with the reference's ``gelu`` built as exact erf GELU."""
        from .interop import convert_torch_state, import_torch_config

        return import_torch_config(config), convert_torch_state(state)

    @staticmethod
    def prepare_inputs(batch: dict) -> dict:
        """A collated batch (the JAX collator's key names) -> forward kwargs."""
        return {"text": batch["text_vector"], "text_len": batch["text_vector_len"],
                "mel": batch["mel"], "mel_len": batch["mel_len"],
                "pitch": batch.get("pitch"), "energy": batch.get("energy"),
                "speaker": batch.get("speaker")}

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
