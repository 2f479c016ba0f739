"""Serving API: bucketed text -> mel synthesis.

Counterpart of ``isp_tts_tpu/serving.py:Synthesizer`` (the mel path). Inputs
are padded to the same text buckets, frame budgets and batch buckets as the
JAX package, so both serve the same shapes; here the model runs eagerly.
When the adaptor's frame count reaches the budget, the call is run again at
the next budget. Audio (vocoder, Griffin-Lim) is not ported yet.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .data.providers import TextProvider
from .models.acoustic.model import AcousticModel

logger = logging.getLogger("isp_tts_tpu_torch")


@dataclass
class SynthesizerConfig:
    text_buckets: tuple = (32, 64, 128, 256)
    frame_budgets: tuple = (256, 512, 1024, 2048)
    #: batch sizes round up to one of these (beyond the largest: to its next
    #: multiple), as in the JAX package
    batch_buckets: tuple = (1, 2, 4, 8, 16, 32)
    frames_per_token: float = 12.0  # frame-budget estimate before durations
    steps: int = 4
    extra_controls: dict = field(default_factory=dict)


def bucket(n: int, buckets: tuple) -> int:
    """The smallest bucket that holds ``n``."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"input of length {n} exceeds the largest bucket {buckets[-1]}")


def batch_bucket(n: int, buckets: tuple) -> int:
    """Batch sizes round up like the other dims; past the largest bucket,
    to its next multiple."""
    for b in buckets:
        if n <= b:
            return b
    return -(-n // buckets[-1]) * buckets[-1]


class Synthesizer:
    def __init__(self, model: AcousticModel, config: SynthesizerConfig | None = None):
        self.model = model.eval()
        self.config = config or SynthesizerConfig()
        dynamic = {"duration_factor", "pitch_factor", "pitch_delta",
                   "energy_factor", "energy_delta", "speaker"}
        clash = dynamic & set(self.config.extra_controls)
        if clash:
            raise ValueError(f"{sorted(clash)} are per-request controls: pass "
                             "them at call time, not in extra_controls")
        self.device = next(model.parameters()).device
        self._has_speaker = model.speaker_embedding is not None
        self.text_provider = TextProvider(model.encoding_map)

    @classmethod
    def from_pretrained(cls, path: str | Path, config: SynthesizerConfig | None = None,
                        device: str | torch.device | None = None) -> "Synthesizer":
        """Load a ``.ckpt`` acoustic checkpoint onto ``device`` (CUDA unless named)."""
        return cls(AcousticModel.from_pretrained(path, device=device), config)

    def prepare(self, texts: list[str], duration_factor: float = 1.0):
        """Token ids padded to the buckets: (tokens (Bb, tb) int32,
        lens (Bb,) int32, frame budget, number of real rows).

        Pad rows carry one <pad> token, so their softmax has a key."""
        encoded = [self.text_provider(t) for t in texts]
        max_len = max(e.size for e in encoded)
        tb = bucket(max_len, self.config.text_buckets)
        est_frames = int(max_len * self.config.frames_per_token
                         * max(duration_factor, 1.0))
        fb = bucket(min(est_frames, self.config.frame_budgets[-1]),
                    self.config.frame_budgets)
        Bb = batch_bucket(len(texts), self.config.batch_buckets)
        tokens = np.zeros((Bb, tb), np.int32)
        lens = np.ones((Bb,), np.int32)
        for i, e in enumerate(encoded):
            tokens[i, : e.size] = e
            lens[i] = e.size
        return tokens, lens, fb, len(texts)

    def __call__(self, text: str | list[str], seed: int = 0,
                 duration_factor: float = 1.0, pitch_factor: float = 1.0,
                 pitch_delta: float = 0.0, energy_factor: float = 1.0,
                 energy_delta: float = 0.0,
                 speaker: int | list[int] | None = None) -> list[np.ndarray]:
        """Synthesize mel(s): a list of (frames, n_mels) float32 arrays."""
        mel, dec_lens, B = self._synthesize_mel(
            text, seed, duration_factor, pitch_factor, pitch_delta,
            energy_factor, energy_delta, speaker)
        mel = mel[:B].float().cpu().numpy()
        return [mel[i, : int(dec_lens[i])] for i in range(B)]

    def _synthesize_mel(self, text: str | list[str], seed: int = 0,
                        duration_factor: float = 1.0, pitch_factor: float = 1.0,
                        pitch_delta: float = 0.0, energy_factor: float = 1.0,
                        energy_delta: float = 0.0,
                        speaker: int | list[int] | None = None):
        """Bucketed synthesis: the padded (Bb, budget, n_mels) mel on the
        model's device, the real rows' frame counts (numpy), and B."""
        texts = [text] if isinstance(text, str) else list(text)
        if speaker is not None and not self._has_speaker:
            raise ValueError("speaker control given but the checkpoint has no "
                             "speaker_embedding (single-speaker model)")
        tokens, lens, fb, B = self.prepare(texts, duration_factor)
        Bb = tokens.shape[0]
        spk = None
        if speaker is not None:
            ids = [speaker] * B if np.isscalar(speaker) else list(speaker)
            if len(ids) != B:
                raise ValueError(f"speaker list length {len(ids)} != batch {B}")
            spk = torch.zeros((Bb,), dtype=torch.long, device=self.device)
            spk[:B] = torch.tensor(ids, dtype=torch.long)
        tokens_t = torch.from_numpy(tokens).long().to(self.device)
        lens_t = torch.from_numpy(lens).to(self.device)
        budgets = self.config.frame_budgets
        while True:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            mel, ad = self.model.infer(
                tokens_t, text_lengths=lens_t, max_dec_len=fb,
                steps=self.config.steps, duration_factor=duration_factor,
                pitch_factor=pitch_factor, pitch_delta=pitch_delta,
                energy_factor=energy_factor, energy_delta=energy_delta,
                speaker=spk, generator=gen, **self.config.extra_controls)
            dec_lens = ad.dec_lengths[:B].cpu().numpy()
            # dec_lengths == budget means the adaptor clipped the durations
            # at the budget: run again at the next one; the largest budget's
            # saturation is reported, not hidden
            saturated = bool((dec_lens >= fb).any())
            if not saturated or fb >= budgets[-1]:
                if saturated:
                    logger.warning("largest frame budget %d saturated (dec_lens=%s); "
                                   "tail frames may be clipped", fb, dec_lens)
                break
            fb = bucket(fb + 1, budgets)
            logger.info("frame budget saturated; retrying at %d", fb)
        return mel, dec_lens, B
