"""Serving API: bucketed text -> mel and text -> waveform synthesis.

Counterpart of ``isp_tts_tpu/serving.py:Synthesizer``. Inputs are padded to
the same text buckets, frame budgets and batch buckets as the JAX package,
so both serve the same shapes; here the model runs eagerly. When the
adaptor's frame count reaches the budget, the call is run again at the next
budget. The audio path vocodes the padded mel, (Bb, budget, n_mels), with
the attached neural vocoder, or without one with the matmul Griffin-Lim, on
the model's device; clips to [-1, 1]; and keeps ``dec_len * hop`` samples of
each row, as the JAX package's fused audio program does.

``Synthesizer(..., devices=[...])`` is the counterpart of the JAX
``Synthesizer(mesh=...)``: one process serves one batch over several
cards, with the acoustic model and the vocoder replicated on each. Batch
buckets round up to a multiple of the card count, so the shards are
equal; the flow noise of the whole padded batch is drawn once, on the
first card, and split, so the rows equal one card's; every shard is
launched before any is waited for. It is an equivalence counterpart, not a
way to more requests per second: one thread issues the replicas in turn,
and a request is host-bound, so a batch over N cards takes about N times
one card's host time. For throughput run one daemon a card
(``serving_server --device cuda:i``).
"""

from __future__ import annotations

import copy
import logging
import re
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .data.providers import TextProvider
from .data.text.table import CodingTable
from .models.acoustic.model import AcousticModel
from .ops.vocoder import mel_to_audio_tpu

logger = logging.getLogger("isp_tts_tpu_torch")

#: the mel contract of the JAX package's data-provider defaults, for
#: checkpoints that carry no ``audio_config``
DEFAULT_AUDIO_GEOMETRY = {"sample_rate": 22050, "n_fft": 1024, "hop_length": 256,
                          "win_length": 1024, "f_min": 0.0, "f_max": 8000.0}

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "fp16": torch.float16,
           "float16": torch.float16, "fp32": torch.float32, "float32": torch.float32}


def split_sentences(text: str) -> list[str]:
    """Sentence split for long-form synthesis (``Synthesizer.synthesize_long``
    and the daemon's streaming endpoint)."""
    return [p.strip() for p in re.split(r"(?<=[.!?…])\s+", text.strip()) if p.strip()]


def _promoting_forward(mod: torch.nn.Module):
    """A forward for ``mod`` that computes as flax does on weights stored
    in a narrower dtype: the activation and the weight promote to their
    common dtype (a float32 activation against a bf16 kernel computes in
    float32); LayerNorm normalises in float32 and returns the promoted
    dtype; an embedding lookup returns float32, as flax's ``Embed`` does."""
    if isinstance(mod, torch.nn.Linear):
        def forward(x):
            dt = torch.promote_types(x.dtype, mod.weight.dtype)
            return F.linear(x.to(dt), mod.weight.to(dt),
                            None if mod.bias is None else mod.bias.to(dt))
    elif isinstance(mod, torch.nn.Conv1d):
        def forward(x):
            dt = torch.promote_types(x.dtype, mod.weight.dtype)
            return mod._conv_forward(x.to(dt), mod.weight.to(dt),
                                     None if mod.bias is None else mod.bias.to(dt))
    elif isinstance(mod, torch.nn.LayerNorm):
        def forward(x):
            dt = torch.promote_types(x.dtype, mod.weight.dtype)
            return F.layer_norm(x.float(), mod.normalized_shape, mod.weight.float(),
                                mod.bias.float(), mod.eps).to(dt)
    elif isinstance(mod, torch.nn.Embedding):
        def forward(x):
            return F.embedding(x, mod.weight).float()
    else:
        return None
    return forward


@torch.no_grad()
def store_float_state(module: torch.nn.Module, dtype: str | torch.dtype) -> None:
    """Store every float parameter and buffer of ``module`` in ``dtype``
    (bf16: half the bytes) and compute as the JAX package's served models
    do with such weights: flax promotes each bf16 weight against the
    float32 activations (the acoustic model's text embedding already
    returns float32, the vocoder takes a float32 mel), so every product
    and norm runs in float32 on the stored values. Modules other than
    Linear, Conv1d, LayerNorm and Embedding (the vocoder's flax-style
    LayerNorm, its layer scales) promote by torch's own rules."""
    target = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    module.to(target)
    for mod in module.modules():
        forward = _promoting_forward(mod)
        if forward is not None:
            mod.forward = forward


@dataclass
class SynthesizerConfig:
    text_buckets: tuple = (32, 64, 128, 256)
    frame_budgets: tuple = (256, 512, 1024, 2048)
    #: batch sizes round up to one of these (beyond the largest: to its next
    #: multiple), as in the JAX package
    batch_buckets: tuple = (1, 2, 4, 8, 16, 32)
    frames_per_token: float = 12.0  # frame-budget estimate before durations
    steps: int = 4
    charset: tuple | None = None  # None: the checkpoint's own encoding_map
    phonemizer: bool = False
    language: str = "en-us"  # the phonemizer's language
    extra_controls: dict = field(default_factory=dict)
    #: serve with float weights in this dtype (e.g. "bf16"): the acoustic
    #: model and the vocoder store them so (half the bytes) and compute as
    #: flax does, promoting against float32 activations
    weights_dtype: str | None = None


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


def _replicas(module: torch.nn.Module, devices: list[torch.device]) -> list:
    """``module`` on the first of ``devices`` and a copy on each other."""
    first = module.to(devices[0])
    return [first] + [copy.deepcopy(first).to(d) for d in devices[1:]]


class Synthesizer:
    def __init__(self, model: AcousticModel, config: SynthesizerConfig | None = None,
                 vocoder=None, devices: list | None = None):
        """``devices``: serve each batch over these (one replica each, the
        first holding ``model``); None serves on ``model``'s device."""
        if devices is not None and not devices:
            raise ValueError("devices must name at least one device")
        self.devices = ([torch.device(d) for d in devices] if devices is not None
                        else [next(model.parameters()).device])
        self.replicas = _replicas(model.eval(), self.devices)
        model = self.model = self.replicas[0]
        self.config = config or SynthesizerConfig()
        dynamic = {"duration_factor", "pitch_factor", "pitch_delta",
                   "energy_factor", "energy_delta", "speaker"}
        clash = dynamic & set(self.config.extra_controls)
        if clash:
            raise ValueError(f"{sorted(clash)} are per-request controls: pass "
                             "them at call time, not in extra_controls")
        if self.config.weights_dtype is not None:
            for replica in self.replicas:
                store_float_state(replica, self.config.weights_dtype)
        self.device = self.devices[0]
        self._has_speaker = model.speaker_embedding is not None
        if self.config.charset is not None:
            table = CodingTable.from_charset(list(self.config.charset))
            if dict(table.encoding_map) != dict(model.encoding_map):
                raise ValueError(
                    "Synthesizer charset disagrees with the checkpoint's encoding_map: "
                    "tokens would hit wrong embeddings. Pass charset=None to use the "
                    "checkpoint's own table.")
        else:
            table = CodingTable.from_encoding_map(model.encoding_map)
        self.text_provider = TextProvider(table, phonemizer=self.config.phonemizer,
                                          language=self.config.language)
        self.vocoder = None
        self.vocoders: list = []
        if vocoder is not None:
            self.attach_vocoder(vocoder)

    def attach_vocoder(self, vocoder) -> None:
        """Serve waveforms through ``vocoder`` (a ``VocoderModel`` on the
        model's device; replicated on the others)."""
        dev = next(vocoder.parameters()).device
        if dev != self.device:
            raise ValueError(f"the vocoder is on {dev}, the acoustic model on {self.device}")
        self.vocoders = _replicas(vocoder.eval(), self.devices)
        self.vocoder = self.vocoders[0]
        if self.config.weights_dtype is not None:
            for replica in self.vocoders:
                store_float_state(replica, self.config.weights_dtype)
        self._check_vocoder_contract(vocoder)

    @classmethod
    def from_pretrained(cls, path: str | Path, config: SynthesizerConfig | None = None,
                        vocoder_path: str | Path | None = None,
                        device: str | torch.device | None = None,
                        devices: list | None = None) -> "Synthesizer":
        """Load a ``.ckpt`` (or reference ``.pt``) acoustic checkpoint, and a
        vocoder when given (a ``.ckpt`` or a torch Vocos file), onto
        ``device`` (CUDA unless named), or over ``devices``."""
        if devices is not None:
            if device is not None:
                raise ValueError("pass device or devices, not both")
            device = devices[0]
        model = AcousticModel.from_pretrained(path, device=device)
        vocoder = None
        if vocoder_path is not None:
            from .models.vocoder import VocoderModel

            vocoder = VocoderModel.from_pretrained(vocoder_path, device=device)
        return cls(model, config, vocoder=vocoder, devices=devices)

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
        Bb = -(-Bb // len(self.devices)) * len(self.devices)  # equal shards
        tokens = np.zeros((Bb, tb), np.int32)
        lens = np.ones((Bb,), np.int32)
        for i, e in enumerate(encoded):
            tokens[i, : e.size] = e
            lens[i] = e.size
        return tokens, lens, fb, len(texts)

    # -- the audio contract ----------------------------------------------------

    def _audio_geometry(self) -> dict:
        """The checkpoint's mel contract for Griffin-Lim (its ``audio_config``);
        without one, the JAX package's defaults, with a warning."""
        geo = self.model.config.audio_config
        if geo:
            return dict(geo)
        if not getattr(self, "_warned_default_geometry", False):
            self._warned_default_geometry = True
            logger.warning("checkpoint carries no audio_config; assuming the default "
                           "mel contract (22.05 kHz, n_fft 1024, hop 256) for Griffin-Lim")
        return dict(DEFAULT_AUDIO_GEOMETRY)

    def _hop_length(self) -> int:
        return (self.vocoder.features_config.hop_length if self.vocoder is not None
                else self._audio_geometry()["hop_length"])

    @property
    def sample_rate(self) -> int:
        return int(self.vocoder.features_config.sample_rate if self.vocoder is not None
                   else self._audio_geometry()["sample_rate"])

    def _check_vocoder_contract(self, vocoder) -> None:
        """Warn when the vocoder's mel contract is not the acoustic model's:
        its audio would play at the wrong speed or pitch."""
        fc = vocoder.features_config
        problems = []
        if fc.n_mels != self.model.mel_dim:
            problems.append(f"n_mels {fc.n_mels} != model mel_dim {self.model.mel_dim}")
        geo = self.model.config.audio_config
        if geo:
            for k in ("sample_rate", "n_fft", "hop_length", "win_length", "f_min", "f_max"):
                if geo.get(k) != getattr(fc, k, None):
                    problems.append(f"{k} {getattr(fc, k, None)} != acoustic {geo.get(k)}")
        if problems:
            logger.warning("vocoder mel contract disagrees with the acoustic checkpoint "
                           "(%s): audio will be speed/pitch-shifted or garbled",
                           "; ".join(problems))

    def _vocode(self, mel: torch.Tensor, shard: int = 0) -> torch.Tensor:
        """(Bb, frames, n_mels) padded mel -> (Bb, frames * hop) waveform in
        [-1, 1]: the neural vocoder (the replica of card ``shard``), else the
        matmul Griffin-Lim."""
        if self.vocoder is not None:
            audio = self.vocoders[shard].infer(mel)
        else:
            geo = self._audio_geometry()
            audio = mel_to_audio_tpu(mel, geo["sample_rate"], geo["n_fft"],
                                     geo["hop_length"], geo["win_length"], geo["f_min"],
                                     geo["f_max"])
        return torch.clamp(audio, -1.0, 1.0)

    def warmup(self, batch_sizes: tuple = (1,), audio: bool | None = None) -> None:
        """Run every (text bucket, frame budget, batch bucket) once, with and
        without a speaker on multi-speaker checkpoints, and with ``audio``
        the vocoder too (default: when a neural vocoder is attached), so the
        first request at each shape pays no first-call costs."""
        if audio is None:
            audio = self.vocoder is not None
        variants = (False, True) if self._has_speaker else (False,)
        for b in batch_sizes:
            b = batch_bucket(b, self.config.batch_buckets)
            b = -(-b // len(self.devices)) * len(self.devices)
            for tb in self.config.text_buckets:
                tokens = np.zeros((b, tb), np.int32)
                lens = np.full((b,), tb, np.int32)
                for fb in self.config.frame_budgets:
                    for use_speaker in variants:
                        spk = np.zeros((b,), np.int64) if use_speaker else None
                        self._run(tokens, lens, fb, spk, 0, audio=audio)
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        logger.info("synthesizer warm: batch buckets %s, audio %s", batch_sizes, audio)

    # -- serving ---------------------------------------------------------------

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

    def synthesize_audio(self, text: str | list[str], seed: int = 0,
                         duration_factor: float = 1.0, pitch_factor: float = 1.0,
                         pitch_delta: float = 0.0, energy_factor: float = 1.0,
                         energy_delta: float = 0.0,
                         speaker: int | list[int] | None = None) -> list[np.ndarray]:
        """Text -> waveform(s): a list of float32 arrays in [-1, 1], each
        ``frames * hop`` samples long."""
        audio, dec_lens, B = self._synthesize_mel(
            text, seed, duration_factor, pitch_factor, pitch_delta,
            energy_factor, energy_delta, speaker, audio=True)
        hop = self._hop_length()
        audio = audio[:B].cpu().numpy()
        return [audio[i, : int(dec_lens[i]) * hop] for i in range(B)]

    def synthesize_long(self, text: str, seed: int = 0, pause_s: float = 0.25,
                        **controls) -> np.ndarray:
        """Long-form synthesis: the sentences of ``text`` as one batch, their
        waveforms joined with ``pause_s`` of silence; one float32 waveform."""
        parts = split_sentences(text)
        if not parts:
            raise ValueError("empty text")
        wavs = self.synthesize_audio(parts, seed=seed, **controls)
        pause = np.zeros(int(pause_s * self.sample_rate), np.float32)
        pieces: list[np.ndarray] = []
        for i, w in enumerate(wavs):
            pieces.append(w)
            if i < len(wavs) - 1:
                pieces.append(pause)
        return np.concatenate(pieces)

    def _infer(self, tokens: torch.Tensor, lens: torch.Tensor, fb: int,
               spk: torch.Tensor | None, noise: torch.Tensor, duration_factor: float = 1.0,
               pitch_factor: float = 1.0, pitch_delta: float = 0.0,
               energy_factor: float = 1.0, energy_delta: float = 0.0, shard: int = 0):
        """The acoustic model of card ``shard`` on its rows, from the flow
        noise ``noise``."""
        return self.replicas[shard].infer(
            tokens, text_lengths=lens, max_dec_len=fb, steps=self.config.steps,
            duration_factor=duration_factor, pitch_factor=pitch_factor,
            pitch_delta=pitch_delta, energy_factor=energy_factor,
            energy_delta=energy_delta, speaker=spk, noise=noise,
            **self.config.extra_controls)

    def _noise(self, shape: tuple, seed: int) -> torch.Tensor:
        """The flow noise of a padded (B, T) batch, (B, T, features), drawn
        on the first card from ``seed`` as one card's model draws it."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn((*shape, self.model.temporal_adaptor.predictor.output_dim),
                           generator=gen, device=self.device)

    def _run(self, tokens: np.ndarray, lens: np.ndarray, fb: int, spk: np.ndarray | None,
             seed: int, audio: bool = False, controls: tuple = ()):
        """One padded batch at budget ``fb`` over the cards (one card is one
        shard): (mel, or with ``audio`` the waveform; the rows' frame
        counts), on the first card. The flow noise of the whole batch is
        drawn on the first card and split, each card's shard is launched
        before any is waited for, and the shards are joined."""
        def put(x, rows, dev):
            return None if x is None else torch.from_numpy(x[rows]).to(dev)

        noise = self._noise(tokens.shape, seed)
        per = tokens.shape[0] // len(self.devices)
        outs, lengths = [], []
        for i, dev in enumerate(self.devices):
            rows = slice(i * per, (i + 1) * per)
            mel, ad = self._infer(put(tokens, rows, dev).long(), put(lens, rows, dev), fb,
                                  None if spk is None else put(spk, rows, dev).long(),
                                  noise[rows].to(dev), *controls, shard=i)
            outs.append(self._vocode(mel, i) if audio else mel)
            lengths.append(ad.dec_lengths)
        return (torch.cat([o.to(self.device) for o in outs]),
                torch.cat([x.to(self.device) for x in lengths]))

    def _synthesize_mel(self, text: str | list[str], seed: int = 0,
                        duration_factor: float = 1.0, pitch_factor: float = 1.0,
                        pitch_delta: float = 0.0, energy_factor: float = 1.0,
                        energy_delta: float = 0.0,
                        speaker: int | list[int] | None = None, audio: bool = False):
        """Bucketed synthesis: the padded (Bb, budget, n_mels) mel (with
        ``audio``, the (Bb, budget * hop) waveform) on the model's device,
        the real rows' frame counts (numpy), and B."""
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
            spk = np.zeros((Bb,), np.int64)
            spk[:B] = ids
        controls = (duration_factor, pitch_factor, pitch_delta, energy_factor, energy_delta)
        budgets = self.config.frame_budgets
        while True:
            out, dec_lengths = self._run(tokens, lens, fb, spk, seed, audio, controls)
            dec_lens = dec_lengths[:B].cpu().numpy()
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
        return out, dec_lens, B
