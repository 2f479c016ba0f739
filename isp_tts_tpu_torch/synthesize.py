"""Synthesis CLI: checkpoint -> text front end -> ``AcousticModel.infer`` ->
vocoder -> 16-bit WAV.

Counterpart of ``isp_tts_tpu/synthesize.py``, with its flags and defaults
and ``--device`` (CUDA unless named). The vocoder is a ``VocoderModel``
``.ckpt`` or a torch Vocos checkpoint (``.pts``, ``.pt``, ``.pth``,
``.bin``) given with ``--vocoder``, else Griffin-Lim (``torch.fft``) on the
same device, peak-normalised to 0.95. ``--checkpoint`` also takes a
reference ``.pt``.

    python -m isp_tts_tpu_torch.synthesize --checkpoint ckpt.ckpt \
        --text "Hello world." --output out.wav [--vocoder voc.ckpt] [--steps 4]
        [--duration-factor 1.0] [--pitch-factor 1.0] [--pitch-delta 0.0]
        [--speaker 0] [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="isp_tts_tpu_torch synthesis")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--text", required=True)
    parser.add_argument("--output", default="output.wav")
    parser.add_argument("--charset", nargs="+",
                        default=["<pad>", "</s>", "#punct", "#en"])
    parser.add_argument("--phonemizer", action="store_true")
    parser.add_argument("--language", default="en-us")
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--duration-factor", type=float, default=1.0)
    parser.add_argument("--pitch-factor", type=float, default=1.0)
    parser.add_argument("--pitch-delta", type=float, default=0.0)
    parser.add_argument("--energy-factor", type=float, default=1.0)
    parser.add_argument("--speaker", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-frames", type=int, default=2048)
    parser.add_argument("--sample-rate", type=int, default=22050)
    parser.add_argument("--vocoder", default=None,
                        help="neural vocoder: a VocoderModel checkpoint (.ckpt) or a "
                             "torch Vocos file (.pts/.pt/.pth/.bin) (default: Griffin-Lim)")
    parser.add_argument("--griffin-lim-iters", type=int, default=48)
    parser.add_argument("--device", default="cuda",
                        help="device to run on (default: cuda; there is no fallback)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(message)s")
    log = logging.getLogger("synthesize")

    import numpy as np
    import torch

    from .data.audio import write_wav
    from .data.providers import TextProvider
    from .data.text.table import CodingTable
    from .models.acoustic.model import AcousticModel
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    model = AcousticModel.from_pretrained(args.checkpoint, device=device)
    provider = TextProvider(CodingTable.from_charset(list(args.charset)),
                            phonemizer=args.phonemizer)
    vector = provider(args.text)
    log.info("text -> %d tokens", vector.size)

    tokens = torch.from_numpy(vector).long().to(device)[None]
    speaker = (torch.tensor([args.speaker], dtype=torch.long, device=device)
               if args.speaker is not None else None)
    t0 = time.perf_counter()
    mel, adaptor = model.infer(
        tokens, max_dec_len=args.max_frames, steps=args.steps,
        duration_factor=args.duration_factor, pitch_factor=args.pitch_factor,
        pitch_delta=args.pitch_delta, energy_factor=args.energy_factor,
        speaker=speaker, generator=torch.Generator(device=device).manual_seed(args.seed))
    n_frames = int(adaptor.dec_lengths[0])
    if n_frames < 1:
        # every duration rounded to zero: keep one frame for the vocoder
        log.warning("model predicted 0 frames; emitting 1 frame of silence")
        n_frames = 1
    mel = mel[:, :n_frames]
    log.info("acoustic: %d frames in %.3fs", n_frames, time.perf_counter() - t0)

    t0 = time.perf_counter()
    if args.vocoder:
        from .models.vocoder import VocoderModel

        vocoder = VocoderModel.from_pretrained(args.vocoder, device=device)
        audio = np.clip(vocoder.infer(mel)[0].cpu().numpy(), -1.0, 1.0)
    else:
        from .ops.vocoder import mel_to_audio

        audio = mel_to_audio(mel[0], sample_rate=args.sample_rate,
                             n_iter=args.griffin_lim_iters).cpu().numpy()
        audio = np.nan_to_num(audio)  # degenerate mels (one silent frame)
        audio = np.clip(audio / max(np.abs(audio).max(), 1e-6) * 0.95, -1, 1)
    log.info("vocoder: %.2fs of audio in %.3fs", len(audio) / args.sample_rate,
             time.perf_counter() - t0)

    write_wav(args.output, audio.astype(np.float32), args.sample_rate)
    log.info("wrote %s", args.output)


if __name__ == "__main__":
    main()
