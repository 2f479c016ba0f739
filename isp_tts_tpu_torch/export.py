"""Serving export: a self-contained ``torch.export`` deployment artifact.

Counterpart of ``isp_tts_tpu/export.py``. :func:`export_serving` exports ONE
bucketed serving program with ``torch.export.export``: tokens ->
(mel, dec_lengths), or tokens -> (waveform clipped to [-1, 1], dec_lengths)
when a vocoder is attached. The weights travel in the exported program's
state. The artifact is a zip of ``meta.json`` (the JAX artifact's keys and
values, plus ``format``, ``device`` and ``noise_shape``) and the ``.pt2``
that ``torch.export.save`` writes, so a deployment host needs no model code
and no checkpoint: :class:`ExportedSynthesizer` rebuilds text -> audio from
the artifact alone. Loading and calling one imports no module of
``isp_tts_tpu_torch.models``; it imports the registered attention forwards
(``isp_tts::mqa_fwd``, ``isp_tts::flash_fwd``, from
:mod:`isp_tts_tpu_torch.ops.flash_attention`), which the program calls once
per attention layer and which launch kernels K1 and K5a on the card.

Difference by design: the JAX program takes a ``seed`` and draws the flow
noise with ``PRNGKey(seed)`` inside; an exported torch program cannot take
a ``torch.Generator``. So the flow noise, (batch, text_bucket, features),
is a program input, and :class:`ExportedSynthesizer` draws it as the live
``Synthesizer._run`` does: ``torch.Generator(device).manual_seed(seed)``,
one ``torch.randn`` of that shape on the serving device. An artifact call
then computes what the live ``Synthesizer`` computes for the same seed,
controls and shapes. The five controls are 0-d float32 program inputs.

Platforms: the program is traced on the synthesizer's device, recorded as
``device``; ``platforms`` lists the device types a loader may run it on.
A loader on another device type moves the program there with
``torch.export.passes.move_to_device_pass``, so an artifact exported on the
CPU with ``platforms=("cpu", "cuda")`` runs on the card.

``precompile`` (JAX: ship the compiled executable, so a matching host skips
the compile) embeds the built kernel libraries the program launches, keyed
by the card's name and compute capability, the CUDA runtime version,
torch's version and the kernel sources' hash
(:func:`~isp_tts_tpu_torch.ops.cuda_build.sources_hash`). A matching host
loads them without nvcc, with a warning that it runs the artifact's native
code, from private files that serve that artifact's calls alone
(:func:`~isp_tts_tpu_torch.ops.cuda_build.libraries`): they never enter the
package's shared build directory. Any other card host builds the kernels
from its package's sources at load and logs that it did. On a CPU host
export warns and embeds nothing.
"""

from __future__ import annotations

import ctypes
import io
import json
import logging
import os
import tempfile
import zipfile
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger("isp_tts_tpu_torch")

_META_NAME = "meta.json"
_PROGRAM_NAME = "program.pt2"
_JAX_FN_NAME = "fn.jaxexport"  # what a JAX package artifact holds
_LIB_DIR = "kernels/"
FORMAT = "torch.export"
FORMAT_VERSION = 1
PLATFORMS = ("cpu", "cuda")
#: the registered forwards an exported program may call -> their kernel source
KERNEL_OPS = {"isp_tts.mqa_fwd.default": "mqa_fwd", "isp_tts.flash_fwd.default": "flash_fwd"}


def kernel_fingerprint(device: torch.device) -> dict:
    """What embedded kernel libraries are valid for: the card, the CUDA
    runtime, torch and the kernel sources."""
    from .ops.cuda_build import sources_hash

    major, minor = torch.cuda.get_device_capability(device)
    return {"device_name": torch.cuda.get_device_name(device),
            "capability": f"{major}.{minor}", "cuda": torch.version.cuda,
            "torch": torch.__version__, "sources": sources_hash()}


def kernel_libraries(program) -> list[str]:
    """The kernel libraries an exported program's registered attention
    forwards launch: each node's source at its q's head dim
    (:func:`~isp_tts_tpu_torch.ops.flash_attention.kernel_library`)."""
    from .ops.flash_attention import kernel_library

    libs = set()
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name in KERNEL_OPS:
            libs.add(kernel_library(KERNEL_OPS[name], node.args[0].meta["val"].shape[-1]))
    return sorted(libs)


def kernel_nodes(program) -> dict[str, int]:
    """``{op name: nodes}`` of the registered attention forwards in an
    exported program's graph."""
    counts: dict[str, int] = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name in KERNEL_OPS:
            counts[name] = counts.get(name, 0) + 1
    return counts


class _ServingProgram(torch.nn.Module):
    """The exported function: ``AcousticModel.infer`` at one frame budget,
    then the vocoder and the [-1, 1] clip when there is one."""

    def __init__(self, synth, frame_budget: int, use_speaker: bool):
        super().__init__()
        self.model = synth.model
        # the generator alone: the discriminators are no part of serving
        self.generator = synth.vocoder.generator if synth.vocoder is not None else None
        self.frame_budget = frame_budget
        self.steps = synth.config.steps
        self.use_speaker = use_speaker
        self.extra = dict(synth.config.extra_controls)

    def forward(self, tokens, lens, noise, duration_factor, pitch_factor, pitch_delta,
                energy_factor, energy_delta, speaker):
        mel, ad = self.model.infer(
            tokens, text_lengths=lens, max_dec_len=self.frame_budget, steps=self.steps,
            noise=noise, duration_factor=duration_factor, pitch_factor=pitch_factor,
            pitch_delta=pitch_delta, energy_factor=energy_factor,
            energy_delta=energy_delta, speaker=speaker if self.use_speaker else None,
            **self.extra)
        if self.generator is not None:
            # the float32 [-1, 1] contract of Synthesizer.synthesize_audio
            return torch.clamp(self.generator(mel), -1.0, 1.0), ad.dec_lengths
        return mel, ad.dec_lengths


def _example_inputs(batch: int, text_bucket: int, features: int, device) -> tuple:
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.ones((batch, text_bucket), dtype=torch.long, device=device),  # tokens
            torch.full((batch,), text_bucket, dtype=torch.int32, device=device),  # lens
            torch.zeros((batch, text_bucket, features), **f32),  # flow noise
            torch.tensor(1.0, **f32), torch.tensor(1.0, **f32),  # duration, pitch factor
            torch.tensor(0.0, **f32), torch.tensor(1.0, **f32),  # pitch delta, energy f.
            torch.tensor(0.0, **f32),  # energy delta
            torch.zeros((batch,), dtype=torch.long, device=device))  # speaker


def export_serving(synth, path, text_bucket: int, frame_budget: int, batch: int = 1,
                   use_speaker: bool = False, platforms: tuple | None = None,
                   precompile: bool = False) -> dict:
    """Export one (text_bucket, frame_budget, batch) serving program.

    Args:
      synth: a :class:`~isp_tts_tpu_torch.serving.Synthesizer` (with or
        without a neural vocoder); the program is traced on its device.
      path: output artifact path (zip).
      platforms: device types the artifact may run on, from ("cpu", "cuda");
        default: the synthesizer's only.
      precompile: also embed the built kernel libraries the program
        launches, for hosts with this card, CUDA runtime, torch and sources.

    Returns the artifact's metadata dict.
    """
    device = synth.device
    platforms = list(platforms) if platforms else [device.type]
    unknown = set(platforms) - set(PLATFORMS)
    if unknown or device.type not in PLATFORMS:
        raise ValueError(f"platforms must be from {PLATFORMS}, got {platforms} "
                         f"(traced on {device})")
    features = synth.model.temporal_adaptor.predictor.output_dim
    program = _ServingProgram(synth, frame_budget, use_speaker).eval()
    args = _example_inputs(batch, text_bucket, features, device)
    with torch.no_grad():
        program(*args)  # one eager call first: host constants are built outside the trace
        exported = torch.export.export(program, args, strict=False)
    if not kernel_nodes(exported) and any(
            m.flash != "off" for m in synth.model.modules() if hasattr(m, "flash")):
        raise RuntimeError("the exported program calls no registered attention forward")
    blob = io.BytesIO()
    torch.export.save(exported, blob)

    libs = {}
    fingerprint = None
    if precompile and device.type != "cuda":
        logger.warning("--precompile on a %s host: there are no kernel libraries to "
                       "embed; the artifact builds them on the card at load", device.type)
    elif precompile:
        from .ops.cuda_build import build_all

        names = kernel_libraries(exported)
        libs = {name: p.read_bytes() for name, p in build_all(names).items()}
        fingerprint = kernel_fingerprint(device)
        logger.info("embedded kernel libraries %s (%.1f MB) for %s", names,
                    sum(map(len, libs.values())) / 1e6, fingerprint["device_name"])

    geo = synth._audio_geometry()
    if synth.vocoder is not None:
        fc = synth.vocoder.features_config
        hop, sr = int(fc.hop_length), int(fc.sample_rate)
    else:
        hop, sr = int(geo["hop_length"]), int(geo["sample_rate"])
    meta = {
        "format_version": FORMAT_VERSION,
        "output": "audio" if synth.vocoder is not None else "mel",
        "text_bucket": text_bucket,
        "frame_budget": frame_budget,
        "batch": batch,
        "use_speaker": use_speaker,
        "steps": synth.config.steps,
        "platforms": platforms,
        "encoding_map": dict(synth.text_provider.coding_table.encoding_map),
        # the text pipeline travels with the artifact: a phoneme-charset
        # model tokenized without its phonemizer would produce garbage audio
        "phonemizer": bool(synth.config.phonemizer),
        "language": synth.config.language,
        "hop_length": hop,
        "sample_rate": sr,
        "mel_dim": int(synth.model.mel_dim),
        "format": FORMAT,
        "device": device.type,
        "noise_shape": [batch, text_bucket, features],
    }
    if fingerprint is not None:
        meta["precompiled"] = {**fingerprint, "kernels": sorted(libs)}
    with zipfile.ZipFile(path, "w") as z:
        z.writestr(_META_NAME, json.dumps(meta), compress_type=zipfile.ZIP_DEFLATED)
        # float weights hardly deflate: store the program as it is
        z.writestr(_PROGRAM_NAME, blob.getvalue())
        for name, data in libs.items():
            z.writestr(f"{_LIB_DIR}{name}.so", data)
    return meta


def _load_private(data: bytes) -> ctypes.CDLL:
    """Load a shared library from bytes through a temporary file that is
    removed once loaded: the loaded library stays private to its caller."""
    fd, tmp = tempfile.mkstemp(suffix=".so")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        return ctypes.CDLL(tmp)
    finally:
        os.unlink(tmp)


class ExportedSynthesizer:
    """Serve text from an exported artifact: no model code, no checkpoint.

    >>> ex = ExportedSynthesizer("serving.tts.zip")
    >>> wav_or_mel = ex("hello world.")[0]

    Only the exported (text_bucket, frame_budget, batch) shape exists: a
    longer text or a larger batch raises. ``device`` is CUDA unless named.
    """

    def __init__(self, path, device: str | torch.device | None = None):
        from .utils.device import resolve_device

        self.device = resolve_device(device)
        with zipfile.ZipFile(path) as z:
            names = set(z.namelist())
            if _JAX_FN_NAME in names and _PROGRAM_NAME not in names:
                raise ValueError(f"{path} is a JAX package artifact (jax.export); "
                                 "serve it with isp_tts_tpu.export")
            if _META_NAME not in names or _PROGRAM_NAME not in names:
                raise ValueError(f"{path} holds no {_META_NAME} and {_PROGRAM_NAME}")
            self.meta = json.loads(z.read(_META_NAME))
            if (self.meta.get("format") != FORMAT
                    or self.meta.get("format_version") != FORMAT_VERSION):
                raise ValueError(f"unsupported artifact format {self.meta.get('format')!r} "
                                 f"version {self.meta.get('format_version')!r}")
            if self.device.type not in self.meta["platforms"]:
                raise ValueError(f"artifact was exported for {self.meta['platforms']}, "
                                 f"not {self.device.type}")
            # rebuild the source synthesizer's text pipeline: if the artifact
            # needs espeak and this host lacks it, fail here
            from .data.text.processor import TextProcessor
            from .data.text.table import CodingTable

            self._table = CodingTable.from_encoding_map(self.meta["encoding_map"])
            self._process = TextProcessor(phonemizer=self.meta.get("phonemizer", False),
                                          language=self.meta.get("language", "en-us"))
            # the program's attention nodes need the operators registered
            from .ops import flash_attention  # noqa: F401

            program = torch.export.load(io.BytesIO(z.read(_PROGRAM_NAME)))
            if self.meta["device"] != self.device.type:
                from torch.export.passes import move_to_device_pass

                program = move_to_device_pass(program, str(self.device))
            self.kernel_nodes = kernel_nodes(program)
            #: the kernel libraries those nodes launch
            self.kernel_libraries = kernel_libraries(program)
            #: kernel name -> embedded library serving this artifact's launches
            self._libs = {}
            if self.device.type == "cuda":
                self._ready_kernels(path, z)
        self._fn = program.module()

    def _ready_kernels(self, path, z: zipfile.ZipFile) -> None:
        """Ready the program's kernel libraries: on a matching host the
        embedded ones, loaded from private files that serve this artifact's
        calls alone; else the package's, built from its sources."""
        from .ops import cuda_build

        names = self.kernel_libraries
        want = self.meta.get("precompiled")
        have = kernel_fingerprint(self.device)
        if want and {k: want.get(k) for k in have} == have:
            # as load_torch_checkpoint warns before a full unpickle
            logger.warning("artifact %s: loading its embedded native kernel libraries %s, "
                           "which run with this process's rights; load only artifacts "
                           "you trust", path, names)
            self._libs = {name: _load_private(z.read(f"{_LIB_DIR}{name}.so"))
                          for name in names}
            return
        if want:
            logger.info("artifact kernels were built for %s, this host is %s: building "
                        "%s from the package's sources", want, have, names)
        cuda_build.build_all(names)

    def __call__(self, text: str | list[str], seed: int = 0,
                 duration_factor: float = 1.0, pitch_factor: float = 1.0,
                 pitch_delta: float = 0.0, energy_factor: float = 1.0,
                 energy_delta: float = 0.0,
                 speaker: int | list[int] | None = None) -> list[np.ndarray]:
        meta = self.meta
        texts = [text] if isinstance(text, str) else list(text)
        B, Tb = meta["batch"], meta["text_bucket"]
        if len(texts) > B:
            raise ValueError(f"artifact was exported for batch {B}, got {len(texts)} texts")
        if speaker is not None and not meta["use_speaker"]:
            raise ValueError("artifact was exported without speaker support")
        tokens = np.zeros((B, Tb), np.int64)
        lens = np.ones((B,), np.int32)
        for i, t in enumerate(texts):
            # the TextProvider pipeline: clean -> EOS -> ids
            processed = self._table.check_eos(self._process(t))
            vec = np.asarray(self._table.text_to_vector(processed), np.int64)
            if len(vec) > Tb:
                raise ValueError(f"text of {len(vec)} tokens exceeds the exported bucket {Tb}")
            tokens[i, : len(vec)] = vec
            lens[i] = len(vec)
        spk = np.zeros((B,), np.int64)
        if speaker is not None:
            ids = [speaker] * len(texts) if np.isscalar(speaker) else list(speaker)
            if len(ids) != len(texts):
                raise ValueError(f"speaker list length {len(ids)} != number of texts "
                                 f"{len(texts)}")
            spk[: len(ids)] = ids
        dev = self.device
        # the live Synthesizer's draw (serving.Synthesizer._run)
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = torch.randn(tuple(meta["noise_shape"]), generator=gen, device=dev,
                            dtype=torch.float32)
        controls = [torch.tensor(float(c), dtype=torch.float32, device=dev) for c in
                    (duration_factor, pitch_factor, pitch_delta, energy_factor, energy_delta)]
        from .ops.cuda_build import libraries

        with torch.no_grad(), libraries(self._libs):
            out, dec_lens = self._fn(torch.from_numpy(tokens).to(dev),
                                     torch.from_numpy(lens).to(dev), noise, *controls,
                                     torch.from_numpy(spk).to(dev))
        out, dec_lens = out.float().cpu().numpy(), dec_lens.cpu().numpy()
        if any(int(dec_lens[i]) >= meta["frame_budget"] for i in range(len(texts))):
            # a single-shape artifact cannot rebucket like the live Synthesizer:
            # report the clip (export with a larger --frame-budget to fix)
            logger.warning("exported frame budget %d saturated (dec_lens=%s); tail frames "
                           "may be clipped", meta["frame_budget"], dec_lens[: len(texts)])
        n = meta["hop_length"] if meta["output"] == "audio" else 1
        return [out[i, : int(dec_lens[i]) * n] for i in range(len(texts))]


def main(argv=None) -> None:
    """``python -m isp_tts_tpu_torch.export --checkpoint m.ckpt --output a.zip``"""
    import argparse

    from .serving import Synthesizer, SynthesizerConfig

    p = argparse.ArgumentParser(description="serving export (torch.export)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--vocoder", default=None)
    p.add_argument("--output", required=True)
    p.add_argument("--text-bucket", type=int, default=128)
    p.add_argument("--frame-budget", type=int, default=1024)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--speaker", action="store_true",
                   help="export the speaker-control variant")
    p.add_argument("--platforms", nargs="+", default=None, choices=PLATFORMS,
                   help="device types the artifact may run on, e.g. --platforms cpu "
                        "cuda (default: the export device's)")
    p.add_argument("--precompile", action="store_true",
                   help="also embed the built kernel libraries (keyed by card, CUDA, "
                        "torch and sources: a matching host skips nvcc)")
    p.add_argument("--device", default="cuda",
                   help="device to trace on (default: cuda; there is no fallback)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    synth = Synthesizer.from_pretrained(args.checkpoint, SynthesizerConfig(steps=args.steps),
                                        vocoder_path=args.vocoder, device=args.device)
    meta = export_serving(synth, Path(args.output), text_bucket=args.text_bucket,
                          frame_budget=args.frame_budget, batch=args.batch,
                          use_speaker=args.speaker, platforms=args.platforms,
                          precompile=args.precompile)
    print(json.dumps(meta, indent=2))


if __name__ == "__main__":
    main()
