"""The neural vocoder, log-mel -> waveform (the generator, for inference)."""

from .model import VocoderModel, VocoderModelConfig, VocosGenerator

__all__ = ["VocoderModel", "VocoderModelConfig", "VocosGenerator"]
