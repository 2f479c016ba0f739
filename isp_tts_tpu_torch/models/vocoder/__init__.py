"""The neural vocoder, log-mel -> waveform: the Vocos generator, the GAN
discriminators, losses and evaluator."""

from .discriminator import VocoderDiscriminator
from .evaluator import VocoderEvaluator
from .loss import VocoderGANLoss, VocoderGANLossConfig
from .model import VocoderModel, VocoderModelConfig, VocosGenerator

__all__ = ["VocoderModel", "VocoderModelConfig", "VocosGenerator", "VocoderDiscriminator",
           "VocoderGANLoss", "VocoderGANLossConfig", "VocoderEvaluator"]
