"""Models of the port, and the registries of models, losses and
evaluators by recipe name."""

from ..config.registry import Registry

MODELS = Registry("models")
CRITERIA = Registry("criteria")
EVALUATORS = Registry("evaluators")

from .acoustic.evaluator import AcousticModelEvaluator  # noqa: E402
from .acoustic.loss import AcousticModelLoss  # noqa: E402
from .acoustic.model import AcousticModel  # noqa: E402
from .vocoder import VocoderEvaluator, VocoderGANLoss, VocoderModel  # noqa: E402

MODELS.add("AcousticModel", AcousticModel)
CRITERIA.add("AcousticModelLoss", AcousticModelLoss)
EVALUATORS.add("AcousticModelEvaluator", AcousticModelEvaluator)
MODELS.add("VocoderModel", VocoderModel)
CRITERIA.add("VocoderGANLoss", VocoderGANLoss)
EVALUATORS.add("VocoderEvaluator", VocoderEvaluator)
