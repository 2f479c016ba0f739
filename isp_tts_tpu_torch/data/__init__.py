"""The data pipeline: registries of datasets and collators by recipe name."""

from ..config.registry import Registry

DATASETS = Registry("datasets")
COLLATORS = Registry("collators")

from .collator import AcousticCollator  # noqa: E402
from .dataset import AcousticDataset  # noqa: E402
from .vocoder import VocoderCollator, VocoderDataset  # noqa: E402

DATASETS.add("AcousticDataset", AcousticDataset)
COLLATORS.add("AcousticCollator", AcousticCollator)
DATASETS.add("VocoderDataset", VocoderDataset)
COLLATORS.add("VocoderCollator", VocoderCollator)
