"""Host utilities: model download, VCF comparison, text pileups,
training-image merges, stage timers and trace capture."""
from .profiling import StageTimer, trace  # noqa: F401
