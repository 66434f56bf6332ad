"""The plain PyTorch reference of the benchmark (imports nothing of the
program)."""

from .model import Poser, trained  # noqa: F401
from .precision import MODES, reference_numerics  # noqa: F401
from .train import reference_steps  # noqa: F401
