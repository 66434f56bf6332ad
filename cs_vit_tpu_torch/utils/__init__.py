from .logging import TBLogger, flatten_dict, nop, print_grouped_losses, wrap_prefix_print  # noqa: F401
from .profiling import StepTimer  # noqa: F401
