from .logging import TBLogger, flatten_dict, nop, print_grouped_losses, wrap_prefix_print  # noqa: F401
from .misc import (  # noqa: F401
    brief_dict,
    calculate_gradient_norm,
    get_array_memory,
    stat_tree_memory,
    to_tuple,
)
from .profiling import StepTimer, annotate, trace  # noqa: F401
