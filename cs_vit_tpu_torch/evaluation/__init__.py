from .metrics import align_w_scale, compute_metrics, reproject_pinhole  # noqa: F401
from .writer import EvalH5Writer, gather_strings_to_host0, gather_to_host0  # noqa: F401
