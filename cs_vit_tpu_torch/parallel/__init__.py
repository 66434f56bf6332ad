from .mesh import all_mean_, init_distributed, process_local_batch_slice  # noqa: F401
from .prefetch import device_prefetch, host_stage  # noqa: F401
