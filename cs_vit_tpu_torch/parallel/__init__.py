from .mesh import (  # noqa: F401
    Mesh,
    all_mean_,
    init_distributed,
    make_mesh,
    process_local_batch_slice,
)
from .prefetch import device_prefetch, host_stage  # noqa: F401
