# fused_block.window_attention is not re-exported: the name belongs to the
# submodule ops.window_attention (the attention-only kernel)
from .fused_block import (  # noqa: F401
    block_reference,
    fused_swin_block,
    gemm_bias_act,
    launch_counts,
    ln_residual,
    reset_launch_counts,
)
