from .fused_block import (  # noqa: F401
    block_reference,
    fused_swin_block,
    gemm_bias_act,
    launch_counts,
    ln_residual,
    reset_launch_counts,
    window_attention,
)
