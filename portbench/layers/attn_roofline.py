"""The bound of the backbone's attention cores (``attn_fwd_s`` +
``attn_bwd_s`` of its kind's ``block_bounds``) over the device time of the
kernels launched inside the program's ``csvit.vit.attn`` spans (the fused
forward calls) and under the host ops of the fused attention's backward, on
the same thread, a unit, in %. None where the program has no such spans or
ops (SwinV2's window attention, an older program)."""

BACKWARD_OPS = ("aten::_scaled_dot_product_flash_attention_backward",
                "aten::_scaled_dot_product_cudnn_attention_backward",
                "aten::_scaled_dot_product_efficient_attention_backward",
                "aten::_efficient_attention_backward")


def read(t):
    bounds = t.info.get("block_bounds", {})
    if "attn_fwd_s" not in bounds:
        return None
    fwd = t.device_us_under(lambda n: n == "csvit.vit.attn")
    bwd = t.device_us_under(lambda n: n in BACKWARD_OPS)
    if fwd <= 0 or bwd <= 0 or not t.n_units:
        return None
    return 100.0 * (bounds["attn_fwd_s"] + bounds["attn_bwd_s"]) / ((fwd + bwd) * 1e-6 / t.n_units)
