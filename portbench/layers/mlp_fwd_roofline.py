"""The bound of the backbone's MLPs' forward (``mlp_fwd_s`` of its kind's
``block_bounds``) over the device time of the kernels launched inside the
program's ``csvit.vit.mlp`` spans, a unit, in %. None where the program has
no such span."""


def read(t):
    bound = t.info.get("block_bounds", {}).get("mlp_fwd_s")
    us = t.device_us_under(lambda n: n == "csvit.vit.mlp")
    if bound is None or us <= 0 or not t.n_units:
        return None
    return 100.0 * bound / (us * 1e-6 / t.n_units)
