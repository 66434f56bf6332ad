"""The bound of the backbone's blocks' forward (portbench.flops) over the
device time of the kernels launched under the ``pb.block`` spans, a unit,
in %."""


def read(t):
    us = t.device_us_under(lambda n: n == "pb.block")
    if us <= 0 or not t.n_units:
        return None
    return 100.0 * t.info["block_bounds"]["fwd_s"] / (us * 1e-6 / t.n_units)
