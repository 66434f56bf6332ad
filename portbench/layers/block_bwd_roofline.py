"""The bound of the backbone's blocks' vector-Jacobian products
(portbench.flops) over the device time of the kernels launched under the
autograd op ``FusedSwinBlockBackward``, a unit, in %."""


def read(t):
    us = t.device_us_under(lambda n: "FusedSwinBlockBackward" in n)
    if us <= 0 or not t.n_units:
        return None
    return 100.0 * t.info["block_bounds"]["bwd_s"] / (us * 1e-6 / t.n_units)
