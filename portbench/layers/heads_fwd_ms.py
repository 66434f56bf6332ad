"""Device milliseconds a unit of the kernels launched under the spans on
the Poser's top-level submodules other than the backbone (forward)."""


def read(t):
    us = t.device_us_under(lambda n: n.startswith("pb.head."))
    if us <= 0 or not t.n_units:
        return None
    return us * 1e-3 / t.n_units
