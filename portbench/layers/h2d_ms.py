"""Device milliseconds of host-to-device copies a traced unit."""


def read(t):
    ev = t.device_events(("gpu_memcpy",), lambda n: "HtoD" in n)
    if not ev or not t.n_units:
        return None
    return sum(e["dur"] for e in ev) * 1e-3 / t.n_units
