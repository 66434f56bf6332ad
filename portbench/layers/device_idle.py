"""1 - the union of the device's kernel and copy intervals a traced unit
over the untraced time a unit, in %."""


def read(t):
    if not t.n_units or not t.device_events():
        return None
    return 100.0 * (1.0 - t.busy_us() * 1e-6 / t.n_units / t.info["unit_s"])
