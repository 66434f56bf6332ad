"""Device milliseconds a traced step of the kernels launched inside the
program's ``csvit.step.clip`` or ``csvit.step.optim`` span, on the same
thread: the clip and AdamW."""


def read(t):
    us = t.device_us_under(lambda n: n in ("csvit.step.clip", "csvit.step.optim"))
    if us <= 0 or not t.n_units:
        return None
    return us * 1e-3 / t.n_units
