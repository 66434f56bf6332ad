"""CUDA runtime and driver calls a traced unit that block the host until
the device has caught up (stream, event or device synchronisation; a
blocking device-to-host copy synchronises its stream)."""

from portbench.tracing import SYNC_CALLS


def read(t):
    if not t.n_units or not t.device_events():
        return None
    return t.count_host(SYNC_CALLS) / t.n_units
