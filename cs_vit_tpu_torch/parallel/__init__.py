from .prefetch import device_prefetch, host_stage  # noqa: F401
