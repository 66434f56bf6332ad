from . import geometry, joints  # noqa: F401
