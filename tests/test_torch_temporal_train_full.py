"""Port parity: the full (T=5) case of the temporal train step against the
JAX package, the test and tolerances of tests/test_torch_temporal_train.py,
in a file of its own so that its JAX compiles run beside the realtime
case's."""

import pytest

from .test_torch_temporal_train import _jax_temporal_step
from .test_torch_temporal_train import test_temporal_step_matches_jax  # noqa: F401


@pytest.fixture(scope="module", params=["full"])
def jax_temporal_step(request):
    return _jax_temporal_step(request.param)
