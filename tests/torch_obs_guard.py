"""Observability isolation for the port's tests.

The port keeps its own metrics registry, span tracer and request log, one
process-wide each, as the JAX package does.  A pytest worker builds
hundreds of engines and block pools, and a metric family past
``FLAGS_metrics_max_children`` label sets coalesces new ones into
``{overflow="true"}``, so each test starts from an empty registry, tracer
and log (the JAX package's conftest does the same for its own).  A test
module takes the fixture by importing it::

    from torch_obs_guard import fresh_observability  # noqa: F401
"""

import pytest


@pytest.fixture(autouse=True)
def fresh_observability():
    from paddle_tpu_torch import observability

    observability.reset()
    yield
