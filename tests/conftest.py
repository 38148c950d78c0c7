"""Test harness configuration: force JAX onto a CPU backend with 8 virtual
devices so sharding tests exercise a multi-device mesh without accelerator
hardware (``__graft_entry__.dryrun_multichip`` dry-runs the multi-device path
the same way).

jax may already be imported with a backend initialized before this runs, so
setting JAX_PLATFORMS in os.environ alone is too late: update jax.config and
drop the initialized backend.

Tests that need the card carry the ``gpu`` marker and skip on the CPU (the
``gpu_device`` fixture decides). ``chip_smoke.py`` runs them on the card in
its own process with ``SSPV_TEST_PLATFORM=gpu``, which leaves the already
initialized GPU backend alone.
"""

import os

import pytest

ON_CARD = os.environ.get("SSPV_TEST_PLATFORM") == "gpu"

if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    try:
        from jax._src import xla_bridge as _xb

        _xb._clear_backends()
    except Exception:  # pragma: no cover - best effort; env may already be clean
        pass

    assert jax.default_backend() == "cpu", jax.default_backend()


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {d.platform}")
    return d
