"""Test harness config: a virtual 8-device CPU mesh by default.

``--xla_force_host_platform_device_count=8`` fakes 8 CPU devices so
mesh/sharding/collective tests exercise the exact shard_map code that runs
on several cards. The suite runs on the CPU unless ``JAX_PLATFORMS`` names
another platform: tests marked ``gpu`` need an NVIDIA GPU and skip
without one (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``).
"""

import os
import resource

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

# XLA:CPU's compiler recurses deeply on large programs (the chunked
# soft-replay scans); with the default 8 MB main-thread stack a full
# suite run can SIGSEGV inside backend_compile late in the session
# (observed: crash in test_replay_soft at ~50% of the suite, same
# test green in isolation). The hard limit here is unlimited — raise
# the soft limit so the main stack may keep growing.
try:
    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    resource.setrlimit(resource.RLIMIT_STACK, (_hard, _hard))
except (ValueError, OSError):
    pass

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/)")
