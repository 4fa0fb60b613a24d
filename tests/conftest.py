"""Test harness config: JAX on the CPU with an 8-device virtual mesh.

Multi-device sharding is validated on a virtual CPU mesh.  JAX_PLATFORMS
defaults to cpu here; tests marked ``gpu`` need the card and run with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``, skipping anywhere
else.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX backend is "
                    f"{jax.default_backend()})")
