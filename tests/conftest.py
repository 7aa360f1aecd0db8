"""Test configuration.

Tests run on the CPU with fp64 enabled (golden-parity checks against the
NumPy reference implementation) and 8 virtual host devices, so the
multi-device sharding path is exercised without accelerators — the
standard JAX fake-multi-device mechanism (SURVEY.md §4).  The platform is
forced with ``jax.config.update`` after import, which also holds when jax
was imported before this file ran.  ``JAX_PLATFORMS=cuda`` selects the GPU
instead, for the tests marked ``gpu`` (``python -m pytest -m gpu tests/``).
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))

import jax  # noqa: E402
import pytest  # noqa: E402

from nmpc_tpu.utils.cache import enable_compilation_cache  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)
# persistent compilation cache: cold XLA compiles dominate suite wall time
enable_compilation_cache()


@pytest.fixture()
def gpu():
    """Skip unless JAX runs on a GPU (tests marked ``gpu``)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest -m gpu tests/")
