"""Test config: the CPU backend with 8 virtual devices, so sharding and
halo-exchange tests run without accelerators, and Pallas kernels run in
interpret mode (``traverse.select_backend``).

A run that sets ``JAX_PLATFORMS`` to another platform keeps it: that is
how the GPU-marked tests run on a card (``python chip_smoke.py`` runs
them in its own process).  The CPU suite keeps no persistent compile
cache: XLA:CPU cache entries record host machine features that the loader
can report as mismatches.
"""

import os

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` compare compiled kernels on a CUDA card; they
    skip elsewhere.  Decided per test, never at import, so every worker
    collects the same tests."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU; run `python chip_smoke.py` on one")
