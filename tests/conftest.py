"""Test configuration: run on an 8-device virtual CPU mesh with x64 enabled.

Tests validate numerics and sharding on the CPU backend (per SURVEY.md §4:
CPU-backend simulation of multi-device meshes via
XLA_FLAGS=--xla_force_host_platform_device_count=8). Pallas kernels run in
interpret mode here; `python -u chip_smoke.py` drives the compiled path on
the GPU.
"""

import os

# Force CPU, for this process and for any child it starts. If jax was
# imported before this file (a site hook, an accelerator plug-in), the env
# var is already read, so the config update below is the reliable override.
# The unit tests need f64, and run at tiny sizes where the CPU is fastest.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables between test modules.

    With 250+ tests in one process the CPU XLA compiler segfaulted
    deterministically around test ~195 (inside backend_compile_and_load;
    host RAM was fine) — accumulated compilation state. Each module's
    kernels are mostly disjoint, so clearing between modules costs little
    and keeps the compiler state bounded.
    """
    yield
    jax.clear_caches()
