"""Test harness: force CPU with 8 virtual devices so sharding tests run
without several GPUs (SURVEY.md §4.5), and run the Pallas kernels in the
interpreter (ops/route.py). Must run before jax is imported. Tests that
need a GPU are marked ``gpu`` and skip here (see the ``gpu_device``
fixture)."""
import os

# ``GPURT_TEST_DEVICE=gpu`` (set by chip_smoke.py for the ``gpu``-marked
# tests) leaves JAX on the card and the kernels compiled.
ON_GPU = os.environ.get("GPURT_TEST_DEVICE") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["GPURT_PALLAS_INTERPRET"] = "1"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

# Persistent compilation cache: the interpret-mode kernel-parity tests are
# dominated by XLA CPU compiles of the lowered kernel bodies; caching makes
# re-runs fast.
from gpuraytracer_tpu.utils.cache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The GPU for ``gpu``-marked tests; skips where JAX has none (decided
    here, at run time, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def cornell_scene():
    from gpuraytracer_tpu.scene import cornell_box
    return cornell_box(resolution=(64, 48))


@pytest.fixture(scope="session")
def sphere_scene():
    from gpuraytracer_tpu.scene import cornell_box_with_spheres
    return cornell_box_with_spheres(resolution=(64, 64))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
