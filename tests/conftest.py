"""Test configuration: run everything on a virtual 8-device CPU mesh.

XLA flags must be set before jax initializes.

Wall-time note: the suite's cost is per-test XLA:CPU tracing/compiles
(the persistent cache below removes recompiles, not retraces). On a
multi-core CI runner ``-m "not slow"`` is the per-push lane; the
slow-marked physics guards run in the nightly lane
(.github/workflows/tests.yml). On a single-core dev box expect
~15-30 min for the not-slow lane.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them when the default device is not a GPU. The CPU
is the default platform here; on a machine with a GPU run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# persistent compile cache: the suite's dominant cost is XLA:CPU compiles
# of near-identical kernels re-traced per test (new closures per runner).
# Keyed by HLO, so repeats across tests AND across pytest runs hit. Kept
# apart from the program's <checkout>/.jax_cache unless the caller points
# JAX_COMPILATION_CACHE_DIR somewhere.
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(os.path.dirname(__file__), ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import baryonforge_tpu  # noqa: E402,F401  (enables x64)


@pytest.fixture
def gpu_device():
    """The default device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the default device is {dev.platform}")
    return dev
