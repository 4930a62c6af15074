"""Test configuration: run the suite on a virtual 8-device CPU mesh.

The reference has no distributed tests (nothing distributed to test — SURVEY.md §4);
here every test runs against the same code paths that run on the GPU, with the
host platform forced to CPU and split into 8 virtual devices so the sharded
multi-device paths are exercised without hardware. Tests marked ``gpu`` need a
card and skip here; ``python chip_smoke.py`` runs them on one.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (import after env is set)

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

# The package import applies the compile-cache rule (JAX_COMPILATION_CACHE_DIR
# if set, else <checkout>/.jax_cache): the suite is compile-bound on small
# hosts, and caching across runs cuts repeat wall time.
import cmdlmc_tpu  # noqa: E402,F401

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables_between_modules():
    """XLA's CPU backend segfaults inside backend_compile after a few hundred
    in-process compilations (reproduced twice at ~test 210 of the full suite;
    any sub-range of the suite passes solo). Dropping the live executables
    between modules keeps the in-process accumulation bounded; the persistent
    disk cache above keeps the re-compiles cheap."""
    yield
    jax.clear_caches()
