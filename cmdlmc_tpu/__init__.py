"""cmdlmc_tpu — a JAX kinetic Monte Carlo framework for cMD/LMC simulations.

Re-implements the capabilities of the reference cMD/LMC package (combined molecular
dynamics / lattice Monte Carlo simulation of proton transport in hydrogen-bonded
solids) as a JAX/XLA framework:

* geometry (periodic minimum image, pairwise distances, angles) as pure JAX ops
  (replaces cython_exts/LMC/PBCHelper.pyx, atoms/numpyatom.pyx),
* per-frame neighbor topology as dense masked tensor ops (replaces topo/topology.py's
  generator + scipy.sparse pipeline),
* the time-dependent KMC clock ("fastforward_to_next_jump", LMC/MDMC.py:121-171)
  recast as a per-frame state machine inside `lax.scan`,
* proton-hop events selected by two-stage categorical sampling whose rate reductions
  are matrix products over replica occupancy matrices,
* thousands of independent KMC replicas vmapped per device and sharded across
  devices via `jax.sharding` (the reference is single-threaded CPU only).
"""

__version__ = "0.1.0"


def _enable_persistent_compile_cache():
    """Keep JAX's persistent compilation cache at ``<checkout>/.jax_cache``
    unless ``JAX_COMPILATION_CACHE_DIR`` is set (then JAX reads it itself and
    nothing is set here) or the cache was configured in-process already. The
    path is fixed because it is part of the cache key: a directory that moves
    never hits."""
    import os

    if "JAX_COMPILATION_CACHE_DIR" in os.environ:
        return
    import jax

    if jax.config.jax_compilation_cache_dir:
        return
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, ".jax_cache")
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:  # read-only install: run without a persistent cache
        return
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


_enable_persistent_compile_cache()
