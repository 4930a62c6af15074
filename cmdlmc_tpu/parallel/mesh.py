"""Device-mesh scaling for replica ensembles.

The reference is strictly single-process/single-thread (SURVEY.md §2: no
MPI/NCCL/threads anywhere); its only scaling story was "run many seeds by hand
and average offline" (average_MC_out.py:115-125). Here the replica axis is a
first-class sharded dimension: per-replica state is laid out with a
``NamedSharding`` over a 1-D mesh, the jitted engine partitions automatically
under GSPMD, and the only cross-device traffic is the tiny per-frame
observable all-reduce (mean/var over replicas).

Trajectory frames are replicated to every device (they are identical for all
replicas). The mesh is 1-D over the replica axis: every device pair is
equally close, so no other shape is needed.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

REPLICA_AXIS = "replica"


def replica_mesh(devices=None, axis: str = REPLICA_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def shard_replicas(tree, mesh: Mesh, axis: str = REPLICA_AXIS):
    """Place every leaf with its leading (replica) dimension split across the
    mesh. Scalar/unbatched leaves are replicated."""
    def put(x):
        x = jax.numpy.asarray(x)
        if x.ndim == 0:
            return jax.device_put(x, NamedSharding(mesh, P()))
        return jax.device_put(x, NamedSharding(mesh, P(axis)))

    return jax.tree.map(put, tree)


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (e.g. frame blocks, model params) on every device."""
    return jax.tree.map(
        lambda x: jax.device_put(jax.numpy.asarray(x), NamedSharding(mesh, P())),
        tree,
    )


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_ensemble(ens, mesh: Mesh, axis: str = REPLICA_AXIS):
    """Shard an EnsembleState: per-replica leaves split over the mesh, the
    shared trajectory carry (site_disp / prev_pos) replicated."""
    import dataclasses

    return dataclasses.replace(
        ens,
        replicas=shard_replicas(ens.replicas, mesh, axis),
        site_disp=jax.device_put(ens.site_disp, NamedSharding(mesh, P())),
        prev_pos=jax.device_put(ens.prev_pos, NamedSharding(mesh, P())),
    )
