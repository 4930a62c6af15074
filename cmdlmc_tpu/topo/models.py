"""Per-frame neighbor topology as dense masked tensor ops.

Replaces the reference's generator pipeline (topo/topology.py:18-257: O(N^2)
Python pair loops into scipy.sparse, Verlet-list bookkeeping, per-pair Cython
calls) with fixed-shape, frame-parallel rate-model builders:

* ``PairRates``        — NeighborTopology semantics: every donor pair within
                         cutoff+buffer carries rate law(d) (topology.py:55-121).
                         The dense recompute per frame is one fused elementwise
                         pass, so there is no Verlet buffer state to carry;
                         the ``buffer`` parameter still widens the inclusion
                         radius exactly like the reference's list construction.
* ``AnglePairRates``   — AngleTopology semantics: adds the P-O-O angle at the
                         donor as a second collective variable, with the static
                         O->P group map determined from the first frame
                         (topology.py:124-167).
* ``HydroniumRates``   — HydroniumTopology semantics: per-site K closest
                         neighbors, distances rescaled through a
                         DistanceTransformation and blended by per-proton
                         residence time (topology.py:170-257). Its rates depend
                         on replica state (who sits where since when), so it is
                         evaluated per replica inside the engine.

A rate model produces, per frame, either a dense rate matrix W[N, N] (shared by
all replicas — the engine reduces it with one matrix product) or a top-K neighbor list
(dist, nbr, valid) that the engine combines with per-replica state.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from cmdlmc_tpu.core.cell import Cell, angle as cell_angle, pairwise_distances

Array = jax.Array


def _pytree(cls=None, *, data_fields, meta_fields=()):
    if cls is None:
        return partial(_pytree, data_fields=data_fields, meta_fields=meta_fields)
    cls = dataclasses.dataclass(frozen=True)(cls)
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )


@_pytree(data_fields=["donors", "extras", "time", "index"])
class Frame:
    """One MD frame on device: donor positions [N, 3], optional extra-atom
    positions [M, 3] (e.g. phosphorus for angle gating), simulation time and
    frame index."""

    donors: Array
    extras: Any  # Array or None
    time: Array
    index: Array


@_pytree(data_fields=["W", "dist"])
class DenseShared:
    """Replica-independent dense rate matrix for one frame; W[i, j] is the jump
    rate donor i -> donor j, already masked (0 outside cutoff+buffer, 0 on the
    diagonal). ``dist`` keeps the raw pair distances for jump statistics."""

    W: Array
    dist: Array


@_pytree(data_fields=["dist", "dist_rescaled", "nbr", "valid", "time"])
class TopKShared:
    """Replica-independent top-K neighbor geometry for one frame."""

    dist: Array  # [N, K] raw minimum-image distances
    dist_rescaled: Array  # [N, K] after DistanceTransformation (== dist if none)
    nbr: Array  # [N, K] neighbor site indices
    valid: Array  # [N, K] inside cutoff+buffer and real (not padding)
    time: Array


# ----------------------------------------------------------------------------
# NeighborTopology
# ----------------------------------------------------------------------------


@_pytree(data_fields=["cell", "law", "cutoff", "buffer"])
class PairRates:
    """All donor pairs within cutoff+buffer carry rate law(d)."""

    cell: Cell
    law: Any
    cutoff: Array
    buffer: Array

    per_replica = False

    def shared(self, frame: Frame) -> DenseShared:
        d = pairwise_distances(self.cell, frame.donors, frame.donors)
        n = d.shape[0]
        valid = (d <= self.cutoff + self.buffer) & ~jnp.eye(n, dtype=bool)
        return DenseShared(W=jnp.where(valid, self.law(d), 0.0), dist=d)

    def replica_omega(self, shared: DenseShared, site_residence: Array):
        return shared


@_pytree(data_fields=["cell", "law", "cutoff", "buffer"], meta_fields=["k"])
class TopKPairRates:
    """NeighborTopology semantics with a K-nearest neighbor list instead of the
    dense [N, N] rate matrix — the analog of the reference's Verlet-list
    option (topology.py:80-114): for large supercells the dense W build and
    the O(N) per-event work dominate, while each donor only ever has a
    handful of neighbors inside cutoff+buffer.

    Exactly equivalent to :class:`PairRates` whenever ``k`` covers every
    neighbor within cutoff+buffer (the reference's own Verlet-equals-brute-force
    property, tests/topo/test_topology.py:68-101); rates beyond the K closest
    are dropped otherwise.
    """

    cell: Cell
    law: Any
    cutoff: Array
    buffer: Array
    k: int = 8

    per_replica = True  # engine top-K path; omega itself is replica-independent

    def shared(self, frame: Frame) -> TopKShared:
        d = pairwise_distances(self.cell, frame.donors, frame.donors)
        n = d.shape[0]
        d = jnp.where(jnp.eye(n, dtype=bool), jnp.inf, d)
        d = jnp.where(d <= self.cutoff + self.buffer, d, jnp.inf)
        dist, nbr = k_smallest(d, min(self.k, n - 1))
        valid = jnp.isfinite(dist)
        dist = jnp.where(valid, dist, 1e6)
        return TopKShared(
            dist=dist,
            dist_rescaled=dist,
            nbr=nbr.astype(jnp.int32),
            valid=valid,
            time=frame.time,
        )

    def replica_omega(self, shared: TopKShared, site_residence: Array):
        omega = jnp.where(shared.valid, self.law(shared.dist), 0.0)
        return omega, shared.nbr, shared.valid


# ----------------------------------------------------------------------------
# AngleTopology
# ----------------------------------------------------------------------------


def k_smallest(d: Array, k: int):
    """Exact k-nearest extraction: (dist [N, k] ascending, idx [N, k]).

    k unrolled argmin+mask passes, with ``lax.top_k(-d, k)``'s
    first-lowest-index tie-break on real entries (slots past the last finite
    distance may hold other indices; callers mask them by the distance). On
    an H100 (700 W) at k=8 this takes 0.195 ms at N=1152 against 0.206 ms for
    ``lax.top_k``, and 0.471 ms against 0.881 ms at N=4608. Past k=32 one
    ``lax.top_k`` sort replaces the unrolled passes, which would grow the
    traced program by k (the framework's neighbor-list k is 3-16)."""
    if k > 32:
        neg_d, idx = jax.lax.top_k(-d, k)
        return -neg_d, idx
    n = d.shape[-1]
    iota = jax.lax.broadcasted_iota(jnp.int32, d.shape, d.ndim - 1)
    dists, idxs = [], []
    for _ in range(k):
        i = jnp.argmin(d, axis=-1)
        dists.append(jnp.min(d, axis=-1))
        idxs.append(i)
        d = jnp.where(iota == i[..., None], jnp.inf, d)
    return jnp.stack(dists, axis=-1), jnp.stack(idxs, axis=-1)


def determine_groups(
    cell: Cell, extras: Array, donors: Array, group_size: int
) -> Array:
    """Static O -> P map: each extra atom (P) adopts its ``group_size`` closest
    donors (topology.py:142-156). Donors left unassigned by that scatter (a
    degenerate-geometry edge the reference would KeyError on) fall back to their
    nearest extra atom."""
    d_po = pairwise_distances(cell, extras, donors)  # [M, N]
    closest = jnp.argsort(d_po, axis=1)[:, :group_size]  # [M, group_size]
    n = donors.shape[0]
    o_to_p = jnp.full((n,), -1, dtype=jnp.int32)
    p_ids = jnp.broadcast_to(
        jnp.arange(extras.shape[0], dtype=jnp.int32)[:, None], closest.shape
    )
    o_to_p = o_to_p.at[closest.reshape(-1)].set(p_ids.reshape(-1))
    nearest_p = jnp.argmin(d_po, axis=0).astype(jnp.int32)
    return jnp.where(o_to_p < 0, nearest_p, o_to_p)


@_pytree(data_fields=["cell", "law", "cutoff", "buffer", "o_to_p"])
class AnglePairRates:
    """Pair rates gated by the P-O-O angle at the donor (AngleTopology)."""

    cell: Cell
    law: Any
    cutoff: Array
    buffer: Array
    o_to_p: Array  # [N] index of the extra atom grouped with each donor

    per_replica = False

    @classmethod
    def from_first_frame(cls, cell, law, cutoff, buffer, donors0, extras0, group_size):
        o_to_p = determine_groups(cell, extras0, donors0, group_size)
        return cls(
            cell=cell,
            law=law,
            cutoff=jnp.float32(cutoff),
            buffer=jnp.float32(buffer),
            o_to_p=o_to_p,
        )

    def shared(self, frame: Frame) -> DenseShared:
        donors = frame.donors
        d = pairwise_distances(self.cell, donors, donors)
        n = d.shape[0]
        p_of_donor = frame.extras[self.o_to_p]  # [N, 3]
        # angle at vertex O_i between its grouped P and every destination O_j
        # (topology.py:158-167)
        ang = cell_angle(
            self.cell,
            p_of_donor[:, None, :],
            donors[:, None, :],
            donors[None, :, :],
        )
        valid = (d <= self.cutoff + self.buffer) & ~jnp.eye(n, dtype=bool)
        return DenseShared(W=jnp.where(valid, self.law(d, ang), 0.0), dist=d)

    def replica_omega(self, shared: DenseShared, site_residence: Array):
        return shared


# ----------------------------------------------------------------------------
# HydroniumTopology
# ----------------------------------------------------------------------------


@_pytree(
    data_fields=["cell", "law", "cutoff", "buffer", "transform", "interpolator"],
    meta_fields=["k"],
)
class HydroniumRates:
    """K-closest-neighbor rates with residence-time distance relaxation.

    ``transform`` (DistanceTransformation) rescales O-O distances into effective
    O-H3O+ distances; ``interpolator`` (DistanceInterpolator) blends neutral ->
    rescaled as a function of how long the current proton has occupied the donor
    site. Either may be None (identity / instantaneous), matching the reference
    defaults (topology.py:187-199).
    """

    cell: Cell
    law: Any
    cutoff: Array
    buffer: Array
    transform: Any
    interpolator: Any
    k: int = 4

    per_replica = True

    def shared(self, frame: Frame) -> TopKShared:
        d = pairwise_distances(self.cell, frame.donors, frame.donors)
        n = d.shape[0]
        d = jnp.where(jnp.eye(n, dtype=bool), jnp.inf, d)
        d = jnp.where(d <= self.cutoff + self.buffer, d, jnp.inf)
        dist, nbr = k_smallest(d, min(self.k, n - 1))
        valid = jnp.isfinite(dist)
        dist = jnp.where(valid, dist, 1e6)
        rescaled = self.transform(dist) if self.transform is not None else dist
        return TopKShared(
            dist=dist,
            dist_rescaled=rescaled,
            nbr=nbr.astype(jnp.int32),
            valid=valid,
            time=frame.time,
        )

    def replica_omega(self, shared: TopKShared, site_residence: Array):
        """Effective rates for one replica given per-site residence times
        (seconds the occupying proton has been in place; -1 = never jumped)."""
        if self.interpolator is not None:
            d_eff = self.interpolator(
                site_residence[:, None], shared.dist, shared.dist_rescaled
            )
        else:
            d_eff = shared.dist_rescaled
        omega = jnp.where(shared.valid, self.law(d_eff), 0.0)
        return omega, shared.nbr, shared.valid
