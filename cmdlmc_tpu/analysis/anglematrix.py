"""Offline P-O-O angle-matrix builder.

Batched JAX re-provision of the reference's Cython analysis helper
(cython_exts/helper/analysis_helper.pyx:15-38 ``get_anglematrix``): for every
frame, for every O-O pair below a distance cutoff, compute the P-O-O angle at
the donor and mark pairs at or above the angle cutoff. Here the per-frame work
is one dense masked op, vmapped over a frame batch, instead of a scalar loop
with a progress ETA printout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cmdlmc_tpu.core.cell import Cell, angle as cell_angle, pairwise_distances

Array = jax.Array


def angle_matrix_frame(
    cell: Cell,
    o_pos: Array,
    p_pos: Array,
    o_to_p: Array,
    *,
    distance_cutoff: float = 3.0,
    angle_cutoff: float = jnp.pi / 2,
):
    """One frame: (angles [N, N], mask [N, N] of pairs within the distance
    cutoff whose P-O-O angle >= angle_cutoff)."""
    d = pairwise_distances(cell, o_pos, o_pos)
    n = o_pos.shape[0]
    close = (d < distance_cutoff) & ~jnp.eye(n, dtype=bool)
    p_of_donor = p_pos[o_to_p]  # [N, 3]
    angles = cell_angle(
        cell, p_of_donor[:, None, :], o_pos[:, None, :], o_pos[None, :, :]
    )
    return angles, close & (angles >= angle_cutoff)


def angle_matrix(
    cell: Cell,
    o_traj: Array,
    p_traj: Array,
    o_to_p: Array,
    *,
    distance_cutoff: float = 3.0,
    angle_cutoff: float = jnp.pi / 2,
):
    """Batched over frames: o_traj [F, N, 3], p_traj [F, M, 3] ->
    (angles [F, N, N], mask [F, N, N])."""
    fn = lambda o, p: angle_matrix_frame(
        cell, o, p, o_to_p,
        distance_cutoff=distance_cutoff, angle_cutoff=angle_cutoff,
    )
    return jax.vmap(fn)(o_traj, p_traj)
