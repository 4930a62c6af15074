"""Single-excess-proton water KMC (the legacy "KMCWater" scheme).

JAX re-provision of the reference's excess-proton driver
(KMC/excess_kmc.py:157-471) and its deleted Cython helper: one excess proton
hops between the K nearest oxygen neighbors of its current site, with

* rescaled O-O -> O-H3O+ distances (ramp / linear / interpolated transform,
  excess_kmc.py:66-85),
* ``relaxation_time``: after a jump, rates blend linearly from unrescaled to
  rescaled distances over that many frames (excess_kmc.py:208-221),
* ``waiting_time``: rates forced to zero for that many frames after a jump
  (excess_kmc.py:240-243),
* ``keep_last_neighbor_rescaled``: the connection back to the previous oxygen
  stays rescaled, including the 4-neighbor slot-shift variant
  (last_neighbor_is_close / _4oxys, excess_kmc.py:88-154),
* d_OH position correction: the tracked proton position is offset along each
  jump direction by 2 d_OH (PositionTracker, excess_kmc.py:250-277).

Where the reference caches per-frame neighbor distances in HDF5 and walks them
with generators, this engine recomputes the K-nearest topology per frame on
device (cheap: one [N, N] distance matrix + top_k) and runs thousands of
replicas vmapped — the state per replica is a handful of scalars.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp

from cmdlmc_tpu.topo.models import k_smallest as topo_k_smallest
from cmdlmc_tpu.core.cell import Cell, displacement as cell_displacement, pairwise_distances
from cmdlmc_tpu.engine import clock as kmc_clock
from cmdlmc_tpu.engine.clock import ClockState

Array = jax.Array


def _pytree(cls=None, *, data_fields, meta_fields=()):
    if cls is None:
        return partial(_pytree, data_fields=data_fields, meta_fields=meta_fields)
    cls = dataclasses.dataclass(frozen=True)(cls)
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )


@_pytree(
    data_fields=["cell", "law", "transform", "d_oh"],
    meta_fields=["n_atoms", "relaxation_time", "waiting_time",
                 "keep_last_neighbor_rescaled", "check_from_old"],
)
class WaterModel:
    """Static configuration of the water KMC (legacy KMCWater schema keys,
    IO/config_parser.py: relaxation_time, waiting_time, rescale_function,
    d_oh, n_atoms, keep_last_neighbor_rescaled, check_from_old)."""

    cell: Cell
    law: Any  # rate law on (possibly rescaled) distances, e.g. Fermi
    transform: Any  # DistanceTransformation or None
    d_oh: Array  # O-H bond length correction (0 disables)
    n_atoms: int = 3  # neighbors cached per site (3 or 4); rates use first 3
    relaxation_time: int = 0  # frames
    waiting_time: int = 0  # frames
    keep_last_neighbor_rescaled: bool = False
    check_from_old: bool = False


@_pytree(
    data_fields=[
        "site",
        "last_site",
        "frames_since_jump",
        "wait_left",
        "correction",
        "clock",
        "jumps",
        "snapshot",
        "displacement",
    ]
)
class WaterState:
    site: Array  # i32 current oxygen index
    last_site: Array  # i32 previous oxygen index, -1 before first jump
    frames_since_jump: Array  # i32, drives the relaxation blend
    wait_left: Array  # i32 frames of zero rate remaining
    correction: Array  # f32[3] accumulated d_OH correction vector
    clock: ClockState
    jumps: Array  # i32
    snapshot: Array  # f32[3] tracked proton position at previous frame
    displacement: Array  # f32[3] accumulated displacement


def init_water_states(
    key: Array, n_replicas: int, n_sites: int, first_positions: Array,
    start_position: int | None = None,
) -> WaterState:
    """Start each replica on a fixed or random oxygen
    (excess_kmc.py:383-391)."""

    def init_one(k):
        if start_position is None:
            site = jax.random.randint(k, (), 0, n_sites, dtype=jnp.int32)
        else:
            site = jnp.int32(start_position)
        return WaterState(
            site=site,
            last_site=jnp.int32(-1),
            frames_since_jump=jnp.int32(10**9),
            wait_left=jnp.int32(0),
            correction=jnp.zeros(3, jnp.float32),
            clock=kmc_clock.init_clock(jax.random.fold_in(k, 7)),
            jumps=jnp.int32(0),
            snapshot=first_positions[site],
            displacement=jnp.zeros(3, jnp.float32),
        )

    return jax.vmap(init_one)(jax.random.split(key, n_replicas))


def water_shared(model: WaterModel, positions: Array):
    """Per-frame shared geometry: K nearest neighbors of every oxygen (no
    cutoff — the legacy scheme always keeps exactly n_atoms neighbors,
    excess_kmc.py:406-413) plus the rescaled distances."""
    d = pairwise_distances(model.cell, positions, positions)
    n = d.shape[0]
    d = jnp.where(jnp.eye(n, dtype=bool), jnp.inf, d)
    dist, nbr = topo_k_smallest(d, model.n_atoms)
    resc = model.transform(dist) if model.transform is not None else dist
    return dist, resc, nbr.astype(jnp.int32)


def _candidates(model: WaterModel, shared, state_tuple):
    """The 3 candidate transitions of the current site: (rates [3], dst [3]).

    Applies the relaxation blend, the back-jump rescaling logic and the
    waiting-time gate, mirroring KMCGen.distance_generator /
    jumprate_generator (excess_kmc.py:199-246)."""
    dist, resc, nbr = shared
    site, last_site, fsj, wait_left = state_tuple

    d_raw = dist[site]  # [K]
    d_resc = resc[site]  # [K]
    neighbors = nbr[site]  # [K]

    if model.relaxation_time > 0:
        # clip below too: fsj = -1 right after a jump so the FIRST frame
        # after it evaluates at factor 0 (fully unrescaled), matching the
        # reference's relaxation_counter which starts at 0 on the next
        # generator pull (excess_kmc.py:205-221)
        factor = jnp.clip(
            fsj.astype(jnp.float32) / float(model.relaxation_time), 0.0, 1.0
        )
        d_eff = d_raw + factor * (d_resc - d_raw)
    else:
        d_eff = d_resc

    if model.keep_last_neighbor_rescaled:
        # Connection back to the previous oxygen is always fully rescaled.
        is_last = (neighbors == last_site) & (last_site >= 0)
        d_eff = jnp.where(is_last, d_resc, d_eff)
        if model.n_atoms == 4:
            # 4-neighbor variant: if the old oxygen sits in slot 3, promote it
            # to slot 2 so it lands among the 3 active candidates
            # (last_neighbor_is_close_4oxys, excess_kmc.py:131-154).
            in_slot3 = is_last[3]
            d_eff = d_eff.at[2].set(jnp.where(in_slot3, d_eff[3], d_eff[2]))
            neighbors = neighbors.at[2].set(
                jnp.where(in_slot3, neighbors[3], neighbors[2])
            )
        elif model.check_from_old:
            # If the connection only exists old -> new, swap the farthest
            # candidate for the old neighbor (excess_kmc.py:111-126).
            to_old_missing = ~is_last.any()
            old_row = nbr[jnp.maximum(last_site, 0)]
            new_in_old = (old_row == site).any() & (last_site >= 0)
            do_swap = to_old_missing & new_in_old
            far_slot = jnp.argmax(d_eff[:3])
            old_dist = resc[jnp.maximum(last_site, 0), (old_row == site).argmax()]
            d_eff = d_eff.at[far_slot].set(jnp.where(do_swap, old_dist, d_eff[far_slot]))
            neighbors = neighbors.at[far_slot].set(
                jnp.where(do_swap, last_site, neighbors[far_slot])
            )

    rates = model.law(d_eff[:3])
    rates = jnp.where(wait_left > 0, 0.0, rates)
    return rates, neighbors[:3]


def water_frame_step(
    model: WaterModel, positions: Array, frame_idx, frame_time, dt, max_events,
    state: WaterState, key,
):
    """Advance one replica across one frame."""
    shared = water_shared(model, positions)

    aux = (state.site, state.last_site, state.frames_since_jump,
           state.wait_left, state.jumps, state.correction)

    def rate_fn(aux):
        site, last_site, fsj, wait_left, jumps, corr = aux
        rates, _ = _candidates(model, shared, (site, last_site, fsj, wait_left))
        return rates.sum()

    def apply_fn(aux, event_key, event_phase):
        site, last_site, fsj, wait_left, jumps, corr = aux
        rates, cands = _candidates(model, shared, (site, last_site, fsj, wait_left))
        choice = jax.random.categorical(event_key, jnp.log(rates))
        new_site = cands[choice]
        # d_OH correction PER EVENT (PositionTracker, excess_kmc.py:265-277):
        # the proton lands 2 d_OH short of the full O-O step, so the
        # correction points from the NEW oxygen back toward the OLD one
        # (the reference computes atombox.distance(new, old) = old - new).
        # Applied inside the event loop so multi-event frames accumulate one
        # step per jump — exact, no folding approximation.
        vec = cell_displacement(model.cell, positions[new_site], positions[site])
        norm = jnp.sqrt(jnp.sum(vec * vec)) + 1e-12
        corr = corr + 2.0 * model.d_oh * vec / norm
        # fsj = -1 / wait = waiting+1: the end-of-frame counter pass runs on
        # the jump frame too, so the NEXT frame sees fsj=0 (relaxation factor
        # 0) and the next `waiting_time` frames see wait > 0 — the reference
        # consumes both counters once per generator pull AFTER the jump frame
        # (excess_kmc.py:205-246)
        wait0 = model.waiting_time + 1 if model.waiting_time else 0
        return (new_site, site, jnp.int32(-1),
                jnp.int32(wait0), jumps + 1, corr)

    new_clock, aux, n_fired = kmc_clock.frame_step(
        state.clock, aux,
        frame_idx=frame_idx, dt=dt,
        rate_fn=rate_fn, apply_fn=apply_fn, key=key, max_events=max_events,
    )
    site, last_site, fsj, wait_left, jumps, corr = aux

    # per-frame counters
    fsj = fsj + 1
    wait_left = jnp.maximum(wait_left - 1, 0)

    # tracked proton position and displacement
    newpos = positions[site] + corr
    disp = state.displacement + cell_displacement(model.cell, state.snapshot, newpos)

    return WaterState(
        site=site,
        last_site=last_site,
        frames_since_jump=fsj,
        wait_left=wait_left,
        correction=corr,
        clock=new_clock,
        jumps=jumps,
        snapshot=newpos,
        displacement=disp,
    ), n_fired


@partial(jax.jit, static_argnames=("dt", "max_events"))
def run_water_block(
    model: WaterModel, states: WaterState, keys: Array, positions_block: Array,
    frame_indices: Array, *, dt: float, max_events: int = 4,
):
    """Scan a block of frames over all replicas.

    positions_block: [B, N, 3] oxygen positions.
    Returns (states, per-frame (site[B, R], msd[B, 3] ensemble mean)).
    """

    def step(states, inp):
        positions, idx = inp
        time = idx.astype(jnp.float32) * jnp.float32(dt)

        def per_replica(state, key):
            return water_frame_step(
                model, positions, idx, time, dt, max_events, state, key
            )

        states2, _ = jax.vmap(per_replica)(states, keys)
        msd = (states2.displacement**2).mean(axis=0)
        return states2, (states2.site, msd)

    states, (sites, msd) = jax.lax.scan(step, states, (positions_block, frame_indices))
    return states, sites, msd
