"""Multi-proton KMC lattice engine: fused per-frame scan step, vmapped replicas.

JAX replacement for the reference's ``KMCLattice`` (LMC/MDMC.py:28-226).
The reference advances ONE lattice by pulling MD frames through a chain of Python
generators; here one ``lax.scan`` step per MD frame advances THOUSANDS of
independent replicas (the Monte Carlo analog of data parallelism):

  stage 1 (shared, once per frame)   — geometry -> rate matrix W[N, N] or top-K
                                       list; identical for every replica because
                                       all replicas ride the same MD trajectory.
  stage 2 (per replica, vmapped)     — occupancy masking, the KMC clock
                                       (engine/clock.py), event selection and
                                       lattice/observable updates.

The per-replica total jump rate — the reference's ``sum_of_jumprates``
(MDMC.py:85) gated by ``filter_allowed_transitions`` (MDMC.py:241-248: source
occupied AND destination free) — becomes

    R[r] = occ[r] @ W @ (1 - occ[r])

which under vmap is one matrix product over the replica batch per frame (in
full f32: the product is pinned to ``Precision.HIGHEST`` so that no backend
rounds it to TF32 or bf16). Transition selection
(``move_proton``'s cumsum / uniform / searchsorted, MDMC.py:101-119) becomes an
exactly equivalent two-stage categorical draw: source site with probability
proportional to its allowed outgoing rate-row sum, then destination from that
row — avoiding any R x N^2 materialization.
"""

from __future__ import annotations

import dataclasses
from functools import partial
import jax
import jax.numpy as jnp

from cmdlmc_tpu.core.cell import Cell, displacement as cell_displacement
from cmdlmc_tpu.engine import clock as kmc_clock
from cmdlmc_tpu.engine.clock import ClockState
from cmdlmc_tpu.topo.models import DenseShared, Frame

Array = jax.Array
HIGHEST = jax.lax.Precision.HIGHEST


def _pytree(cls=None, *, data_fields, meta_fields=()):
    if cls is None:
        return partial(_pytree, data_fields=data_fields, meta_fields=meta_fields)
    cls = dataclasses.dataclass(frozen=True)(cls)
    return jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )


@_pytree(
    data_fields=[
        "occ",
        "proton_of_site",
        "site_of_proton",
        "t_last_jump",
        "clock",
        "jumps",
        "disp_base",
        "autocorr_ref",
        "jump_hist",
        "opportunity_hist",
        "jump_matrix",
    ]
)
class ReplicaState:
    """Complete per-replica simulation state (one KMC chain).

    occ            f32[N]   1.0 where a proton sits (float for the rate product)
    proton_of_site i32[N]   proton label 1..P, 0 = empty (reference lattice
                            convention, MDMC.py:68-72)
    site_of_proton i32[P]   inverse map
    t_last_jump    f32[P]   absolute KMC time of each proton's last jump, -1 if
                            never (HydroniumTopology state, topology.py:211)
    clock          ClockState  the time-dependent KMC clock
    jumps          i32      events since the last observable reset
    disp_base      f32[P,3] jump-rebased displacement offset: the proton's total
                            PBC-unwrapped displacement since reset is
                            disp_base + site_disp[site] (site_disp is the shared
                            per-site displacement prefix sum carried by the
                            ensemble) — so the per-frame MSD bookkeeping costs
                            nothing per replica except on jump events
    autocorr_ref   i32[P]   site of each proton at the last reset
    jump_hist      i32[B]   distance-binned jump counts (jumpstat; B=0 disables)
    opportunity_hist f32[B] distance-binned allowed-transition exposure, in
                            units of frames (jump probability = jump_hist /
                            opportunity_hist)
    jump_matrix    i32[N,N] per-pair jump counts (legacy jumpmatrix capability,
                            IO/config_parser.py:300-306; shape (0,0) disables)
    """

    occ: Array
    proton_of_site: Array
    site_of_proton: Array
    t_last_jump: Array
    clock: ClockState
    jumps: Array
    disp_base: Array
    autocorr_ref: Array
    jump_hist: Array
    opportunity_hist: Array
    jump_matrix: Array


@_pytree(
    data_fields=[
        "frame",
        "time",
        "msd_mean",
        "msd_var",
        "autocorr_mean",
        "autocorr_var",
        "jumps_mean",
        "events_mean",
        "truncated_mean",
        "msd4_mean",
    ]
)
class ObsRow:
    """Per-frame ensemble observables (mean/variance across replicas).
    ``truncated_mean`` is the fraction of replicas that hit the per-frame
    event bound this frame — a nonzero value means max_events_per_frame should
    be raised (no silent caps). ``msd4_mean`` is the 4th displacement moment
    (the legacy ``higher_msd`` capability, IO/config_parser.py:350-355)."""

    frame: Array
    time: Array
    msd_mean: Array
    msd_var: Array
    autocorr_mean: Array
    autocorr_var: Array
    jumps_mean: Array
    events_mean: Array
    truncated_mean: Array
    msd4_mean: Array


@_pytree(data_fields=["replicas", "site_disp", "prev_pos"])
class EnsembleState:
    """Replica batch plus the shared trajectory-displacement carry.

    site_disp f32[N,3] — prefix sum of per-frame minimum-image donor-site
    displacements (identical for every replica; the key to O(events) instead of
    O(P) per-frame MSD bookkeeping). prev_pos f32[N,3] — donor positions of the
    previous frame."""

    replicas: ReplicaState
    site_disp: Array
    prev_pos: Array


def init_replicas(
    key: Array,
    n_replicas: int,
    n_sites: int,
    n_protons: int,
    first_positions: Array,
    *,
    hist_bins: int = 0,
    track_jump_matrix: bool = False,
) -> EnsembleState:
    """Random-occupancy initialization, the vmapped analog of the reference's
    shuffled label array (MDMC.py:68-72) — but with explicit keys instead of
    global RNG state (the reference's unseeded gap, SURVEY.md §5.2).

    ``hist_bins > 0`` enables distance-resolved jump statistics (jumpstat);
    ``track_jump_matrix`` enables the N x N pair jump counter."""

    jm = n_sites if track_jump_matrix else 0

    def init_one(k):
        sites = jax.random.permutation(k, n_sites)[:n_protons].astype(jnp.int32)
        occ = jnp.zeros((n_sites,), jnp.float32).at[sites].set(1.0)
        labels = jnp.arange(1, n_protons + 1, dtype=jnp.int32)
        proton_of_site = jnp.zeros((n_sites,), jnp.int32).at[sites].set(labels)
        return ReplicaState(
            occ=occ,
            proton_of_site=proton_of_site,
            site_of_proton=sites,
            t_last_jump=-jnp.ones((n_protons,), jnp.float32),
            clock=kmc_clock.init_clock(jax.random.fold_in(k, 7)),
            jumps=jnp.int32(0),
            disp_base=jnp.zeros((n_protons, 3), jnp.float32),
            autocorr_ref=sites,
            jump_hist=jnp.zeros((hist_bins,), jnp.int32),
            opportunity_hist=jnp.zeros((hist_bins,), jnp.float32),
            jump_matrix=jnp.zeros((jm, jm), jnp.int32),
        )

    replicas = jax.vmap(init_one)(jax.random.split(key, n_replicas))
    first = jnp.asarray(first_positions, jnp.float32)
    return EnsembleState(
        replicas=replicas,
        site_disp=jnp.zeros((n_sites, 3), jnp.float32),
        prev_pos=first,
    )


def _hist_bin(dist: Array, hist_range: tuple[float, float], n_bins: int) -> Array:
    lo, hi = hist_range
    raw = (dist - lo) / (hi - lo) * n_bins
    return jnp.clip(raw.astype(jnp.int32), 0, n_bins - 1)


def _hist_in_range(dist: Array, hist_range: tuple[float, float]) -> Array:
    lo, hi = hist_range
    return (dist >= lo) & (dist < hi)


# ----------------------------------------------------------------------------
# Per-replica physics
# ----------------------------------------------------------------------------


def _site_residence(occ, proton_of_site, t_last_jump, time):
    """Residence time of the proton occupying each site; -1 encodes 'never
    jumped' (maps to fully relaxed distances, topology.py:219)."""
    p_idx = jnp.maximum(proton_of_site - 1, 0)
    t_last = t_last_jump[p_idx]
    occupied = occ > 0
    never = t_last < 0
    return jnp.where(occupied & ~never, time - t_last, -1.0)


def _cdf_pick(weights: Array, key: Array) -> Array:
    """Inverse-CDF categorical draw: exactly the reference's cumsum / uniform /
    searchsorted (MDMC.py:109-113), one uniform per draw — two orders of
    magnitude less RNG work per frame than a Gumbel draw over the weights."""
    total = weights.sum()
    u = jax.random.uniform(key, dtype=weights.dtype) * total
    cdf = jnp.cumsum(weights)
    return jnp.minimum(jnp.sum(cdf < u), weights.shape[0] - 1).astype(jnp.int32)


def outgoing_rates(W: Array, occ: Array) -> Array:
    """Allowed outgoing rate of every site of one replica,
    ``out[i] = sum_j W[i, j] (1 - occ[j])``, in full f32: at the default
    precision a GPU may round the product to TF32 (~1e-3 relative)."""
    return jnp.matmul(W, 1.0 - occ, precision=HIGHEST)


def _topk_allowed(model, shared, aux, time):
    occ, proton_of_site, _, t_last = aux[0], aux[1], aux[2], aux[3]
    residence = _site_residence(occ, proton_of_site, t_last, time)
    omega, nbr, valid = model.replica_omega(shared, residence)
    allowed = omega * occ[:, None] * (1.0 - occ[nbr])
    return allowed, nbr


def _replica_frame_step(
    model, frame, site_disp, dt, max_events, hist_range, state: ReplicaState, key,
    stale_rates=False,
):
    """Advance one replica across one MD frame. ``key`` must be unique per
    replica but MUST NOT vary with the frame (the clock folds in event ordinals,
    keeping the draw stream chunking-invariant — see engine/clock.py).

    Dense path: ONE [N, N] mat-vec per frame establishes the per-site outgoing
    rate vector ``out[i] = sum_j W_ij (1 - occ_j)``; in-frame events update it
    incrementally in O(N) (freeing site s adds column W[:, s], filling site d
    subtracts W[:, d]) — the total-rate reduction the clock needs is then just
    ``sum(occ * out)`` per iteration instead of a fresh matmul.

    ``stale_rates`` (dense only) is the reference's in-frame semantics
    (MDMC.py:121-171): the allowed-rate rows ``occ * out`` and their total are
    built once per frame; in-frame events draw the source from those rows
    masked by CURRENT occupancy and the destination from the current
    vacancies, while the clock integrates the frame-start total."""
    shared = model.shared(frame)
    n_bins = state.jump_hist.shape[0]
    track_matrix = state.jump_matrix.shape[0] > 0
    dense = isinstance(shared, DenseShared)
    if dense:
        W = shared.W
        WT = shared.W.T
        out0 = outgoing_rates(W, state.occ)
        row0 = state.occ * out0
        total0 = row0.sum()
    else:
        out0 = jnp.zeros((0,), jnp.float32)  # unused

    aux = (
        state.occ,
        state.proton_of_site,
        state.site_of_proton,
        state.t_last_jump,
        out0,
        state.jumps,
        state.jump_hist,
        state.jump_matrix,
        state.disp_base,
    )

    def rate_fn(aux):
        occ, out = aux[0], aux[4]
        if stale_rates:
            return total0
        if dense:
            return (occ * out).sum()
        allowed, _ = _topk_allowed(model, shared, aux, frame.time)
        return allowed.sum()

    def apply_fn(aux, event_key, event_phase):
        (occ, proton_of_site, site_of_proton, t_last, out, jumps, hist, jmat,
         disp_base) = aux
        k1, k2 = jax.random.split(event_key)
        if dense:
            src_w = row0 * occ if stale_rates else occ * out
            src = _cdf_pick(src_w, k1)
            dst_w = W[src] * (1.0 - occ)
            dst = _cdf_pick(dst_w, k2)
            d_evt = shared.dist[src, dst]
            out = out + WT[src] - WT[dst]
        else:
            allowed, nbr = _topk_allowed(model, shared, aux, frame.time)
            kk = allowed.shape[1]
            flat = _cdf_pick(allowed.reshape(-1), k1)
            src = (flat // kk).astype(jnp.int32)
            dst = nbr.reshape(-1)[flat].astype(jnp.int32)
            d_evt = shared.dist.reshape(-1)[flat]
        label = proton_of_site[src]
        p_idx = jnp.maximum(label - 1, 0)
        t_event = frame.time + event_phase
        occ = occ.at[src].set(0.0).at[dst].set(1.0)
        proton_of_site = proton_of_site.at[src].set(0).at[dst].set(label)
        site_of_proton = site_of_proton.at[p_idx].set(dst)
        t_last = t_last.at[p_idx].set(t_event)
        # MSD rebase: total displacement stays continuous through the jump
        # (disp = disp_base + site_disp[site]); the jump vector itself is the
        # minimum-image src -> dst connection at this frame (output.py:35-43).
        jump_vec = cell_displacement(
            model.cell, frame.donors[src], frame.donors[dst]
        )
        disp_base = disp_base.at[p_idx].add(
            site_disp[src] - site_disp[dst] + jump_vec
        )
        if n_bins > 0:
            inc = _hist_in_range(d_evt, hist_range).astype(jnp.int32)
            hist = hist.at[_hist_bin(d_evt, hist_range, n_bins)].add(inc)
        if track_matrix:
            jmat = jmat.at[src, dst].add(1)
        new = (occ, proton_of_site, site_of_proton, t_last, out,
               jumps + 1, hist, jmat, disp_base)
        if stale_rates:
            # the frame-start total can outlive every allowed move (the
            # movers' new sites carry no stale row): such a draw moves nothing
            movable = (src_w.sum() > 0) & (dst_w.sum() > 0)
            new = jax.tree.map(
                lambda n, o: jnp.where(movable, n, o), new, aux
            )
        return new

    new_clock, aux, n_fired = kmc_clock.frame_step(
        state.clock,
        aux,
        frame_idx=frame.index,
        dt=dt,
        rate_fn=rate_fn,
        apply_fn=apply_fn,
        key=key,
        max_events=max_events,
    )
    (occ, proton_of_site, site_of_proton, t_last, _, jumps, hist, jmat,
     disp_base) = aux

    opp = state.opportunity_hist
    if n_bins > 0:
        # Exposure: which allowed transitions existed this frame, binned by
        # their raw pair distance (jump probability = jump_hist / exposure).
        if isinstance(shared, DenseShared):
            allowed_mask = (shared.W > 0) * occ[:, None] * (1.0 - occ[None, :])
            dists = shared.dist
        else:
            residence = _site_residence(occ, proton_of_site, t_last, frame.time)
            omega, nbr, valid = model.replica_omega(shared, residence)
            allowed_mask = valid * (omega > 0) * occ[:, None] * (1.0 - occ[nbr])
            dists = shared.dist
        weights = allowed_mask * _hist_in_range(dists, hist_range)
        opp = opp + jax.ops.segment_sum(
            weights.reshape(-1),
            _hist_bin(dists, hist_range, n_bins).reshape(-1),
            num_segments=n_bins,
        )

    return (
        dataclasses.replace(
            state,
            occ=occ,
            proton_of_site=proton_of_site,
            site_of_proton=site_of_proton,
            t_last_jump=t_last,
            clock=new_clock,
            jumps=jumps,
            jump_hist=hist,
            jump_matrix=jmat,
            opportunity_hist=opp,
            disp_base=disp_base,
        ),
        n_fired,
    )


# ----------------------------------------------------------------------------
# Scan driver
# ----------------------------------------------------------------------------


def proton_displacement(states: ReplicaState, site_disp):
    """Total PBC-unwrapped displacement of each proton since the last reset:
    disp_base + site_disp[current site]. Batched over replicas."""
    return states.disp_base + site_disp[states.site_of_proton]


def observables_of(states: ReplicaState, site_disp):
    """(msd[.., 3], autocorr count) per replica. This is the only place the
    [R, P] position gather happens — callers run it under a frame-level cond on
    print frames only."""
    disp = proton_displacement(states, site_disp)
    n_protons = disp.shape[-2]
    msd = jnp.sum(disp**2, axis=-2) / n_protons
    autocorr = jnp.sum(
        (states.site_of_proton == states.autocorr_ref).astype(jnp.int32), axis=-1
    )
    return msd, autocorr


def displacement_moment4(states: ReplicaState, site_disp):
    """Per-replica mean of |disp|^4 over protons (legacy higher_msd,
    IO/config_parser.py:350-355)."""
    disp = proton_displacement(states, site_disp)
    r2 = jnp.sum(disp * disp, axis=-1)
    return jnp.mean(r2 * r2, axis=-1)


def per_proton_variance(states: ReplicaState, site_disp):
    """The reference's ``variance_per_proton`` statistic (config_parser.py:
    356-363 help text; computed with the Welford-with-mask generator,
    misc/tools.py:18-54): variance ACROSS PROTON TRAJECTORIES within one
    chain — of each proton's squared displacement per component, and of the
    per-proton still-on-reference-site indicator. Returned per replica
    ([R, 3], [R]); callers average over replicas (the reference ran exactly
    one chain)."""
    disp = proton_displacement(states, site_disp)  # [R, P, 3]
    msd_var = (disp * disp).var(axis=-2)
    ind = (states.site_of_proton == states.autocorr_ref).astype(jnp.float32)
    return msd_var, ind.var(axis=-1)


def _make_row(states: ReplicaState, site_disp, frame, variance_mode="replicas"):
    msd, autocorr = observables_of(states, site_disp)
    if variance_mode == "protons":
        pv_msd, pv_auto = per_proton_variance(states, site_disp)
        msd_var = pv_msd.mean(axis=0)
        autocorr_var = pv_auto.mean()
    else:
        msd_var = msd.var(axis=0)
        autocorr_var = autocorr.astype(jnp.float32).var()
    return ObsRow(
        frame=frame.index,
        time=frame.time,
        msd_mean=msd.mean(axis=0),
        msd_var=msd_var,
        autocorr_mean=autocorr.astype(jnp.float32).mean(),
        autocorr_var=autocorr_var,
        jumps_mean=states.jumps.astype(jnp.float32).mean(),
        events_mean=states.clock.event_count.astype(jnp.float32).mean(),
        truncated_mean=jnp.float32(0.0),
        msd4_mean=displacement_moment4(states, site_disp).mean(),
    )


def _empty_row(frame):
    z3 = jnp.zeros(3, jnp.float32)
    z = jnp.float32(0.0)
    return ObsRow(frame=frame.index, time=frame.time, msd_mean=z3, msd_var=z3,
                  autocorr_mean=z, autocorr_var=z, jumps_mean=z, events_mean=z,
                  truncated_mean=z, msd4_mean=z)


def _reset_states(states: ReplicaState, site_disp):
    """Observable reset (MDMC.py:198-201): zero displacement and jump counter,
    re-snapshot the autocorrelation reference. Rebasing disp_base to
    -site_disp[site] makes the current displacement exactly zero."""
    sites = states.site_of_proton
    return dataclasses.replace(
        states,
        disp_base=-site_disp[sites],
        jumps=jnp.zeros_like(states.jumps),
        autocorr_ref=sites,
    )


def _block_scan(model, cell, ens, keys, frames, dt, max_events,
                reset_frequency, hist_range, emit_every, with_sites,
                equilibration=0, variance_mode="replicas", stale_rates=False):
    if stale_rates and model.per_replica:
        raise ValueError(
            "stale_rates applies to dense rate models (PairRates, "
            f"AnglePairRates), not {type(model).__name__}"
        )

    def step(carry, frame):
        states, site_disp, prev_pos = carry
        site_disp = site_disp + cell_displacement(cell, prev_pos, frame.donors)

        def per_replica(state, key):
            return _replica_frame_step(
                model, frame, site_disp, dt, max_events, hist_range, state, key,
                stale_rates,
            )

        states, n_fired = jax.vmap(per_replica)(states, keys)

        reset = jnp.bool_(False)
        if reset_frequency > 0:
            reset = jnp.logical_and(
                frame.index % reset_frequency == 0, frame.index > 0
            )
        if equilibration > 0:
            # one-time observable reset when equilibration ends (legacy
            # equilibration_sweeps, IO/config_parser.py)
            reset = jnp.logical_or(reset, frame.index == equilibration)
        if reset_frequency > 0 or equilibration > 0:
            states = jax.lax.cond(
                reset, lambda s: _reset_states(s, site_disp), lambda s: s, states
            )

        if emit_every > 1:
            emit = frame.index % emit_every == 0
            row = jax.lax.cond(
                emit,
                lambda: _make_row(states, site_disp, frame, variance_mode),
                lambda: _empty_row(frame),
            )
        else:
            row = _make_row(states, site_disp, frame, variance_mode)
        # event-bound telemetry is never gated: a replica that used all
        # max_events slots this frame may have been truncated
        row = dataclasses.replace(
            row,
            truncated_mean=(n_fired >= max_events).astype(jnp.float32).mean(),
        )

        out = (row, states.site_of_proton[0]) if with_sites else row
        return (states, site_disp, frame.donors), out

    carry = (ens.replicas, ens.site_disp, ens.prev_pos)
    (replicas, site_disp, prev_pos), ys = jax.lax.scan(step, carry, frames)
    ens = dataclasses.replace(
        ens, replicas=replicas, site_disp=site_disp, prev_pos=prev_pos
    )
    return ens, ys


@partial(
    jax.jit,
    static_argnames=("dt", "max_events", "reset_frequency", "hist_range",
                     "emit_every", "equilibration", "variance_mode",
                     "stale_rates"),
)
def run_block(
    model,
    cell: Cell,
    ens: EnsembleState,
    keys: Array,
    frames: Frame,
    *,
    dt: float,
    max_events: int = 4,
    reset_frequency: int = 0,
    hist_range: tuple = (2.0, 3.0),
    emit_every: int = 1,
    equilibration: int = 0,
    variance_mode: str = "replicas",
    stale_rates: bool = False,
) -> tuple[EnsembleState, ObsRow]:
    """Advance all replicas across a block of frames (stacked leading axis).

    Returns the final ensemble plus per-frame observables (zero-filled on
    frames where ``emit_every`` suppresses the reduction — host code filters by
    print frequency anyway). The clock's event-ordinal keying makes the result
    independent of the block chunking.
    """
    return _block_scan(model, cell, ens, keys, frames, dt, max_events,
                       reset_frequency, hist_range, emit_every,
                       with_sites=False, equilibration=equilibration,
                       variance_mode=variance_mode, stale_rates=stale_rates)


@partial(
    jax.jit,
    static_argnames=("dt", "max_events", "reset_frequency", "hist_range",
                     "emit_every", "equilibration", "stale_rates"),
)
def run_block_with_sites(
    model,
    cell: Cell,
    ens: EnsembleState,
    keys: Array,
    frames: Frame,
    *,
    dt: float,
    max_events: int = 4,
    reset_frequency: int = 0,
    hist_range: tuple = (2.0, 3.0),
    emit_every: int = 1,
    equilibration: int = 0,
    stale_rates: bool = False,
):
    """Like :func:`run_block`, additionally emitting replica 0's proton site
    indices per frame — feeds the XYZOutput mode (MDMC.py:173-177)."""
    ens, (rows, sites) = _block_scan(
        model, cell, ens, keys, frames, dt, max_events, reset_frequency,
        hist_range, emit_every, with_sites=True, equilibration=equilibration,
        stale_rates=stale_rates,
    )
    return ens, rows, sites
