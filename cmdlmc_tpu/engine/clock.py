"""Time-dependent KMC clock as a per-frame state machine.

JAX recast of the reference's pull-based ``fastforward_to_next_jump``
(LMC/MDMC.py:121-171), the algorithmic core of the cMD/LMC scheme: kinetic Monte
Carlo with rates that change every MD frame (inhomogeneous Poisson process with
piecewise-constant rate).

The reference draws an exponential deviate and *pulls* MD frames through a
generator chain until the integrated rate exceeds the draw. Under ``lax.scan``
that inverts: every frame *pushes* one update into a small per-replica state

    u_remaining : the part of the current exponential draw not yet consumed
                  (dimensionless integrated rate, Σ rate·dt)
    phase       : time already consumed inside the current frame by the most
                  recent event, in [0, dt)
    event_count : total events so far — keys the per-event RNG draw stream so
                  results are independent of frame chunking
    last_event_frame / last_event_phase : exact event timestamp, kept as
                  (int frame, float32 offset) so kmc_time never loses precision
                  over million-frame runs (kmc_time = frame·dt + phase in f64 on
                  the host)

Within one frame, at most ``max_events`` events fire (a fixed bound so shapes are
static; rate·dt ≪ 1 in practice, cf. the a·dt scaling in the reference's legacy
driver KMC/excess_kmc.py:398-401). Rates may be recomputed after each in-frame
event via the ``rate_fn``/``apply_fn`` callbacks, which is how lattice occupancy
feeds back into the total rate — the reference keeps the stale frame rate within
a frame; recomputing is strictly more faithful to the master equation; the
reference's stale form is ``[Engine] stale_rates`` (engine/lattice.py).

Everything is branch-free (masked), so the whole clock vmaps over replicas.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp

Array = jax.Array


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "u_remaining",
        "phase",
        "event_count",
        "last_event_frame",
        "last_event_phase",
    ],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class ClockState:
    u_remaining: Array
    phase: Array
    event_count: Array
    last_event_frame: Array
    last_event_phase: Array


_DRAW_TAG = 1  # sub-stream for exponential waiting-time draws
_SELECT_TAG = 2  # sub-stream for transition-selection keys handed to apply_fn


def _draw_key(key: Array, ordinal: Array) -> Array:
    return jax.random.fold_in(jax.random.fold_in(key, _DRAW_TAG), ordinal)


def _select_key(key: Array, ordinal: Array) -> Array:
    return jax.random.fold_in(jax.random.fold_in(key, _SELECT_TAG), ordinal)


def init_clock(key: Array) -> ClockState:
    """Fresh clock: the i-th exponential draw is keyed purely by event ordinal i
    (never by frame index), so the draw stream is a pure function of
    (key, event index) — chunking the trajectory differently, or rates arriving
    on different frames, never perturbs the sequence of random numbers."""
    u0 = jax.random.exponential(_draw_key(key, 0), dtype=jnp.float32)
    return ClockState(
        u_remaining=u0,
        phase=jnp.float32(0.0),
        event_count=jnp.int32(0),
        last_event_frame=jnp.int32(-1),
        last_event_phase=jnp.float32(0.0),
    )


def frame_step(
    clock: ClockState,
    aux: Any,
    *,
    frame_idx: Array,
    dt: float,
    rate_fn: Callable[[Any], Array],
    apply_fn: Callable[[Any, Array, Array], Any],
    key: Array,
    max_events: int = 4,
) -> tuple[ClockState, Any, Array]:
    """Advance the clock across one MD frame of duration ``dt``.

    rate_fn(aux) -> total jump rate (scalar, 1/fs) under the current aux state.
    apply_fn(aux, event_key, event_phase) -> aux after applying one jump event.
        Called under a fired-mask: its result is only kept for lanes that fired.

    Returns (clock', aux', n_fired_this_frame).
    """
    dt = jnp.float32(dt)

    def body(_, carry):
        clock, aux, done, n_fired = carry
        rate = rate_fn(aux)
        t_avail = dt - clock.phase
        budget = rate * t_avail
        fire = jnp.logical_and(~done, clock.u_remaining <= budget)
        fire = jnp.logical_and(fire, budget > 0)

        safe_rate = jnp.where(rate > 0, rate, jnp.float32(1.0))
        event_phase = clock.phase + clock.u_remaining / safe_rate

        event_key = _select_key(key, clock.event_count)
        new_aux = apply_fn(aux, event_key, event_phase)
        aux = jax.tree.map(
            lambda new, old: jnp.where(
                jnp.reshape(fire, (1,) * old.ndim), new, old
            ),
            new_aux,
            aux,
        )

        next_u = jax.random.exponential(
            _draw_key(key, clock.event_count + 1), dtype=jnp.float32
        )
        clock = ClockState(
            u_remaining=jnp.where(fire, next_u, clock.u_remaining),
            phase=jnp.where(fire, event_phase, clock.phase),
            event_count=clock.event_count + fire.astype(jnp.int32),
            last_event_frame=jnp.where(fire, frame_idx, clock.last_event_frame),
            last_event_phase=jnp.where(fire, event_phase, clock.last_event_phase),
        )
        return clock, aux, jnp.logical_or(done, ~fire), n_fired + fire.astype(jnp.int32)

    carry = (clock, aux, jnp.bool_(False), jnp.int32(0))
    clock, aux, _, n_fired = jax.lax.fori_loop(0, max_events, body, carry)

    # No (further) event fires this frame: consume the leftover integrated rate and
    # hand a fresh frame (phase = 0) to the next step.
    rate = rate_fn(aux)
    leftover = rate * (dt - clock.phase)
    clock = dataclasses.replace(
        clock,
        u_remaining=clock.u_remaining - leftover,
        phase=jnp.float32(0.0),
    )
    return clock, aux, n_fired


def event_time(clock: ClockState, dt: float) -> Array:
    """Timestamp of the most recent event (frame·dt + phase) in f32; adequate for
    on-device use. For exact long-run timestamps use :func:`event_time_f64` on the
    host — the state deliberately stores (int frame, f32 phase) so no precision is
    ever lost on device."""
    return clock.last_event_frame.astype(jnp.float32) * jnp.float32(dt) + (
        clock.last_event_phase
    )


def event_time_f64(clock: ClockState, dt: float):
    """Host-side exact event timestamp reconstruction (float64)."""
    import numpy as np

    return np.asarray(clock.last_event_frame, dtype=np.float64) * float(dt) + (
        np.asarray(clock.last_event_phase, dtype=np.float64)
    )


def fastforward_events(
    rates: Array,
    dt: float,
    key: Array,
    *,
    max_events: int = 4,
) -> tuple[Array, Array]:
    """Standalone clock over a fixed per-frame rate array — the functional twin of
    the reference's ``fastforward_to_next_jump`` generator, used by the property
    tests (tests/LMC/test_MDMC.py:10-93 in the reference).

    Returns
    -------
    n_fired : int32[F]     events fired in each frame
    phases  : float32[F, max_events]  in-frame event times (NaN where unused)
    """
    rates = jnp.asarray(rates, dtype=jnp.float32)

    def scan_step(carry, inp):
        clock = carry
        frame_idx, rate = inp
        phases = jnp.full((max_events,), jnp.nan, dtype=jnp.float32)

        def rate_fn(aux):
            return rate

        def apply_fn(aux, event_key, event_phase):
            slot, ph = aux
            return slot + 1, ph.at[slot].set(event_phase)

        aux = (jnp.int32(0), phases)
        clock, (slots, phases), n_fired = frame_step(
            clock,
            aux,
            frame_idx=frame_idx,
            dt=dt,
            rate_fn=rate_fn,
            apply_fn=apply_fn,
            key=key,
            max_events=max_events,
        )
        return clock, (n_fired, phases)

    clock = init_clock(key)
    frame_indices = jnp.arange(rates.shape[0], dtype=jnp.int32)
    _, (n_fired, phases) = jax.lax.scan(scan_step, clock, (frame_indices, rates))
    return n_fired, phases
