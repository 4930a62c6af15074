"""Physics of the scan engine across its rate models: state invariants and the
exact event-rate law, the random-walk MSD law on a ring, triclinic jump
vectors, residence-time relaxation, angle gating, jump-matrix bookkeeping,
stale in-frame rates, and invariance under block chunking and under sharding
the replica axis over 8 (virtual) devices."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cmdlmc_tpu.core.cell import Cell, minimum_image
from cmdlmc_tpu.engine import lattice as eng
from cmdlmc_tpu.rates.laws import Constant, Fermi, FermiAngle
from cmdlmc_tpu.topo.models import (
    AnglePairRates, Frame, HydroniumRates, PairRates, TopKPairRates,
)
from cmdlmc_tpu.topo.transforms import DistanceInterpolator, ReLUTransformation

DT = 0.5
F32 = jnp.float32
TRICLINIC = Cell.triclinic([[12, 0, 0], [4, 11, 0], [1, 0, 10]])


def frames_of(donors, extras=None, start=0):
    n = donors.shape[0]
    idx = jnp.arange(start, start + n, dtype=jnp.int32)
    return Frame(
        donors=jnp.asarray(donors, jnp.float32),
        extras=None if extras is None else jnp.asarray(extras, jnp.float32),
        time=idx.astype(jnp.float32) * F32(DT), index=idx,
    )


def drift(positions, n_frames, scale=0.04, seed=11):
    rng = np.random.RandomState(seed)
    return (positions[None] + rng.normal(
        scale=scale, size=(n_frames, *positions.shape))).astype(np.float32)


def init(n_replicas, n_sites, n_protons, first, *, seed=0, **kw):
    key = jax.random.key(seed)
    ens = eng.init_replicas(jax.random.fold_in(key, 0), n_replicas, n_sites,
                            n_protons, jnp.asarray(first, jnp.float32), **kw)
    keys = jax.random.split(jax.random.fold_in(key, 1), n_replicas)
    return ens, keys


def run(model, cell, ens, keys, donors, extras=None, chunks=(None,), **kw):
    """Run the frames in consecutive blocks split at ``chunks``."""
    kw.setdefault("dt", DT)
    bounds = [0] + [c for c in chunks if c is not None] + [donors.shape[0]]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        ens, _ = eng.run_block(
            model, cell, ens, keys,
            frames_of(donors[lo:hi], None if extras is None else extras[lo:hi],
                      start=lo), **kw)
    return ens


def events_of(ens):
    return np.asarray(ens.replicas.clock.event_count, float)


def check_invariants(rep, n_protons):
    occ = np.asarray(rep.occ)
    np.testing.assert_allclose(occ.sum(axis=1), n_protons, atol=1e-5)
    pos_map = np.asarray(rep.proton_of_site)
    site_map = np.asarray(rep.site_of_proton)
    for r in range(occ.shape[0]):
        np.testing.assert_array_equal((pos_map[r] > 0).astype(float), occ[r])
        np.testing.assert_array_equal(pos_map[r][site_map[r]],
                                      np.arange(1, n_protons + 1))


def constant_model(kind, cell, n_sites, a):
    law = Constant(a=F32(a))
    if kind == "dense":
        return PairRates(cell=cell, law=law, cutoff=F32(100.0), buffer=F32(0.0))
    return TopKPairRates(cell=cell, law=law, cutoff=F32(100.0),
                         buffer=F32(0.0), k=n_sites - 1)


@pytest.mark.parametrize("triclinic", [False, True])
@pytest.mark.parametrize("kind", ["dense", "topk"])
def test_invariants_and_event_rate(kind, triclinic):
    """Constant law over all pairs: the expected event count is exactly
    a * P * (N - P) * dt per frame, and the occupancy maps stay consistent."""
    n_sites, n_protons, R, F, a = 10, 4, 32, 300, 0.04
    cell = TRICLINIC if triclinic else Cell.cubic([30.0] * 3)
    pos = np.random.RandomState(3).uniform(0, 8.0, (n_sites, 3)).astype(np.float32)
    model = constant_model(kind, cell, n_sites, a)
    ens, keys = init(R, n_sites, n_protons, pos, seed=5)
    ens = run(model, cell, ens, keys, np.broadcast_to(pos, (F, n_sites, 3)))
    check_invariants(ens.replicas, n_protons)
    counts = events_of(ens)
    expected = a * n_protons * (n_sites - n_protons) * DT * F
    z = (counts.mean() - expected) / np.sqrt(expected / R)
    assert abs(z) < 5, (counts.mean(), expected, z)
    assert counts.min() > 0


@pytest.mark.parametrize("kind", ["dense", "topk"])
def test_ring_walk_msd_exact_law(kind):
    """Periodic ring of 12 sites 2 A apart: each jump moves the proton 2 A
    along x, so E[msd] = 4 E[events] and y/z never move."""
    N, P, R, F, a = 12, 1, 128, 400, 0.04
    pos = np.zeros((N, 3), np.float32)
    pos[:, 0] = 2.0 * np.arange(N)
    cell = Cell.cubic([24.0, 24.0, 24.0])
    law = Constant(a=F32(a))
    if kind == "dense":
        model = PairRates(cell=cell, law=law, cutoff=F32(2.1), buffer=F32(0.0))
    else:
        model = TopKPairRates(cell=cell, law=law, cutoff=F32(2.1),
                              buffer=F32(0.0), k=4)
    ens, keys = init(R, N, P, pos, seed=1)
    ens = run(model, cell, ens, keys, np.broadcast_to(pos, (F, N, 3)))
    disp = np.asarray(eng.proton_displacement(ens.replicas, ens.site_disp))
    msd = (disp**2).sum(axis=(1, 2))
    events = events_of(ens)
    se = msd.std(ddof=1) / np.sqrt(R)
    assert abs(msd.mean() - 4.0 * events.mean()) < 5 * se + 0.05 * msd.mean()
    np.testing.assert_allclose(disp[:, :, 1:], 0.0, atol=1e-5)


@pytest.mark.parametrize("kind", ["dense", "topk"])
def test_triclinic_jump_vector_minimum_image(kind):
    """Two sites across a skewed boundary: the recorded displacement is the
    triclinic minimum-image vector, not the raw difference."""
    tri = Cell.triclinic([[10, 0, 0], [4, 9, 0], [0, 0, 8]])
    pos = np.array([[0.5, 4.0, 4.0], [9.7, 4.4, 4.0]], np.float32)
    mi = np.asarray(minimum_image(tri, jnp.asarray(pos[1] - pos[0])))
    assert np.linalg.norm(mi) < np.linalg.norm(pos[1] - pos[0])
    model = constant_model(kind, tri, 2, 0.5)
    R = 8
    ens, keys = init(R, 2, 1, pos, seed=5)
    ens = run(model, tri, ens, keys, np.broadcast_to(pos, (40, 2, 3)))
    disp = np.asarray(ens.replicas.disp_base)[:, 0, :]
    counts = np.asarray(ens.replicas.clock.event_count)
    assert counts.sum() > 0
    for r in range(R):
        # an even number of jumps brings the proton back
        target = 0.0 if counts[r] % 2 == 0 else np.linalg.norm(mi)
        np.testing.assert_allclose(np.linalg.norm(disp[r]), target, atol=1e-4)


def hydronium_model(cell, interpolator):
    transform = ReLUTransformation(a=F32(0.2), b=F32(2.2), d0=F32(2.2),
                                   left_bound=F32(0.5), right_bound=F32(4.0))
    return HydroniumRates(
        cell=cell, law=Fermi(a=F32(0.06), b=F32(2.3), c=F32(0.1)),
        cutoff=F32(3.0), buffer=F32(1.0), transform=transform,
        interpolator=interpolator, k=4)


def random_sites(n, box, seed=7):
    return np.random.RandomState(seed).uniform(0, box, (n, 3)).astype(np.float32)


def test_hydronium_relaxation_changes_dynamics():
    """The residence-time blend matters: after a jump a slowly relaxing
    proton sees the longer neutral distances, so it fires fewer events than
    an instantly relaxed one. Sites on a square grid 3 A apart: neutral
    rates are ~5e-5/fs, rescaled (2.36 A) ones ~0.02/fs."""
    cell = Cell.cubic([12.0, 12.0, 10.0])
    grid = np.array([[3.0 * i, 3.0 * j, 5.0] for i in range(4)
                     for j in range(4)], np.float32)
    frames = drift(grid, 150)
    inst = hydronium_model(cell, None)
    slow = hydronium_model(cell, DistanceInterpolator(relaxation_time=F32(1e5)))
    ens, keys = init(32, 16, 5, frames[0], seed=2)
    ev_i = events_of(run(inst, cell, ens, keys, frames))
    ev_s = events_of(run(slow, cell, ens, keys, frames))
    assert ev_s.mean() < 0.9 * ev_i.mean(), (ev_s.mean(), ev_i.mean())


def angle_model(theta, cell, frames, extras):
    law = FermiAngle(a=F32(0.06), b=F32(2.3), c=F32(0.3), theta=F32(theta))
    return AnglePairRates.from_first_frame(
        cell, law, cutoff=3.0, buffer=1.0, donors0=jnp.asarray(frames[0]),
        extras0=jnp.asarray(extras[0]), group_size=3)


def test_angle_gate_suppresses_events():
    """A tight P-O-O angle threshold cuts the event rate well below the
    ungated one."""
    cell = Cell.cubic([10.0] * 3)
    frames = drift(random_sites(12, 10.0), 200)
    extras = drift(random_sites(4, 10.0, seed=8), 200, seed=12)
    ens, keys = init(32, 12, 4, frames[0], seed=3)
    ev_open = events_of(run(angle_model(0.0, cell, frames, extras), cell, ens,
                            keys, frames, extras))
    ev_tight = events_of(run(angle_model(2.4, cell, frames, extras), cell, ens,
                             keys, frames, extras))
    assert ev_open.mean() > 0
    assert ev_tight.mean() < 0.5 * ev_open.mean(), (ev_tight.mean(),
                                                   ev_open.mean())


@pytest.mark.parametrize("kind", ["dense", "topk"])
def test_jump_matrix_counts_every_event(kind):
    cell = Cell.cubic([10.0] * 3)
    frames = drift(random_sites(12, 10.0), 150)
    law = Fermi(a=F32(0.08), b=F32(3.2), c=F32(0.3))
    if kind == "dense":
        model = PairRates(cell=cell, law=law, cutoff=F32(3.0), buffer=F32(1.5))
    else:
        model = TopKPairRates(cell=cell, law=law, cutoff=F32(3.0),
                              buffer=F32(1.5), k=11)
    ens, keys = init(16, 12, 4, frames[0], seed=2, track_jump_matrix=True)
    ens = run(model, cell, ens, keys, frames)
    jm = np.asarray(ens.replicas.jump_matrix, np.int64)
    np.testing.assert_array_equal(jm.sum(axis=(1, 2)), events_of(ens))
    assert jm.sum() > 0
    assert np.all(np.einsum("rii->ri", jm) == 0)  # never a self-jump


# ---------------------------------------------------------------------------
# chunk and sharding invariance, per rate model
# ---------------------------------------------------------------------------


def scenario(name):
    """(model, cell, donors, extras, init kwargs, run kwargs)."""
    frames = drift(random_sites(16, 10.0), 24)
    cell = Cell.cubic([10.0] * 3)
    law = Fermi(a=F32(0.1), b=F32(2.5), c=F32(0.3))
    extras = None
    init_kw, run_kw = {}, {}
    if name == "dense":
        model = PairRates(cell=cell, law=law, cutoff=F32(3.0), buffer=F32(1.0))
    elif name == "topk":
        model = TopKPairRates(cell=cell, law=law, cutoff=F32(3.0),
                              buffer=F32(1.0), k=6)
    elif name == "hydronium":
        model = hydronium_model(cell, DistanceInterpolator(
            relaxation_time=F32(2.0)))
    elif name == "angle":
        extras = drift(random_sites(4, 10.0, seed=8), 24, seed=12)
        model = angle_model(1.0, cell, frames, extras)
    elif name == "triclinic":
        cell = TRICLINIC
        model = PairRates(cell=cell, law=law, cutoff=F32(3.0), buffer=F32(1.0))
    elif name == "histograms":
        model = PairRates(cell=cell, law=law, cutoff=F32(3.0), buffer=F32(1.0))
        init_kw = dict(hist_bins=8, track_jump_matrix=True)
        run_kw = dict(hist_range=(1.0, 4.0))
    elif name == "stale":
        model = PairRates(cell=cell, law=law, cutoff=F32(3.0), buffer=F32(1.0))
        run_kw = dict(stale_rates=True)
    else:
        raise ValueError(name)
    return model, cell, frames, extras, init_kw, run_kw


SCENARIOS = ["dense", "topk", "hydronium", "angle", "triclinic", "histograms",
             "stale"]


def assert_same_state(a, b, exact_floats=True):
    for x, y in zip(jax.tree.leaves(jax.device_get(a)),
                    jax.tree.leaves(jax.device_get(b))):
        x, y = np.asarray(x), np.asarray(y)
        if exact_floats or not np.issubdtype(x.dtype, np.floating):
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", SCENARIOS)
def test_chunk_invariance(name):
    """Event-ordinal RNG keying: one 24-frame block and blocks of 5/11/8
    frames give the bit-identical final state."""
    model, cell, frames, extras, init_kw, run_kw = scenario(name)
    ens, keys = init(8, 16, 6, frames[0], seed=4, **init_kw)
    whole = run(model, cell, ens, keys, frames, extras, max_events=6, **run_kw)
    split = run(model, cell, ens, keys, frames, extras, chunks=(5, 16),
                max_events=6, **run_kw)
    assert events_of(whole).sum() > 0
    assert_same_state(whole, split)


@pytest.mark.parametrize("name", SCENARIOS)
def test_sharded_matches_single_device(name):
    """The replica axis sharded over 8 devices (GSPMD partitioning of the
    scan engine) reproduces the single-device run: every integer outcome
    exactly, the float state to f32 rounding (XLA may fuse the reductions of
    the partitioned program differently; the residence-time model's event
    times show it)."""
    from cmdlmc_tpu.parallel.mesh import replica_mesh, shard_ensemble, shard_replicas

    model, cell, frames, extras, init_kw, run_kw = scenario(name)
    ens, keys = init(16, 16, 6, frames[0], seed=6, **init_kw)
    single = run(model, cell, ens, keys, frames, extras, max_events=6, **run_kw)
    mesh = replica_mesh(jax.devices()[:8])
    sharded = run(model, cell, shard_ensemble(ens, mesh),
                  shard_replicas(keys, mesh), frames, extras, max_events=6,
                  **run_kw)
    assert not sharded.replicas.occ.sharding.is_fully_replicated
    assert_same_state(single, sharded, exact_floats=False)


# ---------------------------------------------------------------------------
# stale in-frame rates (reference semantics, MDMC.py:121-171)
# ---------------------------------------------------------------------------


def stale_pair(a, max_events, F=400, R=64):
    """Constant law over all pairs: the total rate a P (N - P) does not
    depend on the configuration, so both semantics run the same clock."""
    n_sites, n_protons = 10, 4
    pos = np.random.RandomState(3).uniform(0, 27.0, (n_sites, 3)).astype(np.float32)
    cell = Cell.cubic([30.0] * 3)
    model = constant_model("dense", cell, n_sites, a)
    ens, keys = init(R, n_sites, n_protons, pos, seed=5)
    block = np.broadcast_to(pos, (F, n_sites, 3))
    fresh = run(model, cell, ens, keys, block, max_events=max_events)
    stale = run(model, cell, ens, keys, block, max_events=max_events,
                stale_rates=True)
    return fresh, stale, a * n_protons * (n_sites - n_protons) * DT * F, R


def test_stale_rates_identical_without_multi_event_frames():
    """At rate*dt << 1 no frame fires twice, and then the stale and the fresh
    semantics fire the same events (same draws, same rows)."""
    fresh, stale, expected, R = stale_pair(0.002, 4)
    np.testing.assert_array_equal(np.asarray(fresh.replicas.occ),
                                  np.asarray(stale.replicas.occ))
    np.testing.assert_array_equal(events_of(fresh), events_of(stale))
    z = (events_of(stale).mean() - expected) / np.sqrt(expected / R)
    assert abs(z) < 5, z


def test_stale_rates_distributional_at_high_rate():
    """With frequent multi-event frames the two semantics diverge event by
    event but agree in distribution, and the occupancy invariants hold."""
    fresh, stale, _, R = stale_pair(0.2, 8)
    check_invariants(stale.replicas, 4)
    np.testing.assert_array_equal(events_of(fresh), events_of(stale))
    # the mode genuinely changes which protons move ...
    assert not np.array_equal(np.asarray(fresh.replicas.occ),
                              np.asarray(stale.replicas.occ))
    # ... but not the statistics of where they go
    msd = [np.asarray(eng.proton_displacement(e.replicas, e.site_disp) ** 2
                      ).sum(axis=(1, 2)) for e in (fresh, stale)]
    se = np.sqrt(sum(m.var(ddof=1) / R for m in msd))
    assert abs(msd[0].mean() - msd[1].mean()) < 5 * se, (msd[0].mean(),
                                                        msd[1].mean())


@pytest.mark.parametrize("kind", ["topk", "hydronium"])
def test_stale_rates_rejected_for_per_replica_models(kind):
    cell = Cell.cubic([10.0] * 3)
    frames = drift(random_sites(8, 10.0), 4)
    model = (constant_model("topk", cell, 8, 0.1) if kind == "topk"
             else hydronium_model(cell, None))
    ens, keys = init(4, 8, 3, frames[0])
    with pytest.raises(ValueError, match="stale_rates"):
        run(model, cell, ens, keys, frames, stale_rates=True)


def test_stale_rates_moves_nothing_when_rows_run_out():
    """One movable proton, one allowed move, a frame-start total that
    outlives it: later draws in the frame must not move any proton."""
    pos = np.array([[0.0, 0, 0], [2.0, 0, 0], [9.0, 9, 9]], np.float32)
    cell = Cell.cubic([30.0] * 3)
    model = PairRates(cell=cell, law=Constant(a=F32(5.0)), cutoff=F32(2.5),
                      buffer=F32(0.0))
    ens, keys = init(32, 3, 2, pos, seed=9)
    # put the protons on sites 0 and 2 in every replica: only 0 -> 1 moves
    occ = jnp.tile(jnp.array([1.0, 0.0, 1.0]), (32, 1))
    rep = dataclasses.replace(
        ens.replicas, occ=occ,
        proton_of_site=jnp.tile(jnp.array([1, 0, 2], jnp.int32), (32, 1)),
        site_of_proton=jnp.tile(jnp.array([0, 2], jnp.int32), (32, 1)),
        autocorr_ref=jnp.tile(jnp.array([0, 2], jnp.int32), (32, 1)))
    ens = dataclasses.replace(ens, replicas=rep)
    out = run(model, cell, ens, keys, np.broadcast_to(pos, (1, 3, 3)),
              max_events=8, stale_rates=True)
    check_invariants(out.replicas, 2)
    # site 2 is isolated: its proton never moves
    np.testing.assert_array_equal(np.asarray(out.replicas.site_of_proton)[:, 1], 2)
    assert int(np.asarray(out.replicas.jumps).max()) <= 1
