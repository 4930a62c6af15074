"""Water model on its scan path: the ring walk's event rate and MSD, block
chunking and replica sharding invariance, the ``check_from_old`` and
interpolated-transform schema keys, and the ``kmc_water`` CLI."""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cmdlmc_tpu.core.cell import Cell
from cmdlmc_tpu.models import water as wm
from cmdlmc_tpu.rates.laws import Constant, Fermi
from cmdlmc_tpu.topo.transforms import InterpolatedTransformation, ReLUTransformation

F32 = jnp.float32


def model_of(**kw):
    defaults = dict(cell=Cell.cubic([30.0, 30.0, 30.0]),
                    law=Constant(a=F32(0.03)), transform=None, d_oh=F32(0.0),
                    n_atoms=3)
    defaults.update(kw)
    return wm.WaterModel(**defaults)


def ring(n=12, spacing=2.5):
    ang = 2 * np.pi * np.arange(n) / n
    r = n * spacing / (2 * np.pi)
    return np.stack([15 + r * np.cos(ang), 15 + r * np.sin(ang),
                     np.full(n, 15.0)], axis=1).astype(np.float32)


def drifting(pos, n_frames, seed=5):
    rng = np.random.RandomState(seed)
    return (pos[None] + rng.normal(scale=0.03, size=(n_frames, *pos.shape))
            ).astype(np.float32)


def init(model, pos, n_replicas, seed=0):
    key = jax.random.key(seed)
    states = wm.init_water_states(jax.random.fold_in(key, 0), n_replicas,
                                  pos.shape[0], jnp.asarray(pos))
    keys = jax.random.split(jax.random.fold_in(key, 1), n_replicas)
    return states, keys


def run(model, states, keys, frames, chunks=(), dt=0.5):
    bounds = [0, *chunks, frames.shape[0]]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        idx = jnp.arange(lo, hi, dtype=jnp.int32)
        states, _, _ = wm.run_water_block(model, states, keys,
                                          jnp.asarray(frames[lo:hi]), idx, dt=dt)
    return states


def test_ring_event_rate_and_msd():
    """Constant law over the 3 candidates of every site: 3a events per fs;
    hops stay in the ring's plane."""
    pos = ring()
    model = model_of()
    R, F, dt, a = 64, 800, 0.5, 0.03
    states, keys = init(model, pos, R)
    out = run(model, states, keys, np.broadcast_to(pos, (F, *pos.shape)))
    counts = np.asarray(out.clock.event_count, float)
    expected = 3 * a * dt * F
    z = (counts.mean() - expected) / np.sqrt(expected / R)
    assert abs(z) < 5, (counts.mean(), expected, z)
    disp = np.asarray(out.displacement)
    assert np.all(np.isfinite(disp))
    np.testing.assert_allclose(disp[:, 2], 0.0, atol=1e-4)
    assert (disp**2).sum(axis=1).mean() > 0


def scenario(name):
    law = Fermi(a=F32(0.2), b=F32(2.6), c=F32(0.2))
    ramp = ReLUTransformation(a=F32(0.5), b=F32(2.2), d0=F32(2.4),
                              left_bound=F32(2.0), right_bound=F32(3.0))
    if name == "plain":
        return model_of(law=law)
    if name == "relaxation":
        return model_of(law=law, transform=ramp, relaxation_time=10,
                        d_oh=F32(0.1))
    if name == "check_from_old":
        return model_of(law=law, transform=ramp, relaxation_time=10,
                        keep_last_neighbor_rescaled=True, check_from_old=True)
    if name == "waiting":
        return model_of(law=law, waiting_time=5)
    raise ValueError(name)


WATER_SCENARIOS = ["plain", "relaxation", "check_from_old", "waiting"]


def leaves(states):
    return [np.asarray(x) for x in jax.tree.leaves(jax.device_get(states))]


@pytest.mark.parametrize("name", WATER_SCENARIOS)
def test_chunk_invariance(name):
    model = scenario(name)
    frames = drifting(ring(), 40)
    states, keys = init(model, frames[0], 8, seed=3)
    whole = run(model, states, keys, frames)
    split = run(model, states, keys, frames, chunks=(7, 23))
    assert np.asarray(whole.jumps).sum() > 0
    for a, b in zip(leaves(whole), leaves(split)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", WATER_SCENARIOS)
def test_sharded_matches_single_device(name):
    """Water replicas sharded over 8 devices: integer state exact, floats to
    f32 rounding."""
    from cmdlmc_tpu.parallel.mesh import replica_mesh, shard_replicas

    model = scenario(name)
    frames = drifting(ring(), 30)
    states, keys = init(model, frames[0], 16, seed=4)
    single = run(model, states, keys, frames)
    mesh = replica_mesh(jax.devices()[:8])
    sharded = run(model, shard_replicas(states, mesh),
                  shard_replicas(keys, mesh), frames)
    assert not sharded.site.sharding.is_fully_replicated
    for a, b in zip(leaves(single), leaves(sharded)):
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)


def test_check_from_old_changes_dynamics():
    """check_from_old swaps in the old oxygen when the link exists only
    old -> new. Random sites make such one-way k-nearest links common, so
    the outcome differs from keep_last_neighbor_rescaled alone."""
    sites = np.random.RandomState(8).uniform(10, 18, (16, 3)).astype(np.float32)
    frames = drifting(sites, 300)
    cfo = scenario("check_from_old")
    keep = model_of(law=cfo.law, transform=cfo.transform, relaxation_time=10,
                    keep_last_neighbor_rescaled=True)
    states, keys = init(cfo, frames[0], 32, seed=6)
    a = run(keep, states, keys, frames)
    b = run(cfo, states, keys, frames)
    assert np.asarray(b.jumps).sum() > 0
    assert not (np.array_equal(np.asarray(a.site), np.asarray(b.site))
                and np.array_equal(np.asarray(a.jumps), np.asarray(b.jumps)))


def test_interpolated_transform_rescales_rates():
    """A conversion table that shortens every distance raises the rate over
    the untransformed model (the ``conversion_data`` schema key)."""
    x = jnp.linspace(2.0, 4.0, 9, dtype=jnp.float32)
    table = InterpolatedTransformation(x=x, y=x - 0.4)
    law = Fermi(a=F32(0.2), b=F32(2.4), c=F32(0.1))
    frames = drifting(ring(12, 2.8), 200)
    plain = model_of(law=law)
    interp = model_of(law=law, transform=table)
    states, keys = init(plain, frames[0], 32, seed=7)
    ev_plain = np.asarray(run(plain, states, keys, frames).clock.event_count)
    ev_interp = np.asarray(run(interp, states, keys, frames).clock.event_count)
    assert ev_interp.mean() > 2 * max(ev_plain.mean(), 1.0)


def test_kmc_water_cli_runs_relaxation_and_check_from_old(tmp_path):
    """The smoke-test water deployment at a tiny size, through the CLI."""
    from cmdlmc_tpu.cli import kmc_water
    from cmdlmc_tpu.io import synthetic

    names, frames = synthetic.water_frames(60, 1, n_side=3)
    traj = str(tmp_path / "w.xyz")
    synthetic.write_xyz(traj, names, frames)
    cfg = tmp_path / "w.cfg"
    cfg.write_text(f"""filename {traj}
pbc 9.3 9.3 9.3
md_timestep_fs 0.5
sweeps 60
print_frequency 10
jumprate_params_fs a=0.06 b=2.5 c=0.2
rescale_function ramp
rescale_parameters a=0.5 b=2.2 d0=2.4 left_bound=2.0 right_bound=3.0
relaxation_time 10
n_atoms 3
keep_last_neighbor_rescaled True
check_from_old True
chunk_size 25
seed 4
replicas 8
""")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        kmc_water.main(["load", str(cfg), "--platform", "cpu"])
    rows = [line.split() for line in out.getvalue().splitlines()
            if line.strip() and not line.startswith("#")]
    assert [int(r[0]) for r in rows] == list(range(0, 60, 10))
    assert all(np.isfinite([float(x) for x in r]).all() for r in rows)
