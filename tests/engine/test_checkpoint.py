"""Checkpoint/resume: a restored run must continue bit-exactly (the engine's
event-ordinal RNG keying makes resumption identical to an uninterrupted run)."""

import jax
import jax.numpy as jnp
import numpy as np

from cmdlmc_tpu.core.cell import Cell
from cmdlmc_tpu.engine import lattice as eng
from cmdlmc_tpu.models import water as wm
from cmdlmc_tpu.rates.laws import Constant, Fermi
from cmdlmc_tpu.topo.models import Frame, PairRates
from cmdlmc_tpu.utils.checkpoint import (
    CheckpointWriter, load_checkpoint, save_checkpoint,
)


def build():
    rng = np.random.RandomState(2)
    positions = rng.uniform(0, 5, size=(10, 3)).astype(np.float32)
    cell = Cell.cubic([15.0, 15.0, 15.0])
    model = PairRates(
        cell=cell,
        law=Fermi(a=jnp.float32(0.05), b=jnp.float32(3.0), c=jnp.float32(0.4)),
        cutoff=jnp.float32(8.0), buffer=jnp.float32(2.0),
    )
    key = jax.random.key(4)
    states = eng.init_replicas(
        jax.random.fold_in(key, 0), 6, 10, 4, jnp.asarray(positions),
        hist_bins=4,
    )
    keys = jax.random.split(jax.random.fold_in(key, 1), 6)
    return cell, model, positions, states, keys


def frames(positions, start, n, dt=0.5):
    pos = jnp.broadcast_to(jnp.asarray(positions), (n, *positions.shape))
    idx = jnp.arange(start, start + n, dtype=jnp.int32)
    return Frame(donors=pos, extras=None, time=idx.astype(jnp.float32) * dt, index=idx)


def test_lattice_checkpoint_roundtrip(tmp_path):
    cell, model, positions, states, keys = build()

    # continuous run: 120 frames
    s_full, _ = eng.run_block(model, cell, states, keys, frames(positions, 0, 120), dt=0.5)

    # interrupted run: 60 frames, checkpoint, restore, 60 more
    s_half, _ = eng.run_block(model, cell, states, keys, frames(positions, 0, 60), dt=0.5)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, s_half, keys, 60, meta={"seed": 4})
    s_rest, keys_rest, next_frame, meta = load_checkpoint(path)
    assert next_frame == 60
    assert int(meta["seed"]) == 4
    s_resumed, _ = eng.run_block(
        model, cell, s_rest, keys_rest, frames(positions, 60, 60), dt=0.5
    )

    np.testing.assert_array_equal(
        np.asarray(s_full.replicas.clock.event_count),
        np.asarray(s_resumed.replicas.clock.event_count),
    )
    np.testing.assert_array_equal(
        np.asarray(s_full.replicas.site_of_proton),
        np.asarray(s_resumed.replicas.site_of_proton),
    )
    np.testing.assert_allclose(
        np.asarray(eng.proton_displacement(s_full.replicas, s_full.site_disp)),
        np.asarray(eng.proton_displacement(s_resumed.replicas, s_resumed.site_disp)),
        atol=1e-6,
    )
    np.testing.assert_array_equal(
        np.asarray(s_full.replicas.jump_hist), np.asarray(s_resumed.replicas.jump_hist)
    )


def test_checkpoint_writer_async(tmp_path):
    """The background writer must produce the same loadable file as the
    synchronous path, overwrite atomically across saves, and leave no
    staging files behind."""
    import os

    cell, model, positions, states, keys = build()
    s_half, _ = eng.run_block(model, cell, states, keys, frames(positions, 0, 30), dt=0.5)
    path = str(tmp_path / "w.ckpt")  # extension-less: exact-path contract
    w = CheckpointWriter(path)
    w.save(states, keys, 0, meta={"seed": 4})
    w.save(s_half, keys, 30, meta={"seed": 4})  # joins the first write
    w.close()
    assert os.listdir(tmp_path) == ["w.ckpt"]  # no .tmp leftovers
    s_rest, keys_rest, next_frame, meta = load_checkpoint(path)
    assert next_frame == 30  # the LAST save wins
    assert int(meta["seed"]) == 4
    np.testing.assert_array_equal(
        np.asarray(s_half.replicas.site_of_proton),
        np.asarray(s_rest.replicas.site_of_proton),
    )

    # a failing background write surfaces on the next interaction
    bad = CheckpointWriter(str(tmp_path / "no_such_dir" / "x.ckpt"))
    bad.save(states, keys, 0)
    try:
        bad.close()
    except OSError:
        pass
    else:
        raise AssertionError("background write error was swallowed")


def test_water_checkpoint_roundtrip(tmp_path):
    cell = Cell.cubic([25.0, 25.0, 25.0])
    positions = jnp.asarray(
        np.array([[2.5 * i, 0, 0] for i in range(10)], dtype=np.float32)
    )
    model = wm.WaterModel(
        cell=cell, law=Constant(a=jnp.float32(0.05)), transform=None,
        d_oh=jnp.float32(0.0), n_atoms=3,
    )
    key = jax.random.key(0)
    states = wm.init_water_states(jax.random.fold_in(key, 0), 4, 10, positions)
    keys = jax.random.split(jax.random.fold_in(key, 1), 4)

    def block(start, n):
        pos = jnp.broadcast_to(positions, (n, 10, 3))
        return pos, jnp.arange(start, start + n, dtype=jnp.int32)

    s_full, _, _ = wm.run_water_block(model, states, keys, *block(0, 100), dt=0.5)

    s_half, _, _ = wm.run_water_block(model, states, keys, *block(0, 50), dt=0.5)
    path = str(tmp_path / "w.npz")
    save_checkpoint(path, s_half, keys, 50)
    s_rest, keys_rest, _, _ = load_checkpoint(path)
    s_resumed, _, _ = wm.run_water_block(model, s_rest, keys_rest, *block(50, 50), dt=0.5)

    np.testing.assert_array_equal(np.asarray(s_full.site), np.asarray(s_resumed.site))
    np.testing.assert_array_equal(
        np.asarray(s_full.clock.event_count), np.asarray(s_resumed.clock.event_count)
    )
