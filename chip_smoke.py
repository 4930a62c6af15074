#!/usr/bin/env python3
"""End-to-end smoke test of cmdlmc_tpu on an NVIDIA GPU.

    python chip_smoke.py            # one GPU: phases 1-5
    python chip_smoke.py --gpus 4   # four GPUs: the sharded flagship only

Everything runs in this one process, through the entry points a user calls
(``cmdlmc_tpu.cli.mdmc.main`` and ``cmdlmc_tpu.cli.kmc_water.main``), on
trajectories generated from ``--seed`` into ``chip_smoke_work/`` (git-ignored).

Phases (one line each: seconds, site-updates/s, device kind):
  1. the device: JAX must find a GPU, else exit 1; nvidia-smi name/power limit
  2. flagship: mdmc at the reference integration scale, CsH2PO4 cell, 144 O
     donors, 96 protons, 16384 replicas, 2000 frames, checkpoint at the end
  3. supercell: the same cell x (2,2,2), N=1152, 768 protons, 4096 replicas,
     500 frames (dense); k-nearest timings at N=1152 and N=4608
  4. water: kmc_water on 216 oxygens in an 18.6 A box, 8192 replicas,
     relaxation and check_from_old on
  5. numerics: the gpu-marked tests (float64 and CPU references)

The last line of stdout is ``{"ok": true, "device": {...}}``; any failed
phase raises before it is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "chip_smoke_work")

FLAGSHIP = dict(replicas=16384, frames=2000, print_frequency=100,
                reset_frequency=1000, block_size=500, max_events=6)
SUPERCELL = dict(replicas=4096, frames=500, print_frequency=100,
                 reset_frequency=0, block_size=250, max_events=16)
WATER = dict(replicas=8192, frames=2000, print_frequency=100)


def flagship_ini(traj, *, replicas, frames, print_frequency, reset_frequency,
                 block_size, max_events, mult="1,1,1", devices="1",
                 checkpoint=None, protons=96, n_sites=144):
    from cmdlmc_tpu.io.synthetic import CSH2PO4_CELL

    ck = f"checkpoint_path = {checkpoint}" if checkpoint else ""
    return f"""
[Trajectory]
type = XYZTrajectory
filename = {traj}
time_step = 0.4

[AtomBox]
type = AtomBoxCubic
periodic_boundaries = {", ".join(map(str, CSH2PO4_CELL))}
box_multiplier = {mult}

[NeighborTopology]
type = NeighborTopology
donor_atoms = O
cutoff = 3.0
buffer = 2.0

[JumpRate]
type = Fermi
a = 0.06
b = 2.3
c = 0.1

[KMCLattice]
lattice_size = {n_sites}
proton_number = {protons}
time_step = 0.4

[Output]
type = ObservablesOutput
print_frequency = {print_frequency}
reset_frequency = {reset_frequency}

[Engine]
replicas = {replicas}
seed = 1
max_events_per_frame = {max_events}
block_size = {block_size}
sweeps = {frames}
devices = {devices}
{ck}
"""


def water_cfg(traj, *, replicas, frames, print_frequency):
    return f"""filename {traj}
pbc 18.6 18.6 18.6
md_timestep_fs 0.5
sweeps {frames}
print_frequency {print_frequency}
jumprate_params_fs a=0.06 b=2.5 c=0.2
rescale_function ramp
rescale_parameters a=0.5 b=2.2 d0=2.4 left_bound=2.0 right_bound=3.0
relaxation_time 10
waiting_time 0
n_atoms 3
keep_last_neighbor_rescaled True
check_from_old True
chunk_size 500
seed 4
replicas {replicas}
"""


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return path


def run_mdmc(cfg_path):
    """(stdout text, Simulation, seconds) of one in-process mdmc run."""
    from cmdlmc_tpu.cli import mdmc

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        sim = mdmc.main([cfg_path])
    return buf.getvalue(), sim, time.perf_counter() - t0


def data_rows(text):
    return np.array([[float(x) for x in line.split()]
                     for line in text.splitlines()
                     if line.strip() and not line.startswith("#")])


def check_mdmc_output(text, *, frames, print_frequency, reset_frequency,
                      protons):
    """Every row finite, one per print frame, Autocorr back to the proton
    count and MSD back to zero at each reset, jumps positive, a perf line
    that names the GPU. Returns the rows."""
    rows = data_rows(text)
    want = np.arange(0, frames, print_frequency)
    assert rows.shape == (len(want), 7), rows.shape
    assert np.all(np.isfinite(rows)), "non-finite observable"
    np.testing.assert_array_equal(rows[:, 0], want)
    if reset_frequency:
        at_reset = rows[(rows[:, 0] > 0) & (rows[:, 0] % reset_frequency == 0)]
        assert len(at_reset), "no row at a reset frame"
        np.testing.assert_array_equal(at_reset[:, 5], protons)
        np.testing.assert_array_equal(at_reset[:, 2:5], 0.0)
    assert rows[:, 6].max() > 0, "no jumps"
    import jax

    platform = jax.devices()[0].platform  # main() has checked it is a GPU
    perf = [line for line in text.splitlines() if line.startswith("# perf:")]
    assert perf and f"platform={platform}" in perf[-1], perf
    return rows


def phase_line(name, seconds, site_updates, kind, extra=""):
    print(f"phase {name}: {seconds:.2f} s, {site_updates / seconds:.4e} "
          f"site-updates/s, device_kind={kind}{extra}", flush=True)


def perf_of(text):
    return next(line for line in text.splitlines()
                if line.startswith("# perf:"))


def phase_flagship(kind, seed):
    import jax

    from cmdlmc_tpu.engine import lattice as eng
    from cmdlmc_tpu.io import synthetic

    names, frames = synthetic.solid_acid_frames(FLAGSHIP["frames"], seed)
    traj = os.path.join(WORK, "flagship.xyz")
    synthetic.write_xyz(traj, names, frames)

    # compile cost of one flagship block, cold and then from the persistent
    # cache (clear_caches drops the in-memory executables only)
    args, kwargs = _flagship_block_args(frames)
    t0 = time.perf_counter()
    eng.run_block.lower(*args, **kwargs).compile()
    cold = time.perf_counter() - t0
    jax.clear_caches()
    t0 = time.perf_counter()
    eng.run_block.lower(*args, **kwargs).compile()
    warm = time.perf_counter() - t0
    print(f"compile flagship block: cold {cold:.2f} s, warm {warm:.2f} s "
          f"(persistent cache {jax.config.jax_compilation_cache_dir})")

    ckpt = os.path.join(WORK, "flagship.ckpt.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    cfg = _write(os.path.join(WORK, "flagship.ini"),
                 flagship_ini(traj, checkpoint=ckpt, **FLAGSHIP))
    text, sim, secs = run_mdmc(cfg)
    check_mdmc_output(text, frames=FLAGSHIP["frames"], protons=96,
                      print_frequency=FLAGSHIP["print_frequency"],
                      reset_frequency=FLAGSHIP["reset_frequency"])
    assert os.path.exists(ckpt), "no checkpoint written"
    print(perf_of(text))
    phase_line("flagship", secs, 144 * FLAGSHIP["replicas"] * FLAGSHIP["frames"],
               kind, f" (N=144, P=96, R={FLAGSHIP['replicas']}, "
               f"{FLAGSHIP['frames']} frames)")
    return frames


def _flagship_block_args(frames):
    """run_block arguments of one flagship block, as mdmc builds them."""
    import jax
    import jax.numpy as jnp

    from cmdlmc_tpu.core.cell import Cell
    from cmdlmc_tpu.engine import lattice as eng
    from cmdlmc_tpu.io.synthetic import CSH2PO4_CELL
    from cmdlmc_tpu.rates.laws import Fermi
    from cmdlmc_tpu.topo.models import Frame, PairRates

    cell = Cell.cubic(CSH2PO4_CELL)
    model = PairRates(cell=cell, law=Fermi(a=jnp.float32(0.06),
                                           b=jnp.float32(2.3),
                                           c=jnp.float32(0.1)),
                      cutoff=jnp.float32(3.0), buffer=jnp.float32(2.0))
    donors = jnp.asarray(frames[: FLAGSHIP["block_size"], 36:])
    key = jax.random.key(1)
    ens = eng.init_replicas(jax.random.fold_in(key, 0), FLAGSHIP["replicas"],
                            144, 96, donors[0])
    keys = jax.random.split(jax.random.fold_in(key, 1), FLAGSHIP["replicas"])
    idx = jnp.arange(FLAGSHIP["block_size"], dtype=jnp.int32)
    blk = Frame(donors=donors, extras=None,
                time=idx.astype(jnp.float32) * jnp.float32(0.4), index=idx)
    kwargs = dict(dt=0.4, max_events=FLAGSHIP["max_events"],
                  reset_frequency=FLAGSHIP["reset_frequency"],
                  hist_range=(2.0, 3.0),
                  emit_every=FLAGSHIP["print_frequency"], equilibration=0,
                  variance_mode="replicas", stale_rates=False)
    return (model, cell, ens, keys, blk), kwargs


def phase_supercell(kind, frames):
    from cmdlmc_tpu.io import synthetic

    n_frames = SUPERCELL["frames"]
    traj = os.path.join(WORK, "supercell.xyz")
    synthetic.write_xyz(traj, ["P"] * 36 + ["O"] * 144, frames[:n_frames])
    cfg = _write(os.path.join(WORK, "supercell.ini"),
                 flagship_ini(traj, mult="2,2,2", protons=768, n_sites=1152,
                              **SUPERCELL))
    text, sim, secs = run_mdmc(cfg)
    check_mdmc_output(text, frames=n_frames, protons=768,
                      print_frequency=SUPERCELL["print_frequency"],
                      reset_frequency=0)
    assert sim.final_states.replicas.occ.shape == (SUPERCELL["replicas"], 1152)
    print(perf_of(text))
    phase_line("supercell", secs, 1152 * SUPERCELL["replicas"] * n_frames,
               kind, f" (N=1152, P=768, R={SUPERCELL['replicas']}, "
               f"{n_frames} frames, dense)")
    time_k_nearest(frames[0, 36:])


def time_k_nearest(donors, k=8, reps=20):
    """Median wall time of the k-nearest extraction on the masked distance
    matrix of the supercell (N=1152) and of a 4x4x2 one (N=4608), against
    lax.top_k, and of the whole top-K stage 1 (TopKPairRates.shared)."""
    import jax
    import jax.numpy as jnp

    from cmdlmc_tpu.core.cell import Cell, extended_positions, pairwise_distances
    from cmdlmc_tpu.io.synthetic import CSH2PO4_CELL
    from cmdlmc_tpu.rates.laws import Fermi
    from cmdlmc_tpu.topo.models import Frame, TopKPairRates, k_smallest

    def median_ms(fn, x):
        jax.block_until_ready(fn(x))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(x))
            ts.append(time.perf_counter() - t0)
        return 1e3 * float(np.median(ts))

    def top_k(d):
        neg, idx = jax.lax.top_k(-d, k)
        return -neg, idx

    for mult in ((2, 2, 2), (4, 4, 2)):
        cell = Cell.cubic(CSH2PO4_CELL, mult)
        pos = extended_positions(np.diag(CSH2PO4_CELL), jnp.asarray(donors),
                                 mult)
        n = pos.shape[0]
        d = pairwise_distances(cell, pos, pos)
        d = jnp.where(jnp.eye(n, dtype=bool) | (d > 5.0), jnp.inf, d)
        t_ks = median_ms(jax.jit(lambda x: k_smallest(x, k)), d)
        t_tk = median_ms(jax.jit(top_k), d)
        (da, ia), (db, ib) = jax.device_get(
            (jax.jit(lambda x: k_smallest(x, k))(d), jax.jit(top_k)(d)))
        np.testing.assert_array_equal(da, db)
        real = np.isfinite(da)  # padding slots (no k-th neighbor) may differ
        np.testing.assert_array_equal(ia[real], ib[real])
        model = TopKPairRates(
            cell=cell, law=Fermi(a=jnp.float32(0.06), b=jnp.float32(2.3),
                                 c=jnp.float32(0.1)),
            cutoff=jnp.float32(3.0), buffer=jnp.float32(2.0), k=k)
        frame = Frame(donors=pos, extras=None, time=jnp.float32(0.0),
                      index=jnp.int32(0))
        t_stage1 = median_ms(jax.jit(model.shared), frame)
        print(f"k-nearest N={n} k={k}: k_smallest {t_ks:.3f} ms, "
              f"lax.top_k {t_tk:.3f} ms, TopKPairRates.shared "
              f"{t_stage1:.3f} ms (median of {reps})", flush=True)


def phase_water(kind, seed):
    from cmdlmc_tpu.cli import kmc_water
    from cmdlmc_tpu.io import synthetic

    names, frames = synthetic.water_frames(WATER["frames"], seed)
    traj = os.path.join(WORK, "water.xyz")
    synthetic.write_xyz(traj, names, frames)
    cfg = _write(os.path.join(WORK, "water.cfg"), water_cfg(traj, **WATER))
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        kmc_water.main(["load", cfg])
    secs = time.perf_counter() - t0
    rows = data_rows(buf.getvalue())
    want = np.arange(0, WATER["frames"], WATER["print_frequency"])
    assert rows.shape[0] == len(want), rows.shape
    np.testing.assert_array_equal(rows[:, 0], want)
    assert np.all(np.isfinite(rows)), "non-finite water output"
    assert rows[-1, 6] > 0, "no water jumps"
    phase_line("water", secs, 216 * WATER["replicas"] * WATER["frames"], kind,
               f" (216 O, R={WATER['replicas']}, {WATER['frames']} frames, "
               f"last row jumps={int(rows[-1, 6])})")


def phase_numerics(kind):
    import pytest

    t0 = time.perf_counter()
    # --noconftest: the suite's conftest pins the CPU platform
    rc = pytest.main(["-q", "-s", "-m", "gpu", "--noconftest",
                      "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_numerics.py")])
    assert rc == 0, f"gpu-marked numerics tests failed (pytest exit {rc})"
    print(f"phase numerics: {time.perf_counter() - t0:.2f} s, "
          f"device_kind={kind} (gpu-marked tests passed; their runs are "
          f"checks, not timed)", flush=True)


def phase_four_gpus(kind, seed):
    """The flagship with devices = 4 and with devices = 1, same total
    replica count: sharding, per-card state, and outputs compared."""
    import jax

    from cmdlmc_tpu.io import synthetic

    assert len(jax.devices()) >= 4, f"need 4 GPUs, have {len(jax.devices())}"
    names, frames = synthetic.solid_acid_frames(FLAGSHIP["frames"], seed)
    traj = os.path.join(WORK, "flagship.xyz")
    synthetic.write_xyz(traj, names, frames)
    runs = {}
    for devices in ("4", "1"):
        cfg = _write(os.path.join(WORK, f"flagship_{devices}gpu.ini"),
                     flagship_ini(traj, devices=devices, **FLAGSHIP))
        text, sim, secs = run_mdmc(cfg)
        rows = check_mdmc_output(
            text, frames=FLAGSHIP["frames"], protons=96,
            print_frequency=FLAGSHIP["print_frequency"],
            reset_frequency=FLAGSHIP["reset_frequency"])
        rep = sim.final_states.replicas
        if devices == "4":
            used = rep.occ.sharding.device_set
            assert len(used) == 4, used
            state_bytes = {}
            for leaf in jax.tree.leaves(rep):
                for shard in leaf.addressable_shards:
                    state_bytes[shard.device.id] = (
                        state_bytes.get(shard.device.id, 0) + shard.data.nbytes)
            total = sum(leaf.nbytes for leaf in jax.tree.leaves(rep))
            in_use = {d.id: (d.memory_stats() or {}).get("bytes_in_use")
                      for d in jax.devices()[:4]}
            print(f"4-GPU state: {total} bytes in all; per device "
                  f"{state_bytes}; bytes_in_use {in_use}")
            for b in state_bytes.values():
                assert abs(b - total / 4) <= 0.05 * total / 4, state_bytes
        print(perf_of(text))
        phase_line(f"flagship devices={devices}", secs,
                   144 * FLAGSHIP["replicas"] * FLAGSHIP["frames"], kind)
        runs[devices] = (rows, jax.device_get(rep), sim.final_states)
    compare_runs(runs["4"], runs["1"])


def compare_runs(a, b):
    """Per-replica integer outcomes identical where the arithmetic is; the
    ensemble means within |z| < 4 otherwise."""
    from cmdlmc_tpu.engine import lattice as eng

    (rows_a, rep_a, ens_a), (rows_b, rep_b, ens_b) = a, b
    same = ((np.asarray(rep_a.jumps) == np.asarray(rep_b.jumps))
            & (np.asarray(rep_a.clock.event_count)
               == np.asarray(rep_b.clock.event_count))
            & np.all(np.asarray(rep_a.site_of_proton)
                     == np.asarray(rep_b.site_of_proton), axis=1))
    print(f"rows identical: {np.array_equal(rows_a, rows_b)}; replicas with "
          f"bit-identical integer outcomes: {same.mean():.6f}")
    for name, xa, xb in (
        ("events", np.asarray(rep_a.clock.event_count, float),
         np.asarray(rep_b.clock.event_count, float)),
        ("msd", np.asarray(eng.observables_of(
            ens_a.replicas, ens_a.site_disp)[0]).sum(axis=1),
         np.asarray(eng.observables_of(
             ens_b.replicas, ens_b.site_disp)[0]).sum(axis=1)),
    ):
        se = np.sqrt(xa.var(ddof=1) / len(xa) + xb.var(ddof=1) / len(xb))
        z = (xa.mean() - xb.mean()) / se if se > 0 else 0.0
        print(f"  {name}: mean {xa.mean():.6f} vs {xb.mean():.6f}, z={z:.3f}")
        assert abs(z) < 4, (name, z)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the synthetic trajectories")
    parser.add_argument("--gpus", type=int, choices=(1, 4), default=1,
                        help="4: run only the sharded flagship on four GPUs")
    args = parser.parse_args(argv)

    import jax

    import cmdlmc_tpu  # noqa: F401  (fails here when run outside the repo)

    t0 = time.perf_counter()
    devices = jax.devices()
    start_up = time.perf_counter() - t0
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py: no GPU (JAX platform {devices[0].platform})",
              file=sys.stderr)
        return 1
    kind = devices[0].device_kind
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip())
    print(f"phase device: {start_up:.2f} s (backend start-up), "
          f"platform={devices[0].platform} device_kind={kind} "
          f"count={len(devices)} jax {jax.__version__}", flush=True)
    os.makedirs(WORK, exist_ok=True)

    if args.gpus == 4:
        phase_four_gpus(kind, args.seed)
    else:
        frames = phase_flagship(kind, args.seed)
        phase_supercell(kind, frames)
        phase_water(kind, args.seed)
        phase_numerics(kind)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
