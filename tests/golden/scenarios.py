"""Golden-data scenarios: the five BASELINE.json configurations as
deterministic, self-contained runs (synthetic seeded trajectories + fixed
engine seeds). Used by tools/make_golden.py to freeze reference curves and by
test_golden.py to assert they never drift (BASELINE.md plan).

Each scenario returns a dict of named float arrays (the observable curves).
Everything is CPU-sized; determinism comes from the event-ordinal threefry
keying, so the curves are reproducible to float32 round-off on any host.
"""

from __future__ import annotations

import io
import os
import tempfile

import numpy as np


def _write_xyz(path, names, frames):
    from cmdlmc_tpu.io.xyz import write_xyz_frame

    with open(path, "w") as f:
        for pos in frames:
            write_xyz_frame(f, names, pos)


def _solid_acid_frames(n_p=4, n_o=16, n_frames=120, box=10.0, seed=11):
    rng = np.random.RandomState(seed)
    p = rng.uniform(0, box, size=(n_p, 3))
    o = rng.uniform(0, box, size=(n_o, 3))
    base = np.vstack([p, o]).astype(np.float32)
    names = ["P"] * n_p + ["O"] * n_o
    frames = base[None] + rng.normal(
        scale=0.05, size=(n_frames, n_p + n_o, 3)
    ).astype(np.float32)
    return names, frames


def _run_config(cfg_text):
    from cmdlmc_tpu.driver import run_from_config

    out = io.StringIO()
    run_from_config(io.StringIO(cfg_text), out=out)
    rows = [
        [float(x) for x in l.split()]
        for l in out.getvalue().splitlines()
        if l and not l.startswith("#")
    ]
    return np.asarray(rows, dtype=np.float64)


def _columns(rows):
    return {
        "frame": rows[:, 0],
        "msd": rows[:, 2:5],
        "autocorr": rows[:, 5],
        "jumps": rows[:, 6],
    }


_INI = """
[Trajectory]
type = XYZTrajectory
filename = {traj}
time_step = 0.5

[AtomBox]
type = AtomBoxCubic
periodic_boundaries = {box},{box},{box}
{mult}

[NeighborTopology]
donor_atoms = O
cutoff = 3.0
buffer = 2.0

[JumpRate]
type = {law}
{law_params}

[KMCLattice]
lattice_size = {sites}
proton_number = {protons}
time_step = 0.5

[Output]
type = ObservablesOutput
print_frequency = {pf}
reset_frequency = {rf}

[Engine]
replicas = {replicas}
seed = 17
block_size = {bs}
backend = scan
"""

FERMI = "a = 0.1\nb = 2.5\nc = 0.3"


def scenario_1_constant_walk(tmp):
    """Config 1: single proton, static cubic 64-site lattice, constant rate."""
    n_side, spacing = 4, 2.5
    g = np.array(
        [[i, j, k] for i in range(n_side) for j in range(n_side)
         for k in range(n_side)], dtype=np.float32
    ) * spacing
    traj = os.path.join(tmp, "s1.xyz")
    _write_xyz(traj, ["O"] * 64, np.repeat(g[None], 200, axis=0))
    cfg = _INI.format(
        traj=traj, box=n_side * spacing, mult="", law="Constant",
        law_params="a = 0.02", sites=64, protons=1, pf=20, rf=0,
        replicas=32, bs=50,
    )
    return _columns(_run_config(cfg))


def scenario_2_fermi_single_proton(tmp):
    """Config 2: solid-acid-like xyz trajectory, Fermi rates, 1 proton."""
    names, frames = _solid_acid_frames()
    traj = os.path.join(tmp, "s2.xyz")
    _write_xyz(traj, names, frames)
    cfg = _INI.format(
        traj=traj, box=10.0, mult="", law="Fermi", law_params=FERMI,
        sites=16, protons=1, pf=20, rf=0, replicas=32, bs=40,
    )
    return _columns(_run_config(cfg))


def scenario_3_multiproton_jumpstat(tmp):
    """Config 3: multi-proton with exclusion, HDF5 trajectory, jump/exposure
    histograms."""
    from cmdlmc_tpu.config.schema import load_config
    from cmdlmc_tpu.driver import Simulation
    from cmdlmc_tpu.io.converters import save_xyz_to_hdf5

    names, frames = _solid_acid_frames(seed=13)
    traj = os.path.join(tmp, "s3.xyz")
    _write_xyz(traj, names, frames)
    h5 = os.path.join(tmp, "s3.hdf5")
    save_xyz_to_hdf5(traj, h5)
    cfg = _INI.format(
        traj=h5, box=10.0, mult="", law="Fermi", law_params=FERMI,
        sites=16, protons=6, pf=20, rf=0, replicas=32, bs=40,
    ).replace("type = XYZTrajectory", "type = HDF5Trajectory")
    sim = Simulation(load_config(io.StringIO(cfg)))
    sim.hist_bins = 8
    sim.hist_range = (2.2, 3.0)
    out = io.StringIO()
    sim.run(out=out)
    rows = np.asarray(
        [[float(x) for x in l.split()]
         for l in out.getvalue().splitlines() if l and not l.startswith("#")],
        dtype=np.float64,
    )
    res = _columns(rows)
    res["jump_hist"] = np.asarray(
        sim.final_states.replicas.jump_hist, np.float64
    ).sum(axis=0)
    res["exposure"] = np.asarray(
        sim.final_states.replicas.opportunity_hist, np.float64
    ).sum(axis=0)
    return res


def scenario_4_ensemble_conductivity(tmp):
    """Config 4: replica ensemble -> ensemble MSD curve (the conductivity
    input) with across-replica variance columns."""
    names, frames = _solid_acid_frames(seed=29)
    traj = os.path.join(tmp, "s4.xyz")
    _write_xyz(traj, names, frames)
    cfg = _INI.format(
        traj=traj, box=10.0, mult="", law="Fermi", law_params=FERMI,
        sites=16, protons=4, pf=10, rf=0, replicas=128, bs=40,
    )
    return _columns(_run_config(cfg))


def scenario_5_supercell_autocorr(tmp):
    """Config 5: 2x2x2 supercell (box_multiplier) + covalent-bond
    autocorrelation decay with periodic resets."""
    names, frames = _solid_acid_frames(n_p=2, n_o=8, seed=31)
    traj = os.path.join(tmp, "s5.xyz")
    _write_xyz(traj, names, frames)
    cfg = _INI.format(
        traj=traj, box=10.0, mult="box_multiplier = 2,2,2", law="Fermi",
        law_params=FERMI, sites=64, protons=16, pf=20, rf=60,
        replicas=16, bs=30,
    )
    return _columns(_run_config(cfg))


SCENARIOS = {
    "config1_constant_walk": scenario_1_constant_walk,
    "config2_fermi_single": scenario_2_fermi_single_proton,
    "config3_jumpstat": scenario_3_multiproton_jumpstat,
    "config4_ensemble": scenario_4_ensemble_conductivity,
    "config5_supercell": scenario_5_supercell_autocorr,
}


def run_scenario(name: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        return SCENARIOS[name](tmp)
