"""Checkpoint-robustness guarantees: re-running a completed run is a no-op, a
config change refuses to resume, a block_size change that straddles the
checkpoint fails loudly, and the observable cadence (prints and resets) does
not depend on the block size."""

import io

import numpy as np
import pytest

from cmdlmc_tpu.driver import run_from_config
from cmdlmc_tpu.io.xyz import write_xyz_frame


def make_traj(tmp_path, n_frames=60, n_atoms=10):
    rng = np.random.RandomState(0)
    pos = rng.uniform(0, 10, size=(n_atoms, 3))
    path = tmp_path / "t.xyz"
    with open(path, "w") as f:
        for _ in range(n_frames):
            write_xyz_frame(f, ["O"] * n_atoms,
                            pos + rng.normal(scale=0.03, size=pos.shape))
    return path


def config(traj, *, sweeps=60, ckpt="", block_size=20, seed=7,
           print_frequency=10, reset_frequency=0):
    ck = f"checkpoint_path = {ckpt}" if ckpt else ""
    rf = f"reset_frequency = {reset_frequency}" if reset_frequency else ""
    return f"""
[Trajectory]
type = XYZTrajectory
filename = {traj}
time_step = 0.5

[AtomBox]
type = AtomBoxCubic
periodic_boundaries = 10,10,10

[NeighborTopology]
donor_atoms = O
cutoff = 3.0
buffer = 2.0

[JumpRate]
type = Fermi
a = 0.1
b = 2.5
c = 0.3

[KMCLattice]
lattice_size = 10
proton_number = 4
time_step = 0.5

[Output]
type = ObservablesOutput
print_frequency = {print_frequency}
{rf}

[Engine]
replicas = 4
seed = {seed}
block_size = {block_size}
sweeps = {sweeps}
{ck}
"""


def run(cfg_text):
    out = io.StringIO()
    run_from_config(io.StringIO(cfg_text), out=out)
    return [
        l for l in out.getvalue().splitlines() if l and not l.startswith("#")
    ]


def test_rerun_of_completed_run_is_noop(tmp_path):
    """A second run over a finished checkpoint must not
    double-simulate — the checkpoint keeps pointing at the end frame."""
    traj = make_traj(tmp_path)
    ckpt = str(tmp_path / "c.npz")
    rows1 = run(config(traj, ckpt=ckpt))
    assert rows1  # produced output
    rows2 = run(config(traj, ckpt=ckpt))
    assert rows2 == []  # everything already simulated: no new rows
    with np.load(ckpt) as f:
        assert int(f["next_frame"]) == 60  # not rewound to 0
    # and a third run still refuses to re-simulate
    rows3 = run(config(traj, ckpt=ckpt))
    assert rows3 == []


def test_resume_with_different_physics_refuses(tmp_path):
    traj = make_traj(tmp_path)
    ckpt = str(tmp_path / "c.npz")
    run(config(traj, sweeps=40, ckpt=ckpt))
    with pytest.raises(ValueError, match="different physics"):
        run(config(traj, sweeps=60, ckpt=ckpt, seed=8))


def test_resume_with_straddling_block_size_refuses(tmp_path):
    traj = make_traj(tmp_path)
    ckpt = str(tmp_path / "c.npz")
    run(config(traj, sweeps=30, ckpt=ckpt, block_size=10))  # checkpoint at 30
    with pytest.raises(ValueError, match="block_size"):
        # blocks of 25: [0,25) skipped? no — 25 < 30 < 50 straddles
        run(config(traj, sweeps=60, ckpt=ckpt, block_size=25))


def test_resume_with_compatible_block_size_continues(tmp_path):
    traj = make_traj(tmp_path)
    ckpt = str(tmp_path / "c.npz")
    full = run(config(traj, sweeps=60, block_size=20))
    run(config(traj, sweeps=30, ckpt=ckpt, block_size=10))
    resumed = run(config(traj, sweeps=60, ckpt=ckpt, block_size=10))
    # rows emitted after the resume point must match the uninterrupted run
    # bit-exactly (event-ordinal RNG keying)
    tail = [r for r in full if float(r.split()[0]) >= 30]
    assert resumed == tail


def test_cadence_is_block_size_invariant(tmp_path):
    """Rows come at exactly the print frames (per-frame cadence parity,
    MDMC.py:198-208), not at block boundaries, and the whole output is
    bit-identical whatever the block size (event-ordinal RNG keying)."""
    traj = make_traj(tmp_path)
    rows_16 = run(config(traj, block_size=16, print_frequency=10,
                         reset_frequency=25))
    rows_7 = run(config(traj, block_size=7, print_frequency=10,
                        reset_frequency=25))
    frames = [int(float(r.split()[0])) for r in rows_16]
    assert frames == [0, 10, 20, 30, 40, 50]
    assert rows_7 == rows_16
    # the reset after frame 25 zeroes the jump counter
    jumps = [float(r.split()[6]) for r in rows_16]
    assert jumps[3] <= jumps[2] + 1e-6 or jumps[2] == 0
