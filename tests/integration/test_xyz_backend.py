"""XYZOutput mode: the xyz stream emits replica 0's proton pseudo-atoms at
every print frame (MDMC.py:173-177), supports checkpoint/resume, and is
bit-identical across device counts."""

import io
import os

import numpy as np
import pytest

from cmdlmc_tpu.config.schema import load_config
from cmdlmc_tpu.driver import Simulation

N_SITES = 12
N_FRAMES = 24

CFG = """
[Trajectory]
type = XYZTrajectory
filename = {traj}
time_step = 0.5

[AtomBox]
type = AtomBoxCubic
periodic_boundaries = 10, 10, 10

[NeighborTopology]
cutoff = 3.0
buffer = 2.0

[JumpRate]
type = Fermi
a = 0.1
b = 2.3
c = 0.3

[KMCLattice]
lattice_size = {n_sites}
proton_number = 4

[Output]
type = XYZOutput
print_frequency = 6

[Engine]
replicas = 8
seed = 1
block_size = 12
backend = {backend}
devices = {devices}
{extra}
"""


@pytest.fixture(scope="module")
def traj(tmp_path_factory):
    from cmdlmc_tpu.io.xyz import write_xyz_frame

    rng = np.random.RandomState(0)
    pos = rng.uniform(0, 10, size=(N_SITES, 3))
    path = tmp_path_factory.mktemp("xyzmode") / "t.xyz"
    with open(path, "w") as f:
        for _ in range(N_FRAMES):
            write_xyz_frame(
                f, ["O"] * N_SITES, pos + rng.normal(scale=0.02, size=pos.shape)
            )
    return str(path)


def run(traj, backend="scan", devices=1, extra=""):
    cfg = load_config(io.StringIO(CFG.format(
        traj=traj, n_sites=N_SITES, backend=backend, devices=devices,
        extra=extra,
    )))
    out = io.StringIO()
    Simulation(cfg).run(out=out)
    return out.getvalue()


def parse_frames(text):
    """Split xyz output text into frames of (names, positions). Driver-level
    '#' comment lines (version stamp, settings echo) are skipped; per-frame
    comment lines inside the xyz body ("frame N") don't start with '#'."""
    lines = [l for l in text.splitlines() if l and not l.startswith("#")]
    frames = []
    i = 0
    while i < len(lines):
        n = int(lines[i])
        body = lines[i + 2 : i + 2 + n]
        names = [l.split()[0] for l in body]
        pos = np.array([[float(x) for x in l.split()[1:4]] for l in body])
        frames.append((names, pos, lines[i + 1]))
        i += 2 + n
    return frames


def test_xyz_backend_runs_and_is_well_formed(traj):
    frames = parse_frames(run(traj))
    assert len(frames) == N_FRAMES // 6
    for names, pos, comment in frames:
        assert names.count("O") == N_SITES
        assert names.count("H") == 4
        assert np.all(np.isfinite(pos))
        # proton pseudo-atom positions coincide with donor sites
        donors, protons = pos[:N_SITES], pos[N_SITES:]
        for p in protons:
            assert np.min(np.linalg.norm(donors - p, axis=1)) < 1e-5
    assert frames[0][2] == "frame 0"
    assert frames[-1][2] == f"frame {N_FRAMES - 6}"


def strip_comments(text):
    return "\n".join(
        l for l in text.splitlines() if l and not l.startswith("#")
    )


def test_xyz_multichip_bit_identical(traj):
    # compare the xyz frames only (the '#' settings echo legitimately differs
    # in its devices line)
    assert strip_comments(run(traj, devices=1)) == strip_comments(
        run(traj, devices=8)
    )


def test_xyz_same_frame_cadence_as_observables(traj):
    """Both output modes print the same frames, and the xyz donor positions
    are the trajectory's own frames."""
    xyz_frames = parse_frames(run(traj))
    cfg = load_config(io.StringIO(CFG.format(
        traj=traj, n_sites=N_SITES, backend="auto", devices=1, extra="",
    ).replace("type = XYZOutput", "type = ObservablesOutput")))
    out = io.StringIO()
    Simulation(cfg).run(out=out)
    obs_frames = [int(l.split()[0]) for l in strip_comments(
        out.getvalue()).splitlines()]
    assert [c for _, _, c in xyz_frames] == [f"frame {f}" for f in obs_frames]
    from cmdlmc_tpu.io.xyz import XYZTrajectory

    traj_frames = list(XYZTrajectory(traj, time_step=0.5))
    for (_, pos, comment), f in zip(xyz_frames, obs_frames):
        np.testing.assert_allclose(
            pos[:N_SITES], traj_frames[f].positions, atol=1e-5
        )


def test_xyz_checkpoint_resume(traj, tmp_path):
    ckpt = str(tmp_path / "ck.npz")
    full = run(traj)
    run(traj, extra=f"sweeps = 12\ncheckpoint_path = {ckpt}\n"
                    "checkpoint_interval = 1")
    assert os.path.exists(ckpt)
    resumed = run(traj, extra=f"checkpoint_path = {ckpt}\n"
                              "checkpoint_interval = 1")
    # frames printed after resume match the tail of the uninterrupted run
    full_frames = parse_frames(full)
    resumed_frames = parse_frames(resumed)
    assert len(resumed_frames) > 0
    for (fn, fp, fc), (rn, rp, rc) in zip(
        full_frames[-len(resumed_frames):], resumed_frames
    ):
        assert fn == rn and fc == rc
        np.testing.assert_array_equal(fp, rp)


def test_xyz_triclinic_cell_runs(traj):
    """A skewed triclinic cell (beyond the round-based minimum-image bound)
    runs through the scan engine's 27-image minimum image."""
    cfg_text = CFG.format(
        traj=traj, n_sites=N_SITES, backend="scan", devices=1, extra="",
    ).replace(
        "type = AtomBoxCubic\nperiodic_boundaries = 10, 10, 10",
        "type = AtomBoxMonoclinic\n"
        "periodic_boundaries = 10, 0, 0, 4.9, 1.0, 0, 0, 0, 10",
    )
    out = io.StringIO()
    Simulation(load_config(io.StringIO(cfg_text))).run(out=out)
    frames = parse_frames(out.getvalue())
    assert len(frames) == N_FRAMES // 6
    for names, pos, _ in frames:
        assert names.count("H") == 4 and np.all(np.isfinite(pos))
