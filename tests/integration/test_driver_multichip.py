"""End-to-end multi-device through the driver: `mdmc config.ini` with
[Engine] devices > 1 shards the replica axis over the mesh and produces output
bit-identical to the single-device run, for the dense and the top-K topology
(the scan engine partitions under GSPMD) — exercised here on the virtual
8-device CPU mesh."""

import io
import os

import numpy as np
import pytest

from cmdlmc_tpu.config.schema import load_config
from cmdlmc_tpu.driver import Simulation
from cmdlmc_tpu.io.xyz import write_xyz_frame

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
type = NeighborTopology
cutoff = 3.0
buffer = 2.0
{topo_extra}

[JumpRate]
type = Fermi
a = 0.1
b = 2.3
c = 0.3

[KMCLattice]
lattice_size = {n_sites}
proton_number = 4

[Output]
print_frequency = 6

[Engine]
replicas = 8
seed = 1
block_size = 12
devices = {devices}
mesh_axis = {mesh_axis}
{extra}
"""


@pytest.fixture(scope="module")
def traj(tmp_path_factory):
    rng = np.random.RandomState(0)
    pos = rng.uniform(0, 10, size=(N_SITES, 3))
    path = tmp_path_factory.mktemp("mc") / "t.xyz"
    with open(path, "w") as f:
        for _ in range(N_FRAMES):
            write_xyz_frame(
                f, ["O"] * N_SITES, pos + rng.normal(scale=0.02, size=pos.shape)
            )
    return str(path)


TOPOLOGIES = {"dense": "", "topk": "max_neighbors = 4"}


def run(traj, devices, mesh_axis="replica", extra="", topology="dense"):
    cfg = load_config(io.StringIO(CFG.format(
        traj=traj, n_sites=N_SITES, devices=devices, mesh_axis=mesh_axis,
        extra=extra, topo_extra=TOPOLOGIES[topology],
    )))
    out = io.StringIO()
    sim = Simulation(cfg)
    sim.run(out=out)
    rows = [
        l for l in out.getvalue().splitlines()
        if l and not l.startswith("#")
    ]
    return rows, sim


@pytest.mark.parametrize("topology", sorted(TOPOLOGIES))
def test_driver_multichip_bit_identical(traj, topology):
    rows1, _ = run(traj, devices=1, topology=topology)
    rows8, sim8 = run(traj, devices=8, topology=topology)
    assert rows1 == rows8
    # the final states really are sharded over the mesh
    assert not sim8.final_states.replicas.occ.sharding.is_fully_replicated


def test_driver_multichip_mesh_axis_name(traj):
    """[Engine] mesh_axis names the replica mesh axis (the knob is consumed,
    not dead)."""
    rows, sim = run(traj, devices=8, mesh_axis="chips")
    rows_default, _ = run(traj, devices=8)
    assert rows == rows_default
    sharding = sim.final_states.replicas.occ.sharding
    assert tuple(sharding.mesh.axis_names) == ("chips",)


def test_driver_devices_validation(traj):
    # replicas=8 not divisible by 3 devices
    with pytest.raises(ValueError, match="divisible"):
        run(traj, devices=3)
    with pytest.raises(ValueError, match="devices"):
        run(traj, devices=100)
    with pytest.raises(ValueError, match="devices"):
        run(traj, devices="never")


def test_driver_multichip_checkpoint_resume(traj, tmp_path):
    """Checkpoint written by a sharded run resumes bit-exactly (states are
    gathered to host on save and re-sharded on load)."""
    ckpt = str(tmp_path / "ck.npz")
    full_rows, _ = run(traj, devices=8)

    # first half: sweeps=12 = one block, checkpoint at the end
    extra = f"sweeps = 12\ncheckpoint_path = {ckpt}\ncheckpoint_interval = 1"
    run(traj, devices=8, extra=extra)
    assert os.path.exists(ckpt)

    # resume for the rest; rows produced after resume must match the tail of
    # the uninterrupted run
    extra2 = f"checkpoint_path = {ckpt}\ncheckpoint_interval = 1"
    resumed_rows, _ = run(traj, devices=8, extra=extra2)
    assert resumed_rows == full_rows[-len(resumed_rows):]
    assert len(resumed_rows) > 0
