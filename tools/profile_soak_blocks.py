# Per-block wall times through the REAL driver loop (Simulation.observable_rows)
# against an existing soak trajectory (tools/soak_driver.py --workdir keeps
# one) — the per-block view behind soak_driver.py's aggregate number.
# One row per yielded observable record: wall since the previous one.
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ap = argparse.ArgumentParser()
ap.add_argument("--traj", required=True)
ap.add_argument("--blocks", type=int, default=25)
ap.add_argument("--block-size", type=int, default=2000)
ap.add_argument("--replicas", type=int, default=4096)
ap.add_argument("--protons", type=int, default=96)
ap.add_argument("--sites", type=int, default=144)
ap.add_argument("--checkpoint", action="store_true",
                help="enable the soak's checkpoint_interval=10 cadence")
args = ap.parse_args()

import tempfile

work = tempfile.mkdtemp(prefix="soakblk_")
N = args.sites
L = 14.5 * (N / 144.0) ** (1 / 3)
ckpt = (
    f"checkpoint_path = {os.path.join(work, 'c.npz')}\n"
    "checkpoint_interval = 10" if args.checkpoint else ""
)
config = f"""
[Trajectory]
type = HDF5Trajectory
filename = {args.traj}
time_step = 0.5
selection = O
chunk_size = {args.block_size}

[AtomBox]
type = AtomBoxCubic
periodic_boundaries = {L}, {L}, {L}

[NeighborTopology]
donor_atoms = O
cutoff = 3.0
buffer = 2.0

[JumpRate]
type = Fermi
a = 0.06
b = 2.3
c = 0.1

[KMCLattice]
lattice_size = {N}
proton_number = {args.protons}
time_step = 0.5

[Output]
type = observables
print_frequency = {args.block_size}
reset_frequency = 50000

[Engine]
replicas = {args.replicas}
seed = 1
block_size = {args.block_size}
sweeps = {args.blocks * args.block_size}
{ckpt}
"""
cfg_path = os.path.join(work, "p.ini")
with open(cfg_path, "w") as f:
    f.write(config)

from cmdlmc_tpu.config.schema import load_config
from cmdlmc_tpu.driver import Simulation

sim = Simulation(load_config(cfg_path))
t_prev = time.perf_counter()
t_start = t_prev
n = 0
for rec in sim.observable_rows():
    t = time.perf_counter()
    print(f"block {n:4d}  frame {rec.frame:8d}  {1e3 * (t - t_prev):9.1f} ms",
          flush=True)
    t_prev = t
    n += 1
wall = time.perf_counter() - t_start
fr = args.blocks * args.block_size
print(f"total {wall:.1f}s  {fr / wall:.0f} frames/s  "
      f"{fr / wall * args.replicas * N / 1e9:.2f} G su/s")
