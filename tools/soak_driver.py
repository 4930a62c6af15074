# End-to-end production soak: stream a large HDF5 trajectory through the full
# driver stack (prefetch -> scan engine -> observable resets -> periodic
# checkpoints) and report steady-state site-updates/s.
#
# GPU:  python tools/soak_driver.py --frames 1000000
# CPU:  python tools/soak_driver.py --platform cpu --frames 2000 --replicas 64
import argparse
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

ap = argparse.ArgumentParser()
ap.add_argument("--platform", default=None)
ap.add_argument("--frames", type=int, default=200_000)
ap.add_argument("--sites", type=int, default=144)
ap.add_argument("--protons", type=int, default=96)
ap.add_argument("--replicas", type=int, default=4096)
ap.add_argument("--block-size", type=int, default=2000)
ap.add_argument("--print-frequency", type=int, default=2000)
ap.add_argument("--reset-frequency", type=int, default=50_000)
ap.add_argument("--workdir", default=None, help="keep artifacts here")
ap.add_argument("--compression", default="auto",
                choices=("auto", "none", "blosc", "lzf", "gzip"),
                help="trajectory HDF5 compression ('none' = streaming fast "
                "layout: raw chunked reads, no decode on the prefetch thread)")
ap.add_argument("--drop-cache", action="store_true",
                help="evict the trajectory from the OS page cache before the "
                "run (posix_fadvise DONTNEED) — measures the true cold-IO "
                "streaming path")
args = ap.parse_args()

if args.platform:
    import jax

    jax.config.update("jax_platforms", args.platform)

from cmdlmc_tpu.io.hdf5 import write_trajectory

work = args.workdir or tempfile.mkdtemp(prefix="soak_")
os.makedirs(work, exist_ok=True)
# compression choice baked into the name so switching never reuses a stale file
suffix = "" if args.compression == "auto" else f".{args.compression}"
traj_path = os.path.join(work, f"soak{suffix}.hdf5")

rng = np.random.RandomState(0)
N = args.sites
L = 14.5 * (N / 144.0) ** (1 / 3)
base = rng.uniform(0, L, size=(N, 3)).astype(np.float32)
names = np.array(["O"] * N)

if not os.path.exists(traj_path):
    t0 = time.perf_counter()

    def frames():
        for _ in range(args.frames):
            yield base + rng.normal(scale=0.03, size=base.shape).astype(np.float32)

    write_trajectory(traj_path, names, args.frames, (N, 3), frames(),
                     compression=args.compression)
    print(f"# trajectory written: {os.path.getsize(traj_path)/1e9:.2f} GB "
          f"in {time.perf_counter()-t0:.0f}s", flush=True)

if args.drop_cache:
    # evict the file's pages so the run reads from disk, not RAM (no root
    # needed, unlike /proc/sys/vm/drop_caches)
    fd = os.open(traj_path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    print("# page cache dropped for", traj_path, flush=True)

config = f"""
[Trajectory]
type = HDF5Trajectory
filename = {traj_path}
time_step = 0.5
selection = O
chunk_size = {args.block_size}

[AtomBox]
type = AtomBoxCubic
periodic_boundaries = {L}, {L}, {L}

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
lattice_size = {N}
donor_atoms = O
proton_number = {args.protons}
time_step = 0.5

[Output]
type = observables
print_frequency = {args.print_frequency}
reset_frequency = {args.reset_frequency}

[Engine]
replicas = {args.replicas}
seed = 1
block_size = {args.block_size}
checkpoint_path = {os.path.join(work, "soak.ckpt")}
checkpoint_interval = 10
"""
cfg_path = os.path.join(work, "soak.ini")
with open(cfg_path, "w") as f:
    f.write(config)

from cmdlmc_tpu.driver import run_from_config

out_path = os.path.join(work, "soak.out")
t0 = time.perf_counter()
with open(out_path, "w") as out:
    run_from_config(cfg_path, out=out)
wall = time.perf_counter() - t0

perf = None
for line in open(out_path):
    if line.startswith("# perf"):
        perf = line.strip()
print(perf)
m = re.findall(r"([\d.eE+]+) site-updates/s", perf or "")
su = float(m[-1]) if m else float("nan")  # last = excl.-compile steady state
print(f"# soak: {args.frames} frames, {args.replicas} replicas x {N} sites, "
      f"wall {wall:.0f}s, steady-state {su:.3e} site-updates/s")
