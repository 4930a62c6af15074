"""Seeded synthetic trajectories with MD-like correlated drift.

The reference's own trajectories are not distributed, so smoke runs and
numerics checks generate theirs: every atom wanders around a fixed site as an
AR(1) process (``x <- base + 0.9 (x - base) + N(0, sigma)``, as in
examples/make_demo_trajectory.py), which keeps pair distances near their
equilibrium while the rate tables change every frame.
"""

from __future__ import annotations

import numpy as np

# CsH2PO4 cell of the reference integration scale (README.md): 36 PO4
# tetrahedra, i.e. 144 donor oxygens.
CSH2PO4_CELL = (29.122, 25.354, 12.363)
_PO_BOND = 1.54  # Angstrom; the intra-tetrahedron O-O distance is ~2.51


def _drift(base, n_frames, rng, sigma):
    x = base.copy()
    out = np.empty((n_frames, *base.shape), np.float32)
    for f in range(n_frames):
        x = base + 0.9 * (x - base) + rng.normal(scale=sigma, size=base.shape)
        out[f] = x
    return out


def solid_acid_frames(n_frames: int, seed: int, sigma: float = 0.04):
    """(names, positions [F, 180, 3]) of 36 P atoms on a 6x3x2 grid of the
    CsH2PO4 cell, each with 4 O at tetrahedral positions 1.54 A away in a
    random orientation (144 O donors)."""
    rng = np.random.RandomState(seed)
    grid = np.array(
        [[i, j, k] for i in range(6) for j in range(3) for k in range(2)],
        np.float64,
    )
    p = (grid + 0.5 + rng.uniform(-0.1, 0.1, grid.shape)) * (
        np.asarray(CSH2PO4_CELL) / (6, 3, 2)
    )
    tetra = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]],
                     np.float64) / np.sqrt(3.0)
    o = []
    for centre in p:
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))  # random rotation
        o.append(centre + _PO_BOND * tetra @ q.T)
    base = np.vstack([p, np.concatenate(o)])
    names = ["P"] * len(p) + ["O"] * (4 * len(p))
    return names, _drift(base, n_frames, rng, sigma)


def water_frames(n_frames: int, seed: int, n_side: int = 6,
                 spacing: float = 3.1, sigma: float = 0.05):
    """(names, positions [F, n_side^3, 3]) of water oxygens on a jittered
    cubic grid: 216 O in an 18.6 A box at the defaults, the density of
    liquid water."""
    rng = np.random.RandomState(seed)
    grid = np.array(
        [[i, j, k] for i in range(n_side) for j in range(n_side)
         for k in range(n_side)], np.float64,
    )
    base = (grid + 0.5) * spacing + rng.normal(scale=0.3, size=grid.shape)
    return ["O"] * len(base), _drift(base, n_frames, rng, sigma)


def write_xyz(path: str, names, frames) -> None:
    from cmdlmc_tpu.io.xyz import write_xyz_frame

    with open(path, "w") as f:
        for pos in frames:
            write_xyz_frame(f, names, pos)
