"""The f32 device path against float64 references.

Tolerances, and why:

* distances: 2e-5 A in a ~25 A triclinic cell. An f32 coordinate of 25 A has
  an ulp of 1.9e-6 A, and the fractional round trip (h^-1, round, h) adds a
  few more; a TF32 product (10-bit mantissa) would be off by ~1e-2 A.
* rates W: max |dW| <= 1e-5 max |W|. Entry by entry the f32 law is only good
  to ~1e-5 relative whatever the precision: it amplifies the few-ulp error
  of an f32 distance (~2.4e-7 A per ulp at 2.5 A) by 1/c = 10/A.
* per-replica totals sum(occ W (1 - occ)): 1e-5 relative. An f32 sum over
  the ~144 allowed terms is good to ~1e-6; TF32 would miss by ~1e-3.

The CPU cases run everywhere. The gpu-marked cases need an NVIDIA GPU and skip
elsewhere; ``python chip_smoke.py`` (phase 5) runs them on the card at the
flagship size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jcore

from cmdlmc_tpu.core.cell import Cell, minimum_image, pairwise_distances, wrap_positions
from cmdlmc_tpu.engine import lattice as eng
from cmdlmc_tpu.io.synthetic import CSH2PO4_CELL, solid_acid_frames
from cmdlmc_tpu.rates.laws import Fermi
from cmdlmc_tpu.topo.models import (
    AnglePairRates, Frame, HydroniumRates, PairRates, TopKPairRates,
)
from cmdlmc_tpu.topo.transforms import DistanceInterpolator, ReLUTransformation

DIST_TOL = 2e-5  # Angstrom
RATE_RTOL = 1e-5
FERMI = dict(a=0.06, b=2.3, c=0.1)
TRICLINIC_ROWS = np.array([[12.0, 0, 0], [2.5, 11.5, 0], [0, 0, 12.0]])

# (cell rows, box multiplier): the flagship's cubic CsH2PO4 cell, and the
# triclinic cell of examples/triclinic.ini once and doubled (~25 A)
CELLS = {
    "cubic": (np.diag(CSH2PO4_CELL), (1, 1, 1)),
    "triclinic": (TRICLINIC_ROWS, (1, 1, 1)),
    "triclinic25": (TRICLINIC_ROWS, (2, 2, 2)),
}


def make_cell(name):
    rows, mult = CELLS[name]
    if name == "cubic":
        return Cell.cubic(np.diagonal(rows), mult), rows * np.asarray(mult)[:, None]
    return Cell.triclinic(rows, mult), rows * np.asarray(mult)[:, None]


def random_positions(rows, n, seed):
    frac = np.random.RandomState(seed).uniform(0, 1, size=(n, 3))
    return (frac @ rows).astype(np.float32)


def np_minimum_image(rows, dvec):
    """float64 minimum image: wrap into the home cell, then the shortest of
    the 27 surrounding images (numpyatom.pyx:61-123)."""
    h = rows.T  # columns are cell vectors
    frac = dvec @ np.linalg.inv(h).T
    base = (frac - np.round(frac)) @ h.T
    shifts = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], np.float64) @ h.T
    cands = base[..., None, :] + shifts
    best = np.argmin((cands**2).sum(-1), axis=-1)
    return np.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]


def np_pairwise(rows, pos):
    pos = pos.astype(np.float64)
    d = np_minimum_image(rows, pos[None, :, :] - pos[:, None, :])
    return np.sqrt((d**2).sum(-1))


def np_fermi(d):
    return FERMI["a"] / (1.0 + np.exp((d - FERMI["b"]) / FERMI["c"]))


def fermi():
    return Fermi(**{k: jnp.float32(v) for k, v in FERMI.items()})


def distance_error(cell_name, n, seed=0):
    cell, rows = make_cell(cell_name)
    pos = random_positions(rows, n, seed)
    got = np.asarray(pairwise_distances(cell, jnp.asarray(pos), jnp.asarray(pos)))
    return float(np.abs(got - np_pairwise(rows, pos)).max())


def rate_errors(n_replicas, seed=0, precision_check=False):
    """Errors of the flagship rates W (max |dW| / max W, and the worst entry's
    relative error for the record) and of the per-replica totals
    sum(occ W (1 - occ)) (max relative) against float64, on the default
    device."""
    _, frames = solid_acid_frames(2, seed)
    donors = frames[1, 36:]
    cell = Cell.cubic(CSH2PO4_CELL)
    model = PairRates(cell=cell, law=fermi(), cutoff=jnp.float32(3.0),
                      buffer=jnp.float32(2.0))
    frame = Frame(donors=jnp.asarray(donors), extras=None,
                  time=jnp.float32(0.0), index=jnp.int32(0))
    W = np.asarray(jax.jit(model.shared)(frame).W)

    d64 = np_pairwise(np.diag(CSH2PO4_CELL), donors)
    n = len(donors)
    mask = (d64 <= 5.0) & ~np.eye(n, dtype=bool)
    W64 = np.where(mask, np_fermi(d64), 0.0)
    w_err = float(np.abs(W - W64).max() / W64.max())
    big = W64 > 1e-3 * W64.max()
    w_entry = float((np.abs(W - W64)[big] / W64[big]).max())

    ens = eng.init_replicas(jax.random.key(seed), n_replicas, n, 96,
                            jnp.asarray(donors))
    occ = ens.replicas.occ

    @jax.jit
    def totals(W, occ):
        return jax.vmap(lambda o: (o * eng.outgoing_rates(W, o)).sum())(occ)

    got = np.asarray(totals(jnp.asarray(W), occ))
    occ64 = np.asarray(occ, np.float64)
    want = np.einsum("ri,ij,rj->r", occ64, W64, 1.0 - occ64)
    t_err = float((np.abs(got - want) / want).max())
    out = {"W": w_err, "W_worst_entry": w_entry, "totals": t_err}
    if precision_check:
        # the same product at the default precision, for the record
        default = jax.jit(jax.vmap(
            lambda o: (o * (jnp.asarray(W) @ (1.0 - o))).sum()))(occ)
        out["totals_default_precision"] = float(
            (np.abs(np.asarray(default) - want) / want).max())
    return out


# ---------------------------------------------------------------------------
# CPU cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [144, 1152])
@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_pairwise_distances_match_float64(cell_name, n):
    err = distance_error(cell_name, n)
    assert err <= DIST_TOL, err


@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_minimum_image_matches_float64_search(cell_name):
    cell, rows = make_cell(cell_name)
    rng = np.random.RandomState(1)
    # raw differences up to two cell lengths in every direction
    dvec = (rng.uniform(-2, 2, size=(4096, 3)) @ rows).astype(np.float32)
    got = np.asarray(minimum_image(cell, jnp.asarray(dvec)))
    want = np_minimum_image(rows, dvec.astype(np.float64))
    # equal-length images may tie: compare the lengths
    np.testing.assert_allclose(np.linalg.norm(got, axis=1),
                               np.linalg.norm(want, axis=1), atol=DIST_TOL)


@pytest.mark.parametrize("cell_name", sorted(CELLS))
def test_wrap_positions_matches_float64(cell_name):
    cell, rows = make_cell(cell_name)
    rng = np.random.RandomState(2)
    pos = (rng.uniform(-1.5, 2.5, size=(2048, 3)) @ rows).astype(np.float32)
    got = np.asarray(wrap_positions(cell, jnp.asarray(pos)))
    h = rows.T
    frac = pos.astype(np.float64) @ np.linalg.inv(h).T
    want = (frac - np.floor(frac)) @ h.T
    # a point on a face may wrap to either side: compare minimum images
    diff = np_minimum_image(rows, got.astype(np.float64) - want)
    assert np.abs(diff).max() <= DIST_TOL


def test_rates_and_totals_match_float64():
    errs = rate_errors(n_replicas=256)
    assert errs["W"] <= RATE_RTOL, errs
    assert errs["totals"] <= RATE_RTOL, errs


def _dot_precisions(jaxpr):
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for value in eqn.params.values():
            for sub in value if isinstance(value, (list, tuple)) else [value]:
                if isinstance(sub, jcore.ClosedJaxpr):
                    found += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    found += _dot_precisions(sub)
    return found


HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _frame_step_model(kind, cell):
    law = fermi()
    f32 = jnp.float32
    if kind == "dense":
        return PairRates(cell=cell, law=law, cutoff=f32(3.0), buffer=f32(2.0))
    if kind == "topk":
        return TopKPairRates(cell=cell, law=law, cutoff=f32(3.0),
                             buffer=f32(2.0), k=4)
    if kind == "hydronium":
        return HydroniumRates(
            cell=cell, law=law, cutoff=f32(3.0), buffer=f32(2.0),
            transform=ReLUTransformation(a=f32(0.5), b=f32(2.2), d0=f32(2.4),
                                         left_bound=f32(2.0),
                                         right_bound=f32(3.0)),
            interpolator=DistanceInterpolator(relaxation_time=f32(5.0)), k=4)
    raise ValueError(kind)


@pytest.mark.parametrize("cell_name", ["cubic", "triclinic"])
@pytest.mark.parametrize("kind", ["dense", "topk", "hydronium", "angle"])
def test_frame_step_dots_are_highest(kind, cell_name):
    """Every dot_general the scan engine's frame step traces, including the
    triclinic minimum image of core/cell.py, is pinned to HIGHEST."""
    cell, rows = make_cell(cell_name)
    n, frames_n = 12, 3
    pos = random_positions(rows, n, 3)
    extras = random_positions(rows, 4, 4) if kind == "angle" else None
    if kind == "angle":
        from cmdlmc_tpu.rates.laws import FermiAngle

        model = AnglePairRates.from_first_frame(
            cell, FermiAngle(a=jnp.float32(0.06), b=jnp.float32(2.3),
                             c=jnp.float32(0.1), theta=jnp.float32(1.0)),
            cutoff=3.0, buffer=2.0, donors0=jnp.asarray(pos),
            extras0=jnp.asarray(extras), group_size=3)
    else:
        model = _frame_step_model(kind, cell)
    ens = eng.init_replicas(jax.random.key(0), 4, n, 3, jnp.asarray(pos))
    keys = jax.random.split(jax.random.key(1), 4)
    idx = jnp.arange(frames_n, dtype=jnp.int32)
    frames = Frame(
        donors=jnp.broadcast_to(jnp.asarray(pos), (frames_n, n, 3)),
        extras=(None if extras is None
                else jnp.broadcast_to(jnp.asarray(extras), (frames_n, 4, 3))),
        time=idx.astype(jnp.float32), index=idx)
    jaxpr = jax.make_jaxpr(
        lambda e, k, f: eng.run_block(model, cell, e, k, f, dt=0.5,
                                      reset_frequency=2, emit_every=1)
    )(ens, keys, frames)
    precisions = _dot_precisions(jaxpr.jaxpr)
    assert all(p == HIGHEST for p in precisions), precisions
    if kind == "dense" or cell_name == "triclinic":
        assert precisions, "expected at least one dot_general to check"


@pytest.mark.parametrize("fn", ["minimum_image", "wrap_positions",
                                "pairwise_distances"])
def test_cell_dots_are_highest(fn):
    cell, rows = make_cell("triclinic")
    pos = jnp.asarray(random_positions(rows, 8, 5))
    call = {
        "minimum_image": lambda p: minimum_image(cell, p),
        "wrap_positions": lambda p: wrap_positions(cell, p),
        "pairwise_distances": lambda p: pairwise_distances(cell, p, p),
    }[fn]
    precisions = _dot_precisions(jax.make_jaxpr(call)(pos).jaxpr)
    assert precisions and all(p == HIGHEST for p in precisions), precisions


# ---------------------------------------------------------------------------
# GPU cases (skipped without an NVIDIA GPU)
# ---------------------------------------------------------------------------


@pytest.fixture
def gpu():
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py there)")
    return devices[0]


@pytest.mark.gpu
def test_gpu_rates_and_totals_match_float64(gpu):
    """Flagship size: 144 sites, 16384 replicas."""
    errs = rate_errors(n_replicas=16384, precision_check=True)
    print(f"\nrates vs float64 on {gpu.device_kind}: {errs}")
    assert errs["W"] <= RATE_RTOL, errs
    assert errs["totals"] <= RATE_RTOL, errs


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", ["triclinic25", "cubic"])
def test_gpu_distances_match_float64(gpu, cell_name):
    err = distance_error(cell_name, 1152)
    print(f"\n{cell_name} distances vs float64 on {gpu.device_kind}: "
          f"max |err| = {err:.3e} A")
    assert err <= DIST_TOL, err


def _flagship_run(device, frames, n_replicas):
    """One 500-frame flagship block through the scan engine on ``device``:
    (per-frame W, final replica state, per-replica MSD)."""
    with jax.default_device(device):
        cell = Cell.cubic(CSH2PO4_CELL)
        model = PairRates(cell=cell, law=fermi(), cutoff=jnp.float32(3.0),
                          buffer=jnp.float32(2.0))
        donors = jnp.asarray(frames[:, 36:])
        ens = eng.init_replicas(jax.random.key(3), n_replicas, 144, 96,
                                donors[0])
        keys = jax.random.split(jax.random.key(4), n_replicas)
        idx = jnp.arange(len(frames), dtype=jnp.int32)
        blk = Frame(donors=donors, extras=None,
                    time=idx.astype(jnp.float32) * jnp.float32(0.4), index=idx)
        W = jax.jit(jax.vmap(lambda d: model.shared(
            Frame(donors=d, extras=None, time=jnp.float32(0.0),
                  index=jnp.int32(0))).W))(donors)
        ens, _ = eng.run_block(model, cell, ens, keys, blk, dt=0.4,
                               max_events=6, emit_every=100)
        msd = eng.observables_of(ens.replicas, ens.site_disp)[0].sum(axis=1)
        return jax.device_get((W, ens.replicas, msd))


@pytest.mark.gpu
def test_gpu_matches_cpu_flagship(gpu):
    """The same 1024-replica, 500-frame flagship run on the GPU and on the
    CPU: rate tables to 1e-5, jumps and MSD within |z| < 4."""
    _, frames = solid_acid_frames(500, 7)
    W_g, rep_g, msd_g = _flagship_run(gpu, frames, 1024)
    W_c, rep_c, msd_c = _flagship_run(jax.devices("cpu")[0], frames, 1024)
    scale = np.abs(W_c).max()
    w_err = float(np.abs(W_g - W_c).max() / scale)
    same = ((rep_g.jumps == rep_c.jumps)
            & (rep_g.clock.event_count == rep_c.clock.event_count)
            & np.all(rep_g.site_of_proton == rep_c.site_of_proton, axis=1))
    print(f"\nGPU vs CPU flagship (R=1024, 500 frames): rate tables max "
          f"|dW|/max W = {w_err:.3e}; replicas with bit-identical integer "
          f"outcomes: {same.mean():.4f}")
    assert w_err <= RATE_RTOL
    for name, g, c in (("jumps", rep_g.jumps.astype(float),
                        rep_c.jumps.astype(float)),
                       ("msd", np.asarray(msd_g, float),
                        np.asarray(msd_c, float))):
        se = np.sqrt(g.var(ddof=1) / len(g) + c.var(ddof=1) / len(c))
        z = 0.0 if se == 0 else (g.mean() - c.mean()) / se
        print(f"  {name}: GPU {g.mean():.6f} CPU {c.mean():.6f} z={z:.3f}")
        assert abs(z) < 4, (name, z)
