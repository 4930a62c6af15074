"""Topology rate-model tests, porting the reference's oracle checks
(tests/topo/test_topology.py): brute-force pair table, angle colvar, hydronium
top-K truncation and residence-time distance relaxation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cmdlmc_tpu.core.cell import Cell
from cmdlmc_tpu.rates.laws import Constant, Fermi, FermiAngle
from cmdlmc_tpu.topo.models import (
    AnglePairRates,
    Frame,
    HydroniumRates,
    PairRates,
    determine_groups,
)
from cmdlmc_tpu.topo.transforms import (
    DistanceInterpolator,
    InterpolatedTransformation,
    LinearTransformation,
    ReLUTransformation,
)


def frame_of(donors, extras=None, time=0.0, index=0):
    return Frame(
        donors=jnp.asarray(donors, jnp.float32),
        extras=None if extras is None else jnp.asarray(extras, jnp.float32),
        time=jnp.float32(time),
        index=jnp.int32(index),
    )


def test_pair_rates_reproduce_bruteforce_pair_table():
    """Reference hand-built table (test_topology.py:32-65): 5 atoms on a line in a
    10 A box, cutoff 2.0, buffer 0 — connections (0,1) d=1.5, (0,4) d=1.0,
    (1,2) d=1.5."""
    cell = Cell.cubic([10.0, 10.0, 10.0])
    pos = np.array(
        [[0.0, 0, 0], [1.5, 0, 0], [3.0, 0, 0], [6.0, 0, 0], [9.0, 0, 0]],
        dtype=np.float32,
    )
    model = PairRates(
        cell=cell, law=Constant(a=jnp.float32(1.0)), cutoff=jnp.float32(2.0),
        buffer=jnp.float32(0.0),
    )
    W = np.asarray(model.shared(frame_of(pos)).W)
    want_pairs = {(0, 1), (1, 0), (0, 4), (4, 0), (1, 2), (2, 1)}
    got_pairs = set(zip(*np.nonzero(W)))
    assert got_pairs == want_pairs


def test_pair_rates_match_python_oracle_on_random_walks():
    """Dense masked computation == O(N^2) python loop, over 10 random frames
    (the reference's Verlet==bruteforce equivalence recast: here there is one
    code path, so the oracle is plain python; test_topology.py:68-101)."""
    cell = Cell.cubic([10.0, 10.0, 10.0])
    law = Fermi(a=jnp.float32(1.0), b=jnp.float32(2.5), c=jnp.float32(0.3))
    cut, buf = 3.0, 1.0
    model = PairRates(
        cell=cell, law=law, cutoff=jnp.float32(cut), buffer=jnp.float32(buf)
    )
    rng = np.random.RandomState(0)
    pos = rng.uniform(0, 10, size=(7, 3))
    for _ in range(10):
        pos = pos + rng.normal(scale=1.0, size=pos.shape)
        W = np.asarray(model.shared(frame_of(pos.astype(np.float32))).W)
        for i in range(7):
            for j in range(7):
                d = pos[j] - pos[i]
                d -= 10.0 * np.round(d / 10.0)
                dist = np.linalg.norm(d)
                if i == j or dist > cut + buf:
                    assert W[i, j] == 0.0
                else:
                    want = 1.0 / (1.0 + np.exp((dist - 2.5) / 0.3))
                    assert W[i, j] == pytest.approx(want, rel=1e-4)


def test_determine_groups_assigns_each_donor_to_its_phosphorus():
    cell = Cell.cubic([20.0, 20.0, 20.0])
    # Two P atoms, each with 3 surrounding O atoms
    extras = np.array([[2.0, 2, 2], [12.0, 12, 12]], dtype=np.float32)
    donors = np.array(
        [
            [3.0, 2, 2], [2.0, 3, 2], [2.0, 2, 3],  # around P0
            [13.0, 12, 12], [12.0, 13, 12], [12.0, 12, 13],  # around P1
        ],
        dtype=np.float32,
    )
    o_to_p = np.asarray(determine_groups(cell, jnp.asarray(extras), jnp.asarray(donors), 3))
    np.testing.assert_array_equal(o_to_p, [0, 0, 0, 1, 1, 1])


def test_angle_rates_gate_by_poo_angle():
    """FermiAngle zeroes rates when the P-O-O angle at the donor is below theta.
    Geometry: P left of O0; O1 placed so that P-O0-O1 is ~180 deg (allowed),
    O2 placed so the angle is ~45 deg (blocked)."""
    cell = Cell.cubic([50.0, 50.0, 50.0])
    extras = np.array([[-1.5, 0, 0]], dtype=np.float32)
    # O1 opposite P (angle P-O0-O1 = 180 deg, allowed); O2 on P's side
    # (angle P-O0-O2 = 45 deg, below theta = 90 deg -> gated off).
    donors = np.array(
        [[0.0, 0, 0], [2.4, 0, 0], [-1.2, 1.2, 0]], dtype=np.float32
    )
    law = FermiAngle(
        a=jnp.float32(1.0), b=jnp.float32(10.0), c=jnp.float32(1.0),
        theta=jnp.float32(np.pi / 2),
    )
    model = AnglePairRates.from_first_frame(
        cell, law, cutoff=3.0, buffer=2.0,
        donors0=jnp.asarray(donors), extras0=jnp.asarray(extras), group_size=3,
    )
    W = np.asarray(model.shared(frame_of(donors, extras)).W)
    assert W[0, 1] > 0.0  # angle pi: allowed
    # P-O0-O2 angle is 45 deg < theta: gated off
    assert W[0, 2] == 0.0
    # but O2 -> O1 uses the angle at O2's vertex


def test_hydronium_topk_truncation_and_validity():
    cell = Cell.cubic([100.0, 100.0, 100.0])
    # 6 sites on a line: site 0 has neighbors at 2,4,6,8,10 A
    pos = np.array([[2.0 * i, 0, 0] for i in range(6)], dtype=np.float32)
    model = HydroniumRates(
        cell=cell,
        law=Constant(a=jnp.float32(1.0)),
        cutoff=jnp.float32(5.0),
        buffer=jnp.float32(0.0),
        transform=None,
        interpolator=None,
        k=4,
    )
    shared = model.shared(frame_of(pos))
    nbr = np.asarray(shared.nbr)
    valid = np.asarray(shared.valid)
    dist = np.asarray(shared.dist)
    # site 0: only sites 1 (2 A) and 2 (4 A) are inside cutoff -> 2 valid slots
    assert valid[0].sum() == 2
    assert set(nbr[0][valid[0]]) == {1, 2}
    # interior site 2: neighbors 1,3 (2 A) and 0,4 (4 A) -> 4 valid slots
    assert valid[2].sum() == 4
    assert set(nbr[2][valid[2]]) == {0, 1, 3, 4}
    np.testing.assert_allclose(np.sort(dist[2][valid[2]]), [2, 2, 4, 4], rtol=1e-5)


def test_hydronium_residence_time_blends_distances():
    """A freshly-jumped proton sees (nearly) neutral distances; a long-resident
    proton sees fully rescaled ones (topology.py:214-230, 337-353)."""
    cell = Cell.cubic([100.0, 100.0, 100.0])
    pos = np.array([[0.0, 0, 0], [2.6, 0, 0], [5.2, 0, 0]], dtype=np.float32)
    transform = LinearTransformation(
        a=jnp.float32(0.5), b=jnp.float32(0.5),
        left_bound=jnp.float32(0.0), right_bound=jnp.float32(10.0),
    )
    law = Fermi(a=jnp.float32(1.0), b=jnp.float32(2.2), c=jnp.float32(0.15))
    model = HydroniumRates(
        cell=cell, law=law, cutoff=jnp.float32(3.0), buffer=jnp.float32(0.0),
        transform=transform,
        interpolator=DistanceInterpolator(relaxation_time=jnp.float32(100.0)),
        k=4,
    )
    shared = model.shared(frame_of(pos))

    # residence 0 -> neutral distance 2.6 (low rate); residence >= relax ->
    # rescaled 0.5*2.6+0.5 = 1.8 (high rate); never jumped (-1) -> rescaled too.
    fresh = np.full(3, 0.0, np.float32)
    old = np.full(3, 1e4, np.float32)
    never = np.full(3, -1.0, np.float32)

    om_fresh, _, _ = model.replica_omega(shared, jnp.asarray(fresh))
    om_old, _, _ = model.replica_omega(shared, jnp.asarray(old))
    om_never, _, _ = model.replica_omega(shared, jnp.asarray(never))

    fermi = lambda d: 1.0 / (1.0 + np.exp((d - 2.2) / 0.15))
    assert np.asarray(om_fresh)[0].max() == pytest.approx(fermi(2.6), rel=1e-3)
    assert np.asarray(om_old)[0].max() == pytest.approx(fermi(1.8), rel=1e-3)
    np.testing.assert_allclose(np.asarray(om_never), np.asarray(om_old), rtol=1e-5)


def test_relu_transformation_matches_reference_formula():
    t = ReLUTransformation(
        a=jnp.float32(0.3), b=jnp.float32(2.2), d0=jnp.float32(2.4),
        left_bound=jnp.float32(2.0), right_bound=jnp.float32(3.0),
    )
    d = np.array([1.5, 2.1, 2.3, 2.7, 3.5], dtype=np.float32)
    got = np.asarray(t(jnp.asarray(d)))
    want = np.where(d < 2.4, 2.2, 0.3 * (d - 2.4) + 2.2)
    outside = (d <= 2.0) | (d >= 3.0)
    want[outside] = d[outside]
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_interpolated_transformation_clamp_semantics():
    x = np.linspace(2.0, 3.0, 11).astype(np.float32)
    y = (x * 0.5 + 0.3).astype(np.float32)
    t = InterpolatedTransformation(x=jnp.asarray(x), y=jnp.asarray(y))
    d = np.array([1.0, 2.0, 2.5, 3.0, 4.0], dtype=np.float32)
    got = np.asarray(t(jnp.asarray(d)))
    # below table -> y[0]; inside -> interpolated; above -> unchanged
    np.testing.assert_allclose(
        got, [y[0], y[0], 2.5 * 0.5 + 0.3, 3.0 * 0.5 + 0.3, 4.0], rtol=1e-5
    )
