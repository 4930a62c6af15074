"""Unit tests for all jump-rate laws against closed-form expectations."""

import jax.numpy as jnp
import numpy as np
import pytest

from cmdlmc_tpu.rates.laws import (
    KB_EV_PER_K,
    ActivationEnergy,
    Constant,
    Exponential,
    Fermi,
    FermiAngle,
)


def test_fermi_closed_form():
    law = Fermi(a=jnp.float32(0.06), b=jnp.float32(2.4), c=jnp.float32(0.15))
    d = np.array([2.0, 2.4, 2.8], dtype=np.float32)
    want = 0.06 / (1 + np.exp((d - 2.4) / 0.15))
    np.testing.assert_allclose(np.asarray(law(jnp.asarray(d))), want, rtol=1e-5)
    # midpoint = a/2
    assert float(law(jnp.float32(2.4))) == pytest.approx(0.03, rel=1e-5)


def test_fermi_angle_gates():
    law = FermiAngle(
        a=jnp.float32(1.0), b=jnp.float32(2.4), c=jnp.float32(0.15),
        theta=jnp.float32(1.5),
    )
    d = jnp.full((4,), 2.0)
    ang = jnp.asarray([0.5, 1.4, 1.6, 3.0])
    got = np.asarray(law(d, ang))
    assert got[0] == 0 and got[1] == 0
    assert got[2] > 0 and got[3] > 0


def test_exponential_law():
    law = Exponential(a=jnp.float32(0.01), b=jnp.float32(-2.0))
    d = np.array([1.0, 2.0], dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(law(jnp.asarray(d))), 0.01 * np.exp(-2.0 * d), rtol=1e-5
    )


def test_activation_energy_law():
    """AE/Arrhenius: omega = A exp(-E(d)/kT), E(d) = a(d-d0)/sqrt(b+1/(d-d0)^2)
    (reference config help, IO/config_parser.py:330-346)."""
    A, a, b, d0, T = 1.0e2, 0.5, 0.3, 2.2, 300.0
    law = ActivationEnergy(
        A=jnp.float32(A), a=jnp.float32(a), b=jnp.float32(b),
        d0=jnp.float32(d0), T=jnp.float32(T),
    )
    d = np.array([2.4, 2.8, 3.2], dtype=np.float32)
    dd = d - d0
    energy = np.maximum(a * dd / np.sqrt(b + 1.0 / dd**2), 0.0)
    want = A * np.exp(-energy / (KB_EV_PER_K * T))
    np.testing.assert_allclose(np.asarray(law(jnp.asarray(d))), want, rtol=1e-4)

    # rates decrease with distance (larger barrier) above d0
    vals = np.asarray(law(jnp.asarray(np.linspace(2.3, 3.5, 10, dtype=np.float32))))
    assert np.all(np.diff(vals) < 0)
    # at d == d0 the energy is zero -> rate == A
    assert float(law(jnp.float32(d0))) == pytest.approx(A, rel=1e-4)
    # hotter temperature -> faster rates at fixed distance
    hot = ActivationEnergy(
        A=jnp.float32(A), a=jnp.float32(a), b=jnp.float32(b),
        d0=jnp.float32(d0), T=jnp.float32(600.0),
    )
    assert float(hot(jnp.float32(3.0))) > float(law(jnp.float32(3.0)))


def test_constant_law_broadcasts():
    law = Constant(a=jnp.float32(0.5))
    got = np.asarray(law(jnp.zeros((3, 4))))
    np.testing.assert_array_equal(got, np.full((3, 4), 0.5))


def test_solid_acid_model_api():
    """Programmatic model-family API advances and exposes observables."""
    import jax

    from cmdlmc_tpu.models.solid_acid import SolidAcidModel
    from cmdlmc_tpu import observables as obs

    rng = np.random.RandomState(0)
    donors = rng.uniform(0, 10, size=(16, 3)).astype(np.float32)
    model = SolidAcidModel.create(
        box=[10, 10, 10], first_frame_donors=donors, n_protons=6,
        fermi_a=0.08, fermi_b=3.0, fermi_c=0.4, dt=0.5, n_replicas=8,
        cutoff=4.0, buffer=1.0, seed=2,
    )
    block = np.broadcast_to(donors, (100, 16, 3))
    rows = model.advance(block, 0, emit_every=50)
    assert rows is not None
    msd = obs.mean_square_displacement(model.ensemble)
    assert msd.shape == (8, 3)
    moments = obs.displacement_moments(model.ensemble)
    assert set(moments) == {2, 4}
    assert np.all(np.asarray(moments[4]) >= 0)


def test_solid_acid_angle_model_forwards_extras():
    """An angle-gated model must forward the extra-atom block to the engine
    (the P-O-O angle needs the P positions of every frame)."""
    import numpy as np

    from cmdlmc_tpu.models.solid_acid import SolidAcidModel

    rng = np.random.RandomState(0)
    donors = rng.uniform(0, 9, size=(12, 3)).astype(np.float32)
    extras = rng.uniform(0, 9, size=(4, 3)).astype(np.float32)
    model = SolidAcidModel.create(
        box=[9.0, 9.0, 9.0], first_frame_donors=donors, n_protons=4,
        fermi_a=0.1, fermi_b=2.5, fermi_c=0.3, dt=0.5, n_replicas=8,
        angle_theta=1.2, first_frame_extras=extras, group_size=3,
    )
    F = 6
    dblock = donors[None] + rng.normal(scale=0.02, size=(F, 12, 3)).astype(np.float32)
    eblock = extras[None] + rng.normal(scale=0.02, size=(F, 4, 3)).astype(np.float32)
    rows = model.advance(dblock, 0, extras=eblock)
    assert np.all(np.isfinite(np.asarray(rows.msd_mean)))
    occ = np.asarray(model.ensemble.replicas.occ)
    np.testing.assert_allclose(occ.sum(axis=1), 4, atol=1e-5)
