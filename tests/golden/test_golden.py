"""Golden-data regression: the five BASELINE.json configurations, re-run with
the committed seeds, must reproduce the frozen curves (tools/make_golden.py).

Because every draw is keyed by event ordinal, a same-seed rerun is
deterministic up to float32 round-off — so the tolerances are tight and ANY
change to engine semantics (selection, clock, MSD bookkeeping, histograms)
fails here. Regenerate deliberately with tools/make_golden.py when semantics
are *intended* to change, and say so in the commit."""

import os
import sys

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # full driver re-runs of all 5 frozen scenarios

sys.path.insert(0, os.path.dirname(__file__))

import scenarios  # noqa: E402

GOLDEN_DIR = os.path.dirname(__file__)


@pytest.mark.parametrize("name", sorted(scenarios.SCENARIOS))
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden file missing — run tools/make_golden.py {name}")
    with np.load(path) as f:
        want = {k: f[k] for k in f.files}
    got = scenarios.run_scenario(name)
    assert set(got) == set(want)
    for key in sorted(want):
        w, g = want[key], got[key]
        assert g.shape == w.shape, (name, key, g.shape, w.shape)
        # float32 accumulation round-off only; anything larger is an engine
        # semantics change
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(
            g, w, rtol=2e-4, atol=2e-4 * scale,
            err_msg=f"{name}:{key} drifted from golden data",
        )


def test_golden_detects_perturbation(monkeypatch):
    """The regression must actually have teeth: any engine/seed perturbation
    produces curves outside the tolerance."""
    name = "config2_fermi_single"
    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    if not os.path.exists(path):
        pytest.skip("golden file missing")
    monkeypatch.setattr(
        scenarios, "_INI", scenarios._INI.replace("seed = 17", "seed = 18")
    )
    got = scenarios.run_scenario(name)
    with np.load(path) as f:
        want_msd = f["msd"]
    assert not np.allclose(got["msd"], want_msd, rtol=2e-4, atol=2e-4)
