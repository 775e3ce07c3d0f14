"""The paper's statistics (§5.1) in the port (``repro_torch.utils.stats``)
against the reference's (``repro.utils.stats``): Mann-Whitney U with its tie
and continuity corrections, Cohen's d and ``compare``, on seeded numpy
samples, to 1e-12; and the port's own copies of the reference's checks
(``tests/test_substrates.py``, paper statistics)."""

import math

import numpy as np
import pytest

from repro.utils import stats as ref
from repro_torch.utils import stats as port

TOL = 1e-12


def _samples():
    rs = np.random.RandomState(7)
    base = rs.randn(20)
    return {
        "n20": (rs.randn(20) * 0.3 + 1.0, rs.randn(20) * 0.3 + 0.8),  # the paper's 20 runs per app
        "heavy_ties": (rs.randint(0, 4, 30).astype(float), rs.randint(1, 5, 25).astype(float)),
        "identical": (base, base.copy()),
        "separated": (np.arange(20, dtype=float), np.arange(20, dtype=float) + 100),
        "unequal_sizes": (rs.exponential(2.0, 9), rs.exponential(3.0, 31)),
        "one_each": (np.array([1.0]), np.array([2.0])),
    }


@pytest.mark.parametrize("case", list(_samples()))
def test_stats_equal_the_reference(case):
    a, b = _samples()[case]
    assert np.array_equal(port._rankdata(np.concatenate([a, b])), ref._rankdata(np.concatenate([a, b])))
    (pu, pp), (ru, rp) = port.mann_whitney_u(a, b), ref.mann_whitney_u(a, b)
    assert abs(pu - ru) <= TOL and abs(pp - rp) <= TOL
    pd, rd = port.cohens_d(a, b), ref.cohens_d(a, b)
    assert (math.isnan(pd) and math.isnan(rd)) or pd == rd or abs(pd - rd) <= TOL
    pc, rc = port.compare(case, a, b), ref.compare(case, a, b)
    for f in ("before_mean", "after_mean", "reduction_pct", "u_stat", "p_value"):
        assert abs(getattr(pc, f) - getattr(rc, f)) <= TOL, f
    assert (pc.significant, pc.effect_label) == (rc.significant, rc.effect_label)


def test_stats_cases_cover_what_they_name():
    s = _samples()
    assert port.mann_whitney_u(*s["separated"])[1] < 1e-6
    assert port.mann_whitney_u(*s["identical"])[1] > 0.9
    a, b = s["heavy_ties"]
    assert len(np.unique(np.concatenate([a, b]))) <= 5  # nearly every rank is tied
    assert port.cohens_d(*s["identical"]) == 0.0


@pytest.mark.parametrize("pkg", [port, ref], ids=["port", "reference"])
def test_empty_sample_raises(pkg):
    with pytest.raises(ValueError, match="empty sample"):
        pkg.mann_whitney_u([], [1.0, 2.0])
    with pytest.raises(ValueError, match="empty sample"):
        pkg.compare("x", [1.0, 2.0], [])


def test_mann_whitney_separated_samples():
    u, p = port.mann_whitney_u(np.arange(20, dtype=float), np.arange(20, dtype=float) + 100)
    assert p < 1e-6


def test_mann_whitney_identical_samples():
    a = np.random.RandomState(0).randn(20)
    u, p = port.mann_whitney_u(a, a.copy())
    assert p > 0.9


def test_cohens_d_magnitudes():
    rs = np.random.RandomState(1)
    a = rs.randn(200)
    assert abs(port.cohens_d(a, a + 0.8)) > 0.7  # large effect
    assert abs(port.cohens_d(a, a + 0.01)) < 0.1  # negligible
