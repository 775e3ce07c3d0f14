"""Statistics used by the paper's evaluation (§5.1): Mann-Whitney U test and
Cohen's d effect size (``repro.utils.stats`` counterpart, in numpy float64
with the same tie and continuity corrections; no scipy is needed).

The paper runs each app 20 times, tests *after2* vs *before* with
Mann-Whitney U (p < 0.05) and reports Cohen's d (0.2 small / 0.5 medium /
0.8 large).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks (1-based) with ties, like scipy.stats.rankdata."""
    sorter = np.argsort(x, kind="mergesort")
    inv = np.empty_like(sorter)
    inv[sorter] = np.arange(len(x))
    xs = x[sorter]
    # tie groups
    obs = np.r_[True, xs[1:] != xs[:-1]]
    dense = obs.cumsum()[inv]
    # cumulative counts per group
    counts = np.r_[np.nonzero(obs)[0], len(obs)]
    return 0.5 * (counts[dense] + counts[dense - 1] + 1)


def mann_whitney_u(a, b) -> tuple[float, float]:
    """Two-sided Mann-Whitney U test with normal approximation + tie
    correction. Returns ``(U, p_value)``.

    Suitable for the paper's n=20 samples; the normal approximation is the
    standard choice for n1, n2 >= 8.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n1, n2 = len(a), len(b)
    if n1 == 0 or n2 == 0:
        raise ValueError("empty sample")
    ranks = _rankdata(np.concatenate([a, b]))
    r1 = ranks[:n1].sum()
    u1 = r1 - n1 * (n1 + 1) / 2.0
    u2 = n1 * n2 - u1
    u = min(u1, u2)
    mu = n1 * n2 / 2.0
    # tie correction for variance
    n = n1 + n2
    _, counts = np.unique(np.concatenate([a, b]), return_counts=True)
    tie_term = ((counts**3 - counts).sum()) / (n * (n - 1)) if n > 1 else 0.0
    sigma2 = n1 * n2 / 12.0 * ((n + 1) - tie_term)
    if sigma2 <= 0:
        return u, 1.0
    z = (u - mu + 0.5) / math.sqrt(sigma2)  # continuity correction
    p = 2.0 * 0.5 * math.erfc(abs(z) / math.sqrt(2.0))
    return u, min(1.0, p)


def cohens_d(a, b) -> float:
    """Cohen's d with pooled standard deviation (paper §5.1)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n1, n2 = len(a), len(b)
    va, vb = a.var(ddof=1), b.var(ddof=1)
    pooled = ((n1 - 1) * va + (n2 - 1) * vb) / max(n1 + n2 - 2, 1)
    if pooled == 0:
        return 0.0 if a.mean() == b.mean() else float("inf")
    return abs(a.mean() - b.mean()) / math.sqrt(pooled)


@dataclass
class Comparison:
    """before-vs-after comparison in the paper's reporting format."""

    name: str
    before_mean: float
    after_mean: float
    reduction_pct: float
    u_stat: float
    p_value: float
    effect_size: float

    @property
    def significant(self) -> bool:
        return self.p_value < 0.05

    @property
    def effect_label(self) -> str:
        d = self.effect_size
        if d >= 0.8:
            return "large"
        if d >= 0.5:
            return "medium"
        if d >= 0.2:
            return "small"
        return "negligible"


def compare(name: str, before, after) -> Comparison:
    before = np.asarray(before, dtype=np.float64)
    after = np.asarray(after, dtype=np.float64)
    u, p = mann_whitney_u(before, after)
    d = cohens_d(before, after)
    bm, am = float(before.mean()), float(after.mean())
    red = 100.0 * (bm - am) / bm if bm else 0.0
    return Comparison(name, bm, am, red, u, p, d)
