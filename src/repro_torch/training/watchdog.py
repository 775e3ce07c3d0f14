"""Straggler watchdog: per-step wall-time anomaly detection
(``repro.training.watchdog`` counterpart).

An EWMA estimate of the step time's mean and variance flags steps whose
z-score exceeds a threshold; the training loop logs the flags and goes on
(policy ``skip-log``), or the watchdog raises (policy ``abort``) so the
outer launcher can reschedule the job.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class StragglerWatchdog:
    z_threshold: float = 4.0
    ewma_alpha: float = 0.05
    warmup_steps: int = 5
    policy: str = "skip-log"  # skip-log | abort

    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    flagged: list = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        """Record a step time; returns True if the step was flagged."""
        self._n += 1
        if self._n <= self.warmup_steps:
            # bootstrap the estimate
            if self._n == 1:
                self._mean = dt
                self._var = (0.5 * dt) ** 2
            else:
                a = 1.0 / self._n
                self._var = (1 - a) * self._var + a * (dt - self._mean) ** 2
                self._mean = (1 - a) * self._mean + a * dt
            return False
        std = math.sqrt(max(self._var, 1e-18))
        z = (dt - self._mean) / std
        flag = z > self.z_threshold
        if flag:
            self.flagged.append((step, dt, z))
            if self.policy == "abort":
                raise RuntimeError(
                    f"straggler watchdog: step {step} took {dt:.3f}s "
                    f"(z={z:.1f} > {self.z_threshold}); aborting for reschedule"
                )
        else:
            # only unflagged steps update the estimate (a straggler must not
            # poison its own detector)
            a = self.ewma_alpha
            self._var = (1 - a) * self._var + a * (dt - self._mean) ** 2
            self._mean = (1 - a) * self._mean + a * dt
        return flag

    @property
    def mean_step_s(self) -> float:
        return self._mean
