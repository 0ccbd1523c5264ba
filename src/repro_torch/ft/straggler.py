"""Per-host throughput estimate for straggler mitigation (a copy of
``ThroughputTracker`` from ``repro.ft.straggler``; the HETERO rebalancing
that reads it is not ported yet).

Hosts report per-step wall times; an EMA of their rates relative to the
slowest host estimates each host's throughput."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ThroughputTracker:
    n_hosts: int
    ema: float = 0.5
    _rate: np.ndarray | None = None

    def update(self, step_times: np.ndarray) -> np.ndarray:
        """step_times (n_hosts,) seconds for the same workload."""
        rate = 1.0 / np.maximum(np.asarray(step_times, np.float64), 1e-9)
        rate = rate / rate.min()
        if self._rate is None:
            self._rate = rate
        else:
            self._rate = self.ema * self._rate + (1 - self.ema) * rate
        return self._rate

    @property
    def throughputs(self) -> np.ndarray:
        if self._rate is None:
            return np.ones(self.n_hosts)
        return self._rate
