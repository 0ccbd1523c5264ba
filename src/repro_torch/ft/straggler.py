"""Straggler mitigation by the paper's HETERO partitioning (Sect. IV-A),
a copy of ``repro.ft.straggler``.

Hosts report per-step wall times; an EMA of their rates relative to the
slowest host estimates each host's throughput (``ThroughputTracker``).
The HETERO cut tree re-splits the data-parallel batch
(``rebalance_batch``) and, for tensor parallelism, the weight cuboids
(``hetero_tp_plan``) in proportion, so a 2x-slow host gets half the rows
instead of stalling every synchronous step."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cuboid import plan_hetero


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


def rebalance_batch(throughputs: np.ndarray, global_batch: int,
                    *, quantum: int = 1) -> list[int]:
    """Per-host batch sizes proportional to throughput (sum preserved).
    Largest-remainder rounding in units of ``quantum`` sequences."""
    t = np.asarray(throughputs, np.float64)
    frac = t / t.sum() * (global_batch / quantum)
    base = np.floor(frac).astype(int)
    rem = global_batch // quantum - base.sum()
    order = np.argsort(-(frac - base))
    base[order[:rem]] += 1
    return [int(b) * quantum for b in base]


def straggler_speedup(throughputs: np.ndarray) -> tuple[float, float]:
    """(synchronous-even time, hetero-balanced time) per unit work.  Even
    split: the slowest host gates the step (1/min rate per 1/p work).
    HETERO split: all hosts finish together (1/sum rate)."""
    t = np.asarray(throughputs, np.float64)
    p = len(t)
    even = (1.0 / p) / t.min()
    hetero = 1.0 / t.sum()
    return even, hetero


def hetero_tp_plan(n: int, m: int, k: int, throughputs: np.ndarray):
    """Throughput-proportional TP tiling for a weight cuboid (paper
    IV-A)."""
    return plan_hetero(n, m, k, list(map(float, throughputs)))
