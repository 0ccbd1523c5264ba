"""PACO sample sort (paper Sect. III-G, Theorem 16), on one device.

Steps (exactly the paper's):
  1. pick k*p samples uniformly at random (oversampling k = O(log n)),
     sort them, take every k-th as the p-1 pivots;
  2. every processor partitions its n/p slice into p chunks by the pivots;
     the p x p count matrix, its prefix sums and the all-to-all
     redistribution together are a stable counting sort of the elements
     by bucket;
  3. each processor sorts its received bucket locally.

A port of ``repro.core.sort.paco_sort`` (the plan-faithful execution for
an arbitrary p); a ``torch.Generator`` takes the place of the JAX key, so
the samples differ from JAX's for the same seed.  The SPMD version
(``paco_sort_shmap``) is not ported yet.
"""
from __future__ import annotations

import math

import torch


def choose_pivots(x: torch.Tensor, p: int, generator: torch.Generator,
                  oversample: int | None = None) -> torch.Tensor:
    """Step 1: p-1 pivots via k*p random samples (k = O(log n); 4 ln n, as
    ``repro``, keeps the largest bucket under ~1.3x the mean).  The
    generator must live on x's device."""
    n = x.shape[0]
    k = oversample or max(2, int(4 * math.log(max(n, 2))))
    idx = torch.randint(0, n, (k * p,), generator=generator, device=x.device)
    samples = torch.sort(x[idx]).values
    return samples[k::k][: p - 1]


def sort_by_pivots(x: torch.Tensor, pivots: torch.Tensor, p: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Steps 2-3 for given pivots: (sorted x, bucket sizes (p,) int64).
    bucket_sizes[i] is the number of elements processor i sorts."""
    bucket = torch.searchsorted(pivots.contiguous(), x)  # in [0, p)
    sizes = torch.bincount(bucket, minlength=p)
    redistributed = x[torch.argsort(bucket, stable=True)]
    offs = [0] + torch.cumsum(sizes, 0).tolist()
    parts = [torch.sort(redistributed[offs[i]:offs[i + 1]]).values
             for i in range(p)]
    return (torch.cat(parts) if parts else redistributed), sizes


def paco_sort(x: torch.Tensor, p: int, generator: torch.Generator,
              oversample: int | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plan-faithful PACO sample sort for arbitrary p.

    Returns (sorted_array, bucket_sizes).  Theorem 16: max(bucket_sizes)
    <= (1+eps) n/p w.h.p."""
    return sort_by_pivots(x, choose_pivots(x, p, generator, oversample), p)
