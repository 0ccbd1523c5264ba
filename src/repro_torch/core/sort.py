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
the samples differ from JAX's for the same seed.  ``paco_sort_shmap`` is
the SPMD version over one axis of a ``DeviceMesh``: fixed bucket capacity,
``all_to_all_single``.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist


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


# ---------------------------------------------------------------------------
# SPMD version (fixed capacity, all_to_all)
# ---------------------------------------------------------------------------

def bucket_send_buffer(xs: torch.Tensor, pivots: torch.Tensor, p: int,
                       cap: int) -> torch.Tensor:
    """One rank's (p, cap) send buffer: its elements bucketed by the
    pivots, in stable order within a bucket, padded with +inf.  Elements
    ranked at or past ``cap`` in their bucket go to a dump column, so they
    drop without overwriting the element in slot cap - 1."""
    bucket = torch.searchsorted(pivots.contiguous(), xs)      # in [0, p)
    order = torch.argsort(bucket, stable=True)
    xs_s, b_s = xs[order], bucket[order]
    counts = torch.bincount(b_s, minlength=p)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(xs.shape[0], device=xs.device) - starts[b_s]
    ok = rank < cap
    send = torch.full((p, cap + 1), math.inf, dtype=xs.dtype,
                      device=xs.device)
    send[b_s, torch.where(ok, rank, cap)] = torch.where(
        ok, xs_s, math.inf)
    return send[:, :cap].contiguous()


def paco_sort_shmap(x: torch.Tensor, mesh: Any, axis: str,
                    generator: torch.Generator, *,
                    capacity_factor: float = 4.0,
                    oversample: int | None = None) -> tuple[Any, Any]:
    """SPMD sample sort over the mesh axis ``axis``.

    Every rank holds the full x (alike on every rank, as is the
    generator's seed) and keeps its length-(n/p) slice; buckets are padded
    to a fixed capacity C = ceil(capacity_factor * n / p^2) per (src, dst)
    pair, exchanged with ``all_to_all_single`` and sorted locally with
    +inf padding pushed to the tail.  Returns (values, valid) as DTensors
    cut over ``axis``: ``values`` is globally sorted once the padding
    (``~valid``) is dropped."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.act_sharding import placements

    p = mesh.size(mesh.mesh_dim_names.index(axis))
    n = x.shape[0]
    per = n // p
    if per * p != n:
        raise ValueError("n must divide p for the SPMD path (pad upstream)")
    cap = int(math.ceil(capacity_factor * per / p))
    pivots = choose_pivots(x, p, generator, oversample)   # alike on all
    me = mesh.get_local_rank(axis)
    send = bucket_send_buffer(x[me * per:(me + 1) * per], pivots, p, cap)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.get_group(axis))
    merged = torch.sort(recv.reshape(-1)).values          # +inf tail
    place = placements(mesh, (axis,))
    return (DTensor.from_local(merged, mesh, place, run_check=False),
            DTensor.from_local(merged != math.inf, mesh, place,
                               run_check=False))
