"""PACO 1D / least-weight-subsequence (paper Sect. III-C, Theorem 6).

    D[j] = min_{0 <= i < j} ( D[i] + w(i, j) ),   D[0] given.

The recursion computes a triangle: solve the left half, apply the square
*external update* (all (i in left, j in right) pairs), solve the right half.
PACO's change is only to the square: split along the longer dimension by the
ratio floor(p'/2):ceil(p'/2), splitting the processor list identically, until
one processor per rectangle.  A cut on the input (y) axis requires a
temporary output vector and a min-merge (paper Fig. 6 lines 17-18).

A port of ``repro.core.onedim``; D is updated in place.  No kernel: the
base case is a host loop over elements, as in JAX.
"""
from __future__ import annotations

import dataclasses

import torch


def onedim_reference(w: torch.Tensor, d0: float = 0.0) -> torch.Tensor:
    """O(n^2) reference.  w is the (n+1, n+1) weight matrix w[i, j]."""
    n = w.shape[0] - 1
    big = torch.tensor(float("inf"), dtype=w.dtype, device=w.device)
    idx = torch.arange(n + 1, device=w.device)
    d = torch.full((n + 1,), float("inf"), dtype=w.dtype, device=w.device)
    d[0] = d0
    for j in range(1, n + 1):
        d[j] = torch.where(idx < j, d + w[:, j], big).min()
    return d


# ---------------------------------------------------------------------------
# PACO partition of a square external update
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Rect:
    """inputs [i0,i1) x outputs [j0,j1), owned by ``proc``."""

    i0: int
    i1: int
    j0: int
    j1: int
    proc: int

    def area(self) -> int:
        return (self.i1 - self.i0) * (self.j1 - self.j0)

    def half_perimeter(self) -> int:
        return (self.i1 - self.i0) + (self.j1 - self.j0)


def partition_square(i0: int, i1: int, j0: int, j1: int, procs: tuple[int, ...]
                     ) -> list[Rect]:
    """Paper's COP-1D square partitioning: cut the longer dim by
    floor(p/2):ceil(p/2); y-cuts (input axis) imply temp+merge downstream."""
    if len(procs) == 1:
        return [Rect(i0, i1, j0, j1, procs[0])]
    pl = len(procs) // 2
    pr = len(procs) - pl
    di, dj = i1 - i0, j1 - j0
    if di >= dj:  # cut inputs (y): both halves update same outputs => merge
        im = i0 + (di * pl) // (pl + pr)
        return (partition_square(i0, im, j0, j1, procs[:pl]) +
                partition_square(im, i1, j0, j1, procs[pl:]))
    jm = j0 + (dj * pl) // (pl + pr)
    return (partition_square(i0, i1, j0, jm, procs[:pl]) +
            partition_square(i0, i1, jm, j1, procs[pl:]))


def _external_update(d: torch.Tensor, w: torch.Tensor, i0: int, i1: int,
                     j0: int, j1: int, p: int) -> None:
    """D[j] = min(D[j], min_{i in [i0,i1)} D[i] + w[i,j]) for j in [j0,j1),
    tiled by the PACO plan (merge = min over tiles).  Inputs and outputs
    are disjoint ranges, so updating D in place reads no updated input."""
    for r in partition_square(i0, i1, j0, j1, tuple(range(p))):
        if r.area() == 0:
            continue
        blk = d[r.i0:r.i1, None] + w[r.i0:r.i1, r.j0:r.j1]
        upd = blk.min(dim=0).values  # temp vector for this rect
        torch.minimum(d[r.j0:r.j1], upd, out=d[r.j0:r.j1])  # min-merge


def paco_onedim(w: torch.Tensor, p: int, d0: float = 0.0, *,
                base: int = 4) -> torch.Tensor:
    """PACO 1D: recursive triangle with PACO-partitioned square updates."""
    n = w.shape[0] - 1
    d = torch.full((n + 1,), float("inf"), dtype=w.dtype, device=w.device)
    d[0] = d0

    def seq_base(lo: int, hi: int) -> None:
        # D[lo] is final on entry; finalize D[lo+1 .. hi-1].
        for j in range(lo + 1, hi):
            d[j] = torch.minimum(d[j], (d[lo:j] + w[lo:j, j]).min())

    def tri(lo: int, hi: int) -> None:
        # solves D[lo+1..hi) given D[lo] and any external updates already
        # applied from inputs < lo.
        if hi - lo <= base:
            seq_base(lo, hi)
            return
        mid = (lo + hi) // 2
        tri(lo, mid)                                # (0,0) triangle
        _external_update(d, w, lo, mid, mid, hi, p)  # (0,1) square
        tri(mid, hi)                                # (1,1) triangle

    tri(0, n + 1)
    return d
