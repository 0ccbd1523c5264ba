"""PACO LCS (paper Sect. III-B, Theorem 2).

Two phases, exactly as the paper:
  1. *Partition*: recursive 2-way division of the 2-D DP table; as soon as
     an anti-diagonal holds >= p sub-regions they are assigned round-robin
     (labels in Fig. 3); division stops on assigned regions.
  2. *Execute*: sub-regions run anti-diagonal by anti-diagonal (a
     wavefront); each sub-region runs the sequential LCS; dependencies are
     only on the two neighbouring regions, so no global barrier.

The row recurrence X[i,j] = max(X[i-1,j], X[i-1,j-1]+eq, X[i,j-1]) is
monotone in j, so a row update is a running max: X[i,:] = cummax(a) with
a_j = max(X[i-1,j], X[i-1,j-1]+eq_ij).

A port of ``repro.core.lcs``.  ``paco_lcs`` runs the whole tiled table
through one launch of the tile kernel on a CUDA tensor
(``kernels.lcs.ops.lcs_wavefront``: tiles claimed in anti-diagonal order,
each waiting only for its two neighbours), and through the kernel's plain
version on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.lcs.ops import lcs_wavefront


# ---------------------------------------------------------------------------
# Sequential reference (Lemma 1's CO-LCS semantics)
# ---------------------------------------------------------------------------

def lcs_reference(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Length (0-d int32) of the LCS of integer sequences s (m,) and t (n,):
    the plain row scan."""
    n = t.shape[0]
    prev = torch.zeros((n,), dtype=torch.int32, device=t.device)
    zero = prev[:1]
    for si in s:
        eq = (t == si).to(torch.int32)
        diag = torch.cat([zero, prev[:-1]])
        prev = torch.cummax(torch.maximum(prev, diag + eq), dim=0).values
    return prev[-1]


def lcs_tile(s_tile: torch.Tensor, t_tile: torch.Tensor, top: torch.Tensor,
             left: torch.Tensor, corner: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sequential LCS over one tile given its borders.

    top:    X[i0-1, j0:j1]  (len tn)
    left:   X[i0:i1, j0-1]  (len tm)
    corner: X[i0-1, j0-1]   (0-d)
    Returns (bottom_row, right_col, bottom-right value)."""
    prev, prev_corner = top, corner.reshape(1)
    right = []
    for si, li in zip(s_tile, left):
        eq = (t_tile == si).to(prev.dtype)
        diag = torch.cat([prev_corner, prev[:-1]])
        a = torch.maximum(prev, diag + eq)
        a[0] = torch.maximum(a[0], li)  # left border feeds the running max
        cur = torch.cummax(torch.clamp(a, min=0), dim=0).values
        cur = torch.maximum(cur, li)    # monotone row: left lower-bounds
        right.append(cur[-1])
        prev, prev_corner = cur, li.reshape(1)
    return prev, torch.stack(right), prev[-1]


# ---------------------------------------------------------------------------
# Phase 1: partition plan (Fig. 3)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Region:
    i0: int
    i1: int
    j0: int
    j1: int
    label: int  # assignment order (1 = first assigned)
    proc: int

    def area(self) -> int:
        return (self.i1 - self.i0) * (self.j1 - self.j0)

    def half_perimeter(self) -> int:
        return (self.i1 - self.i0) + (self.j1 - self.j0)

    def antidiag(self) -> int:
        # center-coordinate anti-diagonal id (paper: i+j of the center)
        return (self.i0 + self.i1) + (self.j0 + self.j1)


@dataclasses.dataclass(frozen=True)
class LCSPlan:
    n: int
    p: int
    regions: tuple[Region, ...]

    def partition_overhead(self) -> int:
        """Number of generated leaves: Corollary 3 bounds this by O(p^2 n)."""
        return len(self.regions)


def partition_lcs(n: int, p: int, *, base: int = 8) -> LCSPlan:
    """Recursive divide-and-assign of the n x n table (paper Fig. 3)."""
    regions: list[Region] = []
    label = 1
    rr = 0
    # Division round by division round: the unassigned regions form a grid
    # of blocks; divide until an anti-diagonal has >= p blocks, assign a
    # multiple of p of them, and keep dividing the remainder.
    unassigned: list[tuple[int, int, int, int]] = [(0, n, 0, n)]
    rounds = 0
    while unassigned:
        sizes = [(i1 - i0) for (i0, i1, _, _) in unassigned]
        is_base_round = max(sizes) <= base
        by_diag: dict[int, list[tuple[int, int, int, int]]] = {}
        for r in unassigned:
            d = (r[0] + r[1]) + (r[2] + r[3])
            by_diag.setdefault(d, []).append(r)
        next_unassigned: list[tuple[int, int, int, int]] = []
        assigned_any = False
        for d in sorted(by_diag):
            group = by_diag[d]
            if len(group) >= p or is_base_round:
                take = group if is_base_round else group[:len(group) // p * p]
                rest = [] if is_base_round else group[len(take):]
                for (i0, i1, j0, j1) in take:
                    regions.append(Region(i0, i1, j0, j1, label, rr % p))
                    rr += 1
                assigned_any = assigned_any or bool(take)
                next_unassigned.extend(rest)
            else:
                next_unassigned.extend(group)
        if assigned_any:
            label += 1
        # 2-way division (a quad split: one round on i then one on j)
        divided: list[tuple[int, int, int, int]] = []
        for (i0, i1, j0, j1) in next_unassigned:
            if (i1 - i0) <= base:
                divided.append((i0, i1, j0, j1))
                continue
            im = (i0 + i1) // 2
            jm = (j0 + j1) // 2
            divided.extend([(i0, im, j0, jm), (i0, im, jm, j1),
                            (im, i1, j0, jm), (im, i1, jm, j1)])
        if not assigned_any and divided == unassigned:
            # nothing assignable and nothing divisible => flush as base
            for (i0, i1, j0, j1) in divided:
                regions.append(Region(i0, i1, j0, j1, label, rr % p))
                rr += 1
            divided = []
        unassigned = divided
        rounds += 1
        if rounds > 64:
            raise RuntimeError("partition_lcs failed to converge")
    return LCSPlan(n=n, p=p, regions=tuple(regions))


# ---------------------------------------------------------------------------
# Phase 2: wavefront execution over uniform tiles
# ---------------------------------------------------------------------------

def paco_lcs(s: torch.Tensor, t: torch.Tensor, p: int, *,
             tile: int | None = None) -> torch.Tensor:
    """PACO LCS (0-d int32): tiled wavefront execution.

    Tile size follows the first-assignment rule: the first anti-diagonal
    with >= p tiles fixes the granularity (m / 2^ceil(log2 p) when
    uniform).  Tiles on one anti-diagonal are mutually independent (run on
    p processors; here the whole table is one launch); borders flow to the
    right and bottom neighbours only."""
    return lcs_wavefront(s, t, p, tile=tile)
