"""PACO matrix-multiplication cut trees: the 1-PIECE planner.

A copy of the part of ``repro.core.cuboid`` that the port plans with
(``serve.paging.paco_page_size``): the cuboid n x m x k of a rectangular
matmul C[n,m] += A[n,k] @ B[k,m], and ``plan_mm_1piece`` (the paper's
Corollary 10), which cuts the longest dimension recursively by
floor(p/2):ceil(p/2) until each of p processors holds one cuboid.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Cuboid:
    """Half-open box [n0,n1) x [m0,m1) x [k0,k1) of the iteration space."""

    n0: int
    n1: int
    m0: int
    m1: int
    k0: int
    k1: int

    @property
    def n(self) -> int:
        return self.n1 - self.n0

    @property
    def m(self) -> int:
        return self.m1 - self.m0

    @property
    def k(self) -> int:
        return self.k1 - self.k0

    def longest_dim(self) -> str:
        # Tie-break n > m > k: prefer output cuts (no reduction needed).
        dims = {"n": self.n, "m": self.m, "k": self.k}
        return max(dims, key=lambda d: (dims[d], {"n": 2, "m": 1, "k": 0}[d]))

    def split(self, dim: str, left_frac_num: int, left_frac_den: int
              ) -> tuple["Cuboid", "Cuboid"]:
        """Cut ``dim`` at floor(extent * num/den); returns (left, right)."""
        if dim == "n":
            cut = self.n0 + (self.n * left_frac_num) // left_frac_den
            return (dataclasses.replace(self, n1=cut),
                    dataclasses.replace(self, n0=cut))
        if dim == "m":
            cut = self.m0 + (self.m * left_frac_num) // left_frac_den
            return (dataclasses.replace(self, m1=cut),
                    dataclasses.replace(self, m0=cut))
        if dim == "k":
            cut = self.k0 + (self.k * left_frac_num) // left_frac_den
            return (dataclasses.replace(self, k1=cut),
                    dataclasses.replace(self, k0=cut))
        raise ValueError(dim)


@dataclasses.dataclass(frozen=True)
class Cut:
    """One internal node of the cut tree."""

    dim: str              # "n" | "m" | "k"
    procs: tuple[int, ...]  # processor list at this node
    depth: int


@dataclasses.dataclass(frozen=True)
class MMPlan:
    """Output of the planner: one tile per processor + the cut schedule."""

    n: int
    m: int
    k: int
    p: int
    tiles: tuple[tuple[int, Cuboid], ...]  # (proc_id, cuboid)
    cuts: tuple[Cut, ...]
    kind: str


def plan_mm_1piece(n: int, m: int, k: int, p: int) -> MMPlan:
    """Recursive cut on the longest dim by floor(p'/2):ceil(p'/2), splitting
    the processor list by the same ratio, until one processor per cuboid.

    To follow the paper's analysis exactly, the *choice of dimension* at each
    level follows the virtual cuboid (even halving, p rounded up to a power
    of two); the *real* cuboid is cut by the uneven processor ratio."""
    tiles: list[tuple[int, Cuboid]] = []
    cuts: list[Cut] = []

    def rec(real: Cuboid, virt: Cuboid, procs: tuple[int, ...], depth: int):
        if len(procs) == 1:
            tiles.append((procs[0], real))
            return
        pl = len(procs) // 2
        pr = len(procs) - pl
        dim = virt.longest_dim()
        cuts.append(Cut(dim=dim, procs=procs, depth=depth))
        rl, rr = real.split(dim, pl, pl + pr)
        vl, vr = virt.split(dim, 1, 2)
        rec(rl, vl, procs[:pl], depth + 1)
        rec(rr, vr, procs[pl:], depth + 1)

    rec(Cuboid(0, n, 0, m, 0, k), Cuboid(0, n, 0, m, 0, k),
        tuple(range(p)), 0)
    return MMPlan(n=n, m=m, k=k, p=p, tiles=tuple(tiles), cuts=tuple(cuts),
                  kind="1piece")
