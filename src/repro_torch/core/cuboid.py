"""PACO matrix-multiplication cut trees (paper Sect. III-E).

A rectangular matmul C[n,m] += A[n,k] @ B[k,m] is the cuboid n x m x k:
faces A = n x k, B = k x m, C = n x m.  PACO partitions the cuboid among p
processors; cutting n or m splits outputs (embarrassingly parallel), cutting
k splits the reduction (needs a temporary C and a combining add).

Three planners:
  * ``plan_mm``          — multi-piece pruned BFS (Theorem 9): each processor
                           receives a geometrically decreasing cuboid list.
  * ``plan_mm_1piece``   — 1-PIECE (Corollary 10): recursive longest-dim cut
                           with the processor list split floor(p/2):ceil(p/2);
                           exactly one cuboid per processor; O(log p) latency.
                           This is the production path (distributed memory).
  * ``plan_hetero``      — HETERO (Sect. IV-A variant): cut by the throughput
                           ratio of the left/right halves of the processor
                           list, one cuboid per processor.

``mesh_factors`` reduces a 1-piece plan on a power-of-two p to the induced
(pn, pm, pk) processor-grid factorization — the bridge from the paper's cut
tree to an SPMD mesh sharding.

A copy of ``repro.core.cuboid`` (framework-free, so the port keeps its own
copy rather than importing the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core import tree as paco_tree


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

    def volume(self) -> int:
        return self.n * self.m * self.k

    def surface(self) -> int:
        """nm + nk + mk — bytes-touched proxy (C, A, B faces)."""
        return self.n * self.m + self.n * self.k + self.m * self.k

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
    """Output of a planner: per-processor tiles + the cut schedule."""

    n: int
    m: int
    k: int
    p: int
    tiles: tuple[tuple[int, Cuboid], ...]  # (proc_id, cuboid), >=1 per proc
    cuts: tuple[Cut, ...]
    kind: str  # "mm" | "1piece" | "hetero"

    # -- paper-faithful accounting ------------------------------------------
    def per_proc_volume(self) -> list[int]:
        v = [0] * self.p
        for proc, c in self.tiles:
            v[proc] += c.volume()
        return v

    def per_proc_surface(self) -> list[int]:
        s = [0] * self.p
        for proc, c in self.tiles:
            s[proc] += c.surface()
        return s

    def comm_bytes(self, dtype_bytes: int = 2) -> int:
        """Total inter-processor traffic: every processor must gather the A/B
        faces of its cuboids and scatter/reduce its C faces (memory-
        independent communication bound, Q_p^sum second term)."""
        return sum(c.surface() for _, c in self.tiles) * dtype_bytes

    def k_cut_rounds(self) -> int:
        """Latency proxy: number of cut-tree levels containing a k-cut
        (each needs one reduction round; paper bounds this by O(log p))."""
        return len({c.depth for c in self.cuts if c.dim == "k"})

    def check_exact_cover(self) -> bool:
        """Tiles must tile [0,n)x[0,m)x[0,k) exactly (volume + disjointness
        via sorting boxes; sufficient for axis-aligned recursive cuts)."""
        total = sum(c.volume() for _, c in self.tiles)
        return total == self.n * self.m * self.k


# ---------------------------------------------------------------------------
# Planner 1: multi-piece pruned BFS (Theorem 9)
# ---------------------------------------------------------------------------

def plan_mm(n: int, m: int, k: int, p: int, *, base: int = 1,
            gamma: int | None = None) -> MMPlan:
    """Pruned-BFS multi-piece plan. Cuts the longest dimension of every
    unassigned cuboid in half, depth by depth, assigning exact multiples of p
    round-robin (paper Sect. III-E); ``gamma`` enables CONST-PIECES early
    stop (then also used by Strassen's planner shape)."""
    root = Cuboid(0, n, 0, m, 0, k)
    cuts: list[Cut] = []

    def children(c: Cuboid) -> list[Cuboid]:
        d = c.longest_dim()
        left, right = c.split(d, 1, 2)
        return [left, right]

    def is_base(c: Cuboid) -> bool:
        return max(c.n, c.m, c.k) <= base or c.volume() <= 1

    asg = paco_tree.pruned_bfs([root], children, is_base, p,
                               arity=2, gamma=gamma)
    tiles = tuple(
        (proc, cub)
        for proc, nodes in enumerate(asg.by_proc)
        for cub in nodes
    )
    # Reconstruct cut schedule for latency accounting: replay BFS levels.
    frontier = [root]
    depth = 0
    assigned = {((c.n0, c.n1, c.m0, c.m1, c.k0, c.k1)) for _, c in tiles}
    while frontier and depth < 64:
        nxt = []
        for c in frontier:
            key = (c.n0, c.n1, c.m0, c.m1, c.k0, c.k1)
            if key in assigned or is_base(c):
                continue
            d = c.longest_dim()
            cuts.append(Cut(dim=d, procs=tuple(range(p)), depth=depth))
            nxt.extend(children(c))
        frontier = nxt
        depth += 1
    return MMPlan(n=n, m=m, k=k, p=p, tiles=tiles, cuts=tuple(cuts),
                  kind="mm")


# ---------------------------------------------------------------------------
# Planner 2: 1-PIECE (Corollary 10) — the production path
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Planner 3: HETERO (one cuboid per processor, throughput-ratio cuts)
# ---------------------------------------------------------------------------

def plan_hetero(n: int, m: int, k: int,
                throughputs: Sequence[float]) -> MMPlan:
    """Paper Sect. IV-A heterogeneous variant: binary tree over the
    throughput list; each internal node cuts the cuboid's longest dim by the
    ratio of its children's total throughput.  Used for straggler mitigation:
    slow hosts get proportionally smaller cuboids."""
    p = len(throughputs)
    tiles: list[tuple[int, Cuboid]] = []
    cuts: list[Cut] = []
    # Work in integer millionths so split() stays integral & deterministic.
    SCALE = 10 ** 6

    def rec(c: Cuboid, procs: tuple[int, ...], depth: int):
        if len(procs) == 1:
            tiles.append((procs[0], c))
            return
        half = len(procs) // 2
        lt = sum(throughputs[i] for i in procs[:half])
        rt = sum(throughputs[i] for i in procs[half:])
        dim = c.longest_dim()
        cuts.append(Cut(dim=dim, procs=procs, depth=depth))
        num = int(round(SCALE * lt / (lt + rt)))
        left, right = c.split(dim, num, SCALE)
        rec(left, procs[:half], depth + 1)
        rec(right, procs[half:], depth + 1)

    rec(Cuboid(0, n, 0, m, 0, k), tuple(range(p)), 0)
    return MMPlan(n=n, m=m, k=k, p=p, tiles=tuple(tiles), cuts=tuple(cuts),
                  kind="hetero")


# ---------------------------------------------------------------------------
# Bridge to SPMD meshes
# ---------------------------------------------------------------------------

def _prime_factors(p: int) -> list[int]:
    fs = []
    d = 2
    while d * d <= p:
        while p % d == 0:
            fs.append(d)
            p //= d
        d += 1
    if p > 1:
        fs.append(p)
    return fs


def mesh_factors(n: int, m: int, k: int, p: int) -> tuple[int, int, int]:
    """(pn, pm, pk) with pn*pm*pk == p for ANY p >= 1: how many ways the
    1-piece cut tree divides each dimension.  This converts the paper's cut
    schedule into a 3-D processor grid for shard_map / pjit.

    Each prime factor of p (largest first) cuts the virtual cuboid's
    longest dimension that many ways; for power-of-two p this replays the
    1-piece halving schedule exactly, and a prime p lands entirely on the
    longest dimension (Corollary 10 needs no divisibility)."""
    if p < 1:
        raise ValueError(f"mesh_factors requires p >= 1, got {p}")
    pn = pm = pk = 1
    virt = Cuboid(0, max(n, 1), 0, max(m, 1), 0, max(k, 1))
    for q in sorted(_prime_factors(p), reverse=True):
        d = virt.longest_dim()
        if d == "n":
            pn *= q
        elif d == "m":
            pm *= q
        else:
            pk *= q
        virt, _ = virt.split(d, 1, q)
    return pn, pm, pk


def megatron_comm_bytes(n: int, m: int, k: int, p: int,
                        dtype_bytes: int = 2, *, shard: str = "m") -> int:
    """Baseline cost model: fixed 1-D sharding a la Megatron (shard the m
    dim; A replicated => every processor reads all of A, its B/C columns).
    Used by benchmarks to quantify the PACO plan's communication win."""
    if shard == "m":
        per_proc = n * k + (k * m) // p + (n * m) // p
    elif shard == "k":
        # shard contraction dim: all-reduce C on every processor
        per_proc = (n * k) // p + (k * m) // p + n * m
    else:
        raise ValueError(shard)
    return per_proc * p * dtype_bytes
