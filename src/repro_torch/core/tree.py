"""Generic pruned-BFS partitioner for c-way divide-and-conquer trees.

This is the paper's *general PACO algorithm* (Sect. III): unfold the D&C tree
depth by depth in breadth-first order; as soon as some depth holds >= p ready,
mutually-independent nodes, prune up to (c-1)*p of them (a multiple of p) and
assign them to the p processors round-robin.  Remaining nodes continue to the
next round of pruned BFS.  When all frontier nodes are base-case sized, assign
all of them round-robin.

The CONST-PIECES variant (paper Corollary 14) stops after ``gamma``
super-rounds and assigns everything left round-robin, trading an arbitrarily
small constant load imbalance for O(log p) latency.

The planner is processor-aware (takes ``p``) but cache-oblivious: it never
consults cache sizes.  It runs at *plan time* (host Python), mirroring the
paper's separate partitioning phase (cost accounted in Corollary 3).

A copy of ``repro.core.tree`` (framework-free, so the port keeps its own
copy rather than importing the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Generic, Iterable, Sequence, TypeVar

N = TypeVar("N")


@dataclasses.dataclass(frozen=True)
class Assignment(Generic[N]):
    """Result of a pruned-BFS partition.

    ``by_proc[i]`` is the list of nodes assigned to processor i, in assignment
    order (super-round order).  The paper's invariant: each list is an
    (almost) geometrically decreasing sequence in ``work``.
    """

    p: int
    by_proc: tuple[tuple[N, ...], ...]
    super_rounds: int
    # depth of tree expansion per super-round (i_1 < i_2 < ... in the paper)
    round_depths: tuple[int, ...]

    def loads(self, work: Callable[[N], float]) -> list[float]:
        return [sum(work(n) for n in nodes) for nodes in self.by_proc]

    def imbalance(self, work: Callable[[N], float]) -> float:
        """(max - min) / mean of per-processor work; 0.0 == perfect balance."""
        loads = self.loads(work)
        mean = sum(loads) / len(loads)
        if mean == 0:
            return 0.0
        return (max(loads) - min(loads)) / mean

    def all_nodes(self) -> list[N]:
        return [n for nodes in self.by_proc for n in nodes]


def pruned_bfs(
    roots: Sequence[N],
    children: Callable[[N], Sequence[N]],
    is_base: Callable[[N], bool],
    p: int,
    *,
    arity: int | None = None,
    gamma: int | None = None,
    max_depth: int = 64,
) -> Assignment[N]:
    """Partition the D&C tree under ``roots`` among ``p`` processors.

    Args:
      roots: top-level node(s) of the tree.
      children: expands a non-base node into its c children.
      is_base: true when a node must not be divided further.
      p: number of processors (arbitrary >= 1, primes welcome).
      arity: c; only used to cap pruning at (c-1)*p per round (paper's rule).
        Inferred from the first expansion if None.
      gamma: CONST-PIECES super-round budget; None = run to completion
        (paper's Theorem 13 behaviour).
      max_depth: safety bound on tree expansion.

    Returns an Assignment covering every leaf-or-pruned node exactly once.
    """
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    by_proc: list[list[N]] = [[] for _ in range(p)]
    frontier: list[N] = list(roots)
    rr = 0  # round-robin cursor, persists across rounds for fairness
    super_rounds = 0
    round_depths: list[int] = []
    depth = 0

    def assign(nodes: Iterable[N]) -> None:
        nonlocal rr
        for node in nodes:
            by_proc[rr % p].append(node)
            rr += 1

    while frontier:
        if depth > max_depth:
            raise RuntimeError(
                f"pruned_bfs exceeded max_depth={max_depth}; "
                "is_base never triggered?")
        if all(is_base(n) for n in frontier):
            # Base-case rule: everything goes round-robin.
            assign(frontier)
            super_rounds += 1
            round_depths.append(depth)
            frontier = []
            break
        if len(frontier) >= p:
            if gamma is not None and super_rounds >= gamma:
                # CONST-PIECES: stop dividing, assign all leftovers.
                assign(frontier)
                super_rounds += 1
                round_depths.append(depth)
                frontier = []
                break
            c = arity
            if c is None:
                # Infer arity from any expandable node.
                for n in frontier:
                    if not is_base(n):
                        c = max(2, len(children(n)))
                        break
                assert c is not None
            # Prune a multiple of p, at most (c-1)*p, never the whole
            # frontier unless it is exactly divisible (keep >=0 leftovers).
            k = min(len(frontier) // p, max(1, c - 1))
            pruned, frontier = frontier[: k * p], frontier[k * p:]
            assign(pruned)
            super_rounds += 1
            round_depths.append(depth)
            if not frontier:
                break
        # Expand one BFS level.
        nxt: list[N] = []
        for n in frontier:
            if is_base(n):
                nxt.append(n)  # base nodes ride along until assignment
            else:
                nxt.extend(children(n))
        frontier = nxt
        depth += 1

    return Assignment(
        p=p,
        by_proc=tuple(tuple(nodes) for nodes in by_proc),
        super_rounds=super_rounds,
        round_depths=tuple(round_depths),
    )


def geometric_decrease_ok(
    assignment: Assignment[N],
    work: Callable[[N], float],
    *,
    ratio: float = 1.0,
) -> bool:
    """Check the paper's invariant: per-proc work sequences are (almost)
    non-increasing — each later node is <= ratio * the max seen so far.

    With round-robin assignment over a shrinking frontier this holds with
    ratio 1.0 for self-similar trees (children strictly smaller than parent).
    """
    for nodes in assignment.by_proc:
        prev = float("inf")
        for n in nodes:
            w = work(n)
            if w > ratio * prev + 1e-9:
                return False
            prev = w
    return True
