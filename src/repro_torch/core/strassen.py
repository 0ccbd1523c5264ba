"""PACO Strassen (paper Sect. III-F, Theorem 13 / Corollary 14).

Strassen's 7-way recursion in PyTorch, partitioned by the paper's pruned
BFS of the 7-ary tree.  The CONST-PIECES variant stops dividing after
``gamma`` super-rounds (<=1% imbalance at gamma=8): arbitrary p (prime
included), exact flop lower bound, bandwidth within a constant, O(log p)
latency.  Every leaf product goes through ``kernels.matmul.ops.matmul``
(the hand-written kernel on a CUDA tensor).

A port of ``repro.core.strassen``.  ``strassen_beneficial_depth`` takes the
card's own rates: on an H100 a dense product runs on the tensor cores
while Strassen's extra additions are element-wise passes bound by memory
bandwidth, so the crossover depth is large.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.card import HBM_BYTES_PER_S, PEAK_FLOPS
from repro_torch.core import tree as paco_tree
from repro_torch.kernels.matmul import ops as mm_ops

OMEGA0 = 2.8073549220576042  # log2(7)

# The card's data-sheet figures (``repro_torch.card``, NVIDIA H100 80GB
# HBM3 at 700 W): dense bf16 on the tensor cores, and the HBM rate over
# the 6 bytes an element-wise bf16 add moves (two read, one written).
H100_MATMUL_FLOPS = PEAK_FLOPS[torch.bfloat16]
H100_ADDS_PER_S = HBM_BYTES_PER_S / 6

# (S_r coefficients over [A00,A01,A10,A11], T_r over [B00,B01,B10,B11])
_S = (
    (1, 0, 0, 1),   # S1 = A00 + A11
    (0, 0, 1, 1),   # S2 = A10 + A11
    (1, 0, 0, 0),   # S3 = A00
    (0, 0, 0, 1),   # S4 = A11
    (1, 1, 0, 0),   # S5 = A00 + A01
    (-1, 0, 1, 0),  # S6 = A10 - A00
    (0, 1, 0, -1),  # S7 = A01 - A11
)
_T = (
    (1, 0, 0, 1),   # T1 = B00 + B11
    (1, 0, 0, 0),   # T2 = B00
    (0, 1, 0, -1),  # T3 = B01 - B11
    (-1, 0, 1, 0),  # T4 = B10 - B00
    (0, 0, 0, 1),   # T5 = B11
    (1, 1, 0, 0),   # T6 = B00 + B01
    (0, 0, 1, 1),   # T7 = B10 + B11
)
# C quadrants over [M1..M7]
_C = (
    (1, 0, 0, 1, -1, 0, 1),   # C00 = M1 + M4 - M5 + M7
    (0, 0, 1, 0, 1, 0, 0),    # C01 = M3 + M5
    (0, 1, 0, 1, 0, 0, 0),    # C10 = M2 + M4
    (1, -1, 1, 0, 0, 1, 0),   # C11 = M1 - M2 + M3 + M6
)


def _quads(x: torch.Tensor) -> tuple[torch.Tensor, ...]:
    n, m = x.shape
    h, w = n // 2, m // 2
    return x[:h, :w], x[:h, w:], x[h:, :w], x[h:, w:]


def _comb(quads, coeffs):
    """The signed sum of the quadrants; a lone +1 term stays a view, which
    the matmul kernel reads in place."""
    out = None
    for c, q in zip(coeffs, quads):
        if c == 0:
            continue
        term = q if c == 1 else -q if c == -1 else c * q
        out = term if out is None else out + term
    return out


def _combine(ms: list[torch.Tensor]) -> torch.Tensor:
    c00, c01, c10, c11 = (_comb(ms, _C[i]) for i in range(4))
    return torch.cat([torch.cat([c00, c01], dim=1),
                      torch.cat([c10, c11], dim=1)], dim=0)


def strassen(a: torch.Tensor, b: torch.Tensor, depth: int = 1
             ) -> torch.Tensor:
    """Strassen matmul with ``depth`` levels of 7-way recursion.

    Requires both dims divisible by 2**depth.  depth=0 => one base-case
    product (``kernels.matmul.ops.matmul``).
    """
    if depth == 0:
        return mm_ops.matmul(a, b)
    n, k = a.shape
    _, m = b.shape
    if n % 2 or k % 2 or m % 2:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(b.shape)} do not "
                         f"halve")
    aq, bq = _quads(a), _quads(b)
    return _combine([strassen(_comb(aq, _S[r]), _comb(bq, _T[r]), depth - 1)
                     for r in range(7)])


# ---------------------------------------------------------------------------
# PACO partitioning of the 7-ary tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StrassenNode:
    """A multiplication node: path of branch indices from the root."""

    path: tuple[int, ...]
    size: int  # matrix dimension at this node

    def children(self) -> list["StrassenNode"]:
        return [StrassenNode(self.path + (r,), self.size // 2)
                for r in range(7)]


def plan_strassen(n: int, p: int, *, base: int = 64,
                  gamma: int | None = None
                  ) -> paco_tree.Assignment[StrassenNode]:
    """Pruned BFS of the 7-ary Strassen tree for p processors: the
    per-processor multiplication lists."""
    root = StrassenNode((), n)
    return paco_tree.pruned_bfs(
        [root],
        children=lambda nd: nd.children(),
        is_base=lambda nd: nd.size <= base,
        p=p,
        arity=7,
        gamma=gamma,
    )


def _leaf_operands(a: torch.Tensor, b: torch.Tensor, path: Sequence[int]
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Materialize (S_path, T_path): the operands of one tree node."""
    for r in path:
        a = _comb(_quads(a), _S[r])
        b = _comb(_quads(b), _T[r])
    return a, b


def paco_strassen(a: torch.Tensor, b: torch.Tensor, p: int, *,
                  depth: int = 1, gamma: int | None = None) -> torch.Tensor:
    """PACO Strassen: expand exactly ``depth`` levels of the 7-ary tree,
    assign the 7**depth multiplications by pruned BFS round-robin over p
    processors, execute each processor's list (each leaf one base-case
    product), and combine bottom-up.  Numerics identical to
    ``strassen(a, b, depth)``."""
    n = a.shape[0]
    assign = plan_strassen(n, p, base=max(1, n >> depth), gamma=gamma)
    leaf: dict[tuple[int, ...], torch.Tensor] = {}
    for proc_nodes in assign.by_proc:
        for node in proc_nodes:
            la, lb = _leaf_operands(a, b, node.path)
            leaf[node.path] = mm_ops.matmul(la, lb)
    for d in range(depth - 1, -1, -1):
        paths = sorted({pth for pth in leaf if len(pth) == d + 1})
        for par in sorted({pth[:-1] for pth in paths}):
            leaf[par] = _combine([leaf.pop(par + (r,)) for r in range(7)])
    return leaf[()]


def strassen_beneficial_depth(n: int, *,
                              matmul_flops: float = H100_MATMUL_FLOPS,
                              adds_per_s: float = H100_ADDS_PER_S) -> int:
    """Cost-model gate: depth d is beneficial iff the product flops saved
    ((7/8)^d) outweigh the extra 18 n^2 (7/4)^i element adds of each level
    i < d (``repro``'s model), at ``matmul_flops`` for the dense products
    and ``adds_per_s`` for the element-wise additions.  Returns the depth
    in [0, 5] of least modelled time (0 when classic matmul wins)."""
    best, best_cost = 0, float("inf")
    for d in range(0, 6):
        mm = 2.0 * n ** 3 * (7.0 / 8.0) ** d / matmul_flops
        adds = 18.0 * n ** 2 * sum((7.0 / 4.0) ** i for i in range(d)) \
            / adds_per_s
        cost = mm + adds
        if cost < best_cost:
            best, best_cost = d, cost
    return best
