"""PACO GAP (paper Sect. III-D, Theorem 7): the 2-D version of the 1D
problem.

    D[i,j] = min( D[i-1,j-1] + s[i,j],
                  min_{0 <= q < j} D[i,q] + w[q,j],
                  min_{0 <= q < i} D[q,j] + w2[q,i] )

The work is a 3-D solid; self-updates are 3-D triangle analogues and
external updates are cubes.  PACO partitions each external cube into p
slabs along the *output* dimension so all slabs update disjoint regions
simultaneously.  An external cube update is a (min,+) matrix product:
    out[i, j] = min_q ( D[i, q] + w[q, j] )        (row/horizontal cube)
    out[i, j] = min_q ( D[q, j] + w2[q, i] )       (col/vertical cube)

A port of ``repro.core.gap``; D is updated in place.  No kernel: the
within-tile base case is a host loop over cells, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gap_reference(s: np.ndarray, w: np.ndarray, w2: np.ndarray,
                  ) -> np.ndarray:
    """Exact O(n^3) reference (numpy, row-scan).  Shapes:
    s (n+1, n+1); w (n+1, n+1) with w[q, j]; w2 (n+1, n+1) with w2[q, i]."""
    n = s.shape[0] - 1
    big = np.float64(np.inf)
    d = np.full((n + 1, n + 1), big)
    d[0, 0] = 0.0
    for i in range(0, n + 1):
        for j in range(0, n + 1):
            if i == 0 and j == 0:
                continue
            best = big
            if i > 0 and j > 0:
                best = min(best, d[i - 1, j - 1] + s[i, j])
            if j > 0:
                best = min(best, np.min(d[i, :j] + w[:j, j]))
            if i > 0:
                best = min(best, np.min(d[:i, j] + w2[:i, i]))
            d[i, j] = best
    return d


def _minplus(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(min,+) product: out[a,b] = min_q x[a,q] + y[q,b]."""
    return (x[:, :, None] + y[None, :, :]).min(dim=1).values


def paco_gap(s: torch.Tensor, w: torch.Tensor, w2: torch.Tensor, p: int, *,
             tile: int | None = None) -> torch.Tensor:
    """PACO GAP: tiled wavefront; external cube updates run as (min,+)
    products, one per finished source tile (the slabs the PACO plan
    distributes over p processors); the within-tile self-update is the
    sequential base case."""
    n = s.shape[0] - 1
    if tile is None:
        tile = max(1, (n + 1) >> max(1, (p - 1).bit_length()))
    nt = -(-(n + 1) // tile)
    pad = nt * tile - (n + 1)
    inf = float("inf")
    d = torch.full((nt * tile, nt * tile), inf, dtype=s.dtype,
                   device=s.device)
    d[0, 0] = 0.0
    sp, wp, w2p = (F.pad(x, (0, pad, 0, pad), value=inf) for x in (s, w, w2))

    def tile_self_update(bi: int, bj: int) -> None:
        """Sequential DP inside tile (bi,bj) given externals applied."""
        i0, j0 = bi * tile, bj * tile
        for ii in range(tile):
            for jj in range(tile):
                i, j = i0 + ii, j0 + jj
                if i == 0 and j == 0:
                    continue
                best = d[i, j].clone()
                if i > 0 and j > 0:
                    best = torch.minimum(best, d[i - 1, j - 1] + sp[i, j])
                if jj > 0:  # within-tile row candidates
                    best = torch.minimum(
                        best, (d[i, j0:j] + wp[j0:j, j]).min())
                if ii > 0:  # within-tile col candidates
                    best = torch.minimum(
                        best, (d[i0:i, j] + w2p[i0:i, i]).min())
                d[i, j] = best

    # Wavefront over tile anti-diagonals; before a tile's self-update, apply
    # all external cubes from finished tiles (left => row cubes, top => col
    # cubes), each a (min,+) product over one source tile's q-slab.
    for diag in range(2 * nt - 1):
        for bi in range(max(0, diag - nt + 1), min(nt, diag + 1)):
            bj = diag - bi
            i0, j0 = bi * tile, bj * tile
            isl = slice(i0, i0 + tile)
            jsl = slice(j0, j0 + tile)
            for bq in range(bj):
                q = slice(bq * tile, (bq + 1) * tile)
                d[isl, jsl] = torch.minimum(d[isl, jsl],
                                            _minplus(d[isl, q], wp[q, jsl]))
            for bq in range(bi):
                q = slice(bq * tile, (bq + 1) * tile)
                d[isl, jsl] = torch.minimum(d[isl, jsl],
                                            _minplus(w2p[q, isl].T, d[q, jsl]))
            tile_self_update(bi, bj)
    return d[: n + 1, : n + 1]
