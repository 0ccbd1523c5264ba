"""Public LCS of the port over the tile kernel: the anti-diagonal
wavefront of ``repro.kernels.lcs.ops.lcs_pallas``, with the whole table in
one launch where JAX makes one call per tile."""
from __future__ import annotations

import torch

from repro_torch.kernels.lcs.lcs import lcs_table_kernel


def default_tile(m: int, p: int) -> int:
    """The first-assignment rule: the first anti-diagonal with >= p tiles
    fixes the granularity, m / 2^ceil(log2 p) (at least 1)."""
    return max(1, m >> max(1, (p - 1).bit_length()))


def lcs_wavefront(s: torch.Tensor, t: torch.Tensor, p: int, *,
                  tile: int | None = None) -> torch.Tensor:
    """LCS length (0-d int32) of int32 sequences s (m,) and t (n,) by the
    tile kernel over the PACO tiling for p processors: tile x tile tiles
    (both lengths must be multiples of the tile), one launch on CUDA."""
    m, n = s.shape[0], t.shape[0]
    if tile is None:
        tile = default_tile(m, p)
    if m % tile or n % tile:
        raise ValueError(f"tile {tile} does not divide {m} x {n}")
    s = s.to(torch.int32).contiguous()
    t = t.to(torch.int32).contiguous()
    zeros = torch.zeros(m + n + 1, dtype=torch.int32, device=s.device)
    bottom, _ = lcs_table_kernel(s, t, zeros[:n], zeros[n:n + m],
                                 zeros[n + m:], tile, tile)
    return bottom[-1]
