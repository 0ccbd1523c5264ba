"""Hand-written Hopper kernel for the LCS DP tile, and its wrappers.

``lcs_diagonal_kernel`` replaces the TPU kernel
``repro/kernels/lcs/lcs.py: lcs_tile_pallas`` with ``csrc/lcs_tile.cu``:
it computes that kernel's function for every tile of one anti-diagonal of
the PACO wavefront in one launch, one CTA per tile, reading and writing
the borders in place in device arrays (layout below), so the wavefront
takes one launch per diagonal and no per-tile host slicing.
``lcs_tile_kernel`` is ``lcs_tile_pallas``'s single-tile call: one
diagonal of one tile.

What bounds it on the card: integer operations, about four per DP cell at
the INT32 rate.  ``csrc/lcs_tile.cu``'s header says what the design does
about it.

Border arrays of an (m x n) table cut into (tile_m x tile_n) tiles, all
int32 on the device of the sequences, each in two halves: diagonal d reads
half (d + 1) % 2 and writes half d % 2.
- ``rows`` (2, n): the bottom row of the last tile done in each tile
  column (zeros before the first: the DP table's row -1);
- ``cols`` (2, m): the right column of the last tile done in each tile
  row (zeros: column -1);
- ``corners`` (2, tj): in slot j, the entry X[i0 - 1, j0 - 1] that tile
  (i, j) takes as its corner, which tile (i - 1, j) writes (its left
  column's last entry).

The wrappers check device, dtype, shape and contiguity and raise on
anything else, launch on the current stream, raise if the launch reports
a CUDA error, and add one to ``lcs_diagonal_kernel.launches`` per launch.
A CPU tensor takes the plain version (``ref.lcs_tiles_ref``) instead.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import c_function
from repro_torch.kernels.lcs.ref import lcs_tiles_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def max_tile_n() -> int:
    """The widest tile one CTA takes (8 columns for each of 1024
    threads)."""
    return c_function("lcs_tile", "lcs_tile_max_n")()


def _check(name: str, x: torch.Tensor, device: torch.device,
           shape: tuple[int, ...]) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} has dtype {x.dtype}, expected torch.int32")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def lcs_diagonal_kernel(s: torch.Tensor, t: torch.Tensor,
                        rows: torch.Tensor, cols: torch.Tensor,
                        corners: torch.Tensor, d: int, tile_m: int,
                        tile_n: int) -> None:
    """Every (tile_m x tile_n) tile on anti-diagonal ``d`` of the DP table
    of s (m,) against t (n,), in place on the border arrays ``rows``
    (2, n), ``cols`` (2, m) and ``corners`` (2, n // tile_n) (layout in
    the module docstring).  m and n must be multiples of the tile."""
    m, n = s.shape[0], t.shape[0]
    if tile_m < 1 or tile_n < 1 or m % tile_m or n % tile_n:
        raise ValueError(f"tiles of {tile_m} x {tile_n} do not cut a "
                         f"{m} x {n} table")
    ti, tj = m // tile_m, n // tile_n
    if not 0 <= d < ti + tj - 1:
        raise ValueError(f"diagonal {d} is outside a {ti} x {tj} grid")
    for name, x, shape in (("s", s, (m,)), ("t", t, (n,)),
                           ("rows", rows, (2, n)), ("cols", cols, (2, m)),
                           ("corners", corners, (2, tj))):
        _check(name, x, s.device, shape)
    i_lo = max(0, d - tj + 1)             # tiles (i, d - i), i_lo <= i
    count = min(ti, d + 1) - i_lo
    src, dst = (d + 1) % 2, d % 2
    if not s.is_cuda:
        i = torch.arange(i_lo, i_lo + count)
        j = d - i
        left = cols[src].view(ti, tile_m)[i]
        bottom, right = lcs_tiles_ref(
            s.view(ti, tile_m)[i], t.view(tj, tile_n)[j],
            rows[src].view(tj, tile_n)[j], left, corners[src][j])
        rows[dst].view(tj, tile_n)[j] = bottom
        cols[dst].view(ti, tile_m)[i] = right
        corners[dst][j] = left[:, -1]
        return
    if tile_n > max_tile_n():
        raise ValueError(f"tiles {tile_n} wide exceed the kernel's "
                         f"{max_tile_n()}")
    fn = c_function("lcs_tile", "lcs_diagonal",
                    (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _P))
    with torch.cuda.device(s.device):
        err = fn(s.data_ptr(), t.data_ptr(), rows[src].data_ptr(),
                 cols[src].data_ptr(), corners[src].data_ptr(),
                 rows[dst].data_ptr(), cols[dst].data_ptr(),
                 corners[dst].data_ptr(), tile_m, tile_n, d, i_lo, count,
                 torch.cuda.current_stream(s.device).cuda_stream)
    if err:
        raise RuntimeError(f"lcs_diagonal launch failed: CUDA error {err}")
    lcs_diagonal_kernel.launches += 1


lcs_diagonal_kernel.launches = 0


def _chunk_width(t_tile: torch.Tensor) -> int:
    """Columns per launch of one tile: the kernel's widest on the card;
    the plain version takes any width."""
    return max_tile_n() if t_tile.is_cuda else t_tile.shape[0]


def lcs_tile_kernel(s_tile: torch.Tensor, t_tile: torch.Tensor,
                    top: torch.Tensor, left: torch.Tensor,
                    corner: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One (M, N) tile, as ``lcs_tile_pallas``: s_tile (M,), t_tile (N,)
    int32 sequences; top (N,), left (M,), corner (1,) int32 DP borders.
    Returns (bottom_row (N,), right_col (M,)).  A tile wider than the
    kernel's widest goes through in column chunks, each one launch: the
    right column of a chunk is the left border of the next, and its top
    entry one column left is the next chunk's corner."""
    m, n = s_tile.shape[0], t_tile.shape[0]
    if m < 1 or n < 1:
        raise ValueError(f"an LCS tile needs M, N >= 1, got {m} x {n}")
    for name, x, shape in (("t_tile", t_tile, (n,)), ("top", top, (n,)),
                           ("left", left, (m,)), ("corner", corner, (1,))):
        _check(name, x, s_tile.device, shape)
    width = _chunk_width(t_tile)
    bottoms = []
    for c0 in range(0, n, width):
        c1 = min(n, c0 + width)
        cnr = corner if c0 == 0 else top[c0 - 1:c0]
        zeros = torch.zeros_like
        rows = torch.stack([zeros(top[c0:c1]), top[c0:c1]])
        cols = torch.stack([zeros(left), left])
        corners = torch.stack([zeros(cnr), cnr])
        lcs_diagonal_kernel(s_tile.contiguous(), t_tile[c0:c1].contiguous(),
                            rows, cols, corners, 0, m, c1 - c0)
        bottoms.append(rows[0])
        left = cols[0]
    return torch.cat(bottoms), left
