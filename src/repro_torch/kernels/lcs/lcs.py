"""Hand-written Hopper kernel for the LCS DP tile, and its wrappers.

``lcs_table_kernel`` replaces the TPU kernel
``repro/kernels/lcs/lcs.py: lcs_tile_pallas`` with ``csrc/lcs_tile.cu``:
it computes that kernel's function (bottom row and right column of a DP
table from its top row, left column and corner) for a whole table cut
into tiles, in one launch.  A persistent grid claims the tiles in
anti-diagonal order, each tile one CTA that waits for its top and left
neighbours' done flags and sweeps its rows skewed across the lanes.
``lcs_tile_kernel`` is ``lcs_tile_pallas``'s single-tile call: the 1 x 1
case of the same launch (a tile wider or taller than one CTA takes cuts
into a few tiles of the same launch).

What bounds it on the card: integer operations, about four per DP cell at
the INT32 rate.  ``csrc/lcs_tile.cu``'s header says what the design does
about it.

The wrappers check device, dtype, shape and contiguity and raise on
anything else, launch on the current stream, raise if the launch reports
a CUDA error, and add one to ``lcs_table_kernel.launches`` per launch and
to ``lcs_table_kernel.variants[f"skew{run}"]``, naming the sweep's run of
columns a lane (4 for tiles of at most 128 columns, else 8).  A CPU
tensor takes the plain version (``lcs_table_plain``: ``ref.lcs_tiles_ref``
anti-diagonal by anti-diagonal over the same border buffers) instead.
A fake tensor (``FakeTensorMode``) allocates the kernel's state as a fake
tensor and records the table's work (``kernels.work.lcs_work``) in the
open counters, with no launch; a real launch records the same when a
counter is open.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels.build import c_function
from repro_torch.kernels import work as _work
from repro_torch.kernels.lcs.ref import lcs_tiles_ref

_P, _I = ctypes.c_void_p, ctypes.c_int


def max_tile_n() -> int:
    """The widest tile one CTA takes (8 columns for each of 1024
    threads)."""
    return c_function("lcs_tile", "lcs_tile_max_n")()


def max_tile_m() -> int:
    """The tallest tile one CTA takes."""
    return c_function("lcs_tile", "lcs_tile_max_m")()


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


def _state(top: torch.Tensor, left: torch.Tensor, corner: torch.Tensor,
           tile_n: int, ti: int, tj: int) -> torch.Tensor:
    """The kernel's int32 state: rows (n) | cols (m) | corners (tj) |
    colprog (tj) | rowprog (ti) | counter (1).  Corner j is X[-1, j0 - 1]:
    the corner for the first tile column, the top row one column left of
    the tile for the others; flags and counter zero."""
    n, m = top.shape[0], left.shape[0]
    state = torch.zeros(n + m + 2 * tj + ti + 1, dtype=torch.int32,
                        device=top.device)
    state[:n] = top
    state[n:n + m] = left
    state[n + m] = corner[0]
    if tj > 1:
        state[n + m + 1:n + m + tj] = top[tile_n - 1:(tj - 1) * tile_n:tile_n]
    return state


def _table_plain(s, t, state, tile_m, tile_n, ti, tj) -> None:
    """The plain version over the kernel's state, one anti-diagonal of
    tiles at a time (tiles of one shape batched into one call of
    ``lcs_tiles_ref``)."""
    m, n = s.shape[0], t.shape[0]
    rows, cols = state[:n], state[n:n + m]
    corners = state[n + m:n + m + tj]
    for d in range(ti + tj - 1):
        groups = collections.defaultdict(list)
        for i in range(max(0, d - tj + 1), min(ti, d + 1)):
            j = d - i
            groups[(min(tile_m, m - i * tile_m),
                    min(tile_n, n - j * tile_n))].append((i, j))
        for (hm, hn), tiles in groups.items():
            i = torch.tensor([x[0] for x in tiles])
            j = torch.tensor([x[1] for x in tiles])
            r_idx = (i * tile_m)[:, None] + torch.arange(hm)
            c_idx = (j * tile_n)[:, None] + torch.arange(hn)
            left = cols[r_idx]
            bottom, right = lcs_tiles_ref(s[r_idx], t[c_idx], rows[c_idx],
                                          left, corners[j])
            rows[c_idx] = bottom
            cols[r_idx] = right
            corners[j] = left[:, -1]


def _checked(s, t, top, left, corner, tile_m, tile_n) -> tuple[int, int]:
    """(m, n) of a table call whose arguments hold."""
    m, n = s.shape[0], t.shape[0]
    if m < 1 or n < 1:
        raise ValueError(f"an LCS table needs m, n >= 1, got {m} x {n}")
    if tile_m < 1 or tile_n < 1:
        raise ValueError(f"tiles of {tile_m} x {tile_n} are empty")
    for name, x, shape in (("s", s, (m,)), ("t", t, (n,)),
                           ("top", top, (n,)), ("left", left, (m,)),
                           ("corner", corner, (1,))):
        _check(name, x, s.device, shape)
    return m, n


def lcs_table_plain(s: torch.Tensor, t: torch.Tensor, top: torch.Tensor,
                    left: torch.Tensor, corner: torch.Tensor, tile_m: int,
                    tile_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lcs_table_kernel``'s function by the plain version, on the
    tensors' own device: ``lcs_tiles_ref`` anti-diagonal by anti-diagonal
    over the kernel's border buffers."""
    m, n = _checked(s, t, top, left, corner, tile_m, tile_n)
    ti, tj = -(-m // tile_m), -(-n // tile_n)
    state = _state(top, left, corner, tile_n, ti, tj)
    _table_plain(s, t, state, tile_m, tile_n, ti, tj)
    return state[:n], state[n:n + m]


def lcs_table_kernel(s: torch.Tensor, t: torch.Tensor, top: torch.Tensor,
                     left: torch.Tensor, corner: torch.Tensor, tile_m: int,
                     tile_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The DP table of s (m,) against t (n,) from its borders top (n,),
    left (m,) and corner (1,), all int32, in (tile_m x tile_n) tiles (the
    last tile row and column may be ragged): ``lcs_tile_pallas``'s
    function, one launch on CUDA.  Returns (bottom row (n,), right column
    (m,))."""
    fake = _work.is_fake(s)
    if not s.is_cuda and not fake:
        return lcs_table_plain(s, t, top, left, corner, tile_m, tile_n)
    m, n = _checked(s, t, top, left, corner, tile_m, tile_n)
    if not fake and (tile_n > max_tile_n() or tile_m > max_tile_m()):
        raise ValueError(f"tiles of {tile_m} x {tile_n} exceed the "
                         f"kernel's {max_tile_m()} x {max_tile_n()}")
    ti, tj = -(-m // tile_m), -(-n // tile_n)
    state = _state(top, left, corner, tile_n, ti, tj)
    if _work.tracing(s) and _work.record_call(
            "lcs_table", s, lambda fake: _work.lcs_work(m, n)):
        return state[:n], state[n:n + m]
    fn = c_function("lcs_tile", "lcs_table",
                    (_P, _P, _P, _I, _I, _I, _I, _P))
    with torch.cuda.device(s.device):
        err = fn(s.data_ptr(), t.data_ptr(), state.data_ptr(), m, n, tile_m,
                 tile_n, torch.cuda.current_stream(s.device).cuda_stream)
    if err:
        raise RuntimeError(f"lcs_table launch failed: CUDA error {err}")
    lcs_table_kernel.launches += 1
    lcs_table_kernel.variants[
        f"skew{c_function('lcs_tile', 'lcs_run', (_I,))(tile_n)}"] += 1
    return state[:n], state[n:n + m]


lcs_table_kernel.launches = 0
lcs_table_kernel.variants = collections.Counter()


def _tile_shape(m: int, n: int, is_cuda: bool) -> tuple[int, int]:
    """The tiles of a single-tile call: the whole tile where one CTA takes
    it (always for the plain version), else the kernel's largest."""
    if not is_cuda:
        return m, n
    return min(m, max_tile_m()), min(n, max_tile_n())


def lcs_tile_kernel(s_tile: torch.Tensor, t_tile: torch.Tensor,
                    top: torch.Tensor, left: torch.Tensor,
                    corner: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One (M, N) tile, as ``lcs_tile_pallas``: s_tile (M,), t_tile (N,)
    int32 sequences; top (N,), left (M,), corner (1,) int32 DP borders.
    Returns (bottom_row (N,), right_col (M,)).  One launch: a tile larger
    than one CTA takes is cut into tiles of the same launch."""
    m, n = s_tile.shape[0], t_tile.shape[0]
    if m < 1 or n < 1:
        raise ValueError(f"an LCS tile needs M, N >= 1, got {m} x {n}")
    tile_m, tile_n = _tile_shape(m, n, s_tile.is_cuda
                                 and not _work.is_fake(s_tile))
    return lcs_table_kernel(s_tile, t_tile, top, left, corner, tile_m,
                            tile_n)

