"""Plain PyTorch versions of the LCS tile kernel (the oracles of
``csrc/lcs_tile.cu``, as ``repro.kernels.lcs.ref`` is of the TPU one).

Both compute the TPU kernel's function on any int32 inputs, borders that
are not valid DP tables included: per row i,
``cur = max(cummax(max(prev, diag + (t == s[i]))), left[i])`` with
``diag`` the previous row shifted right by one behind the corner (row 0)
or ``left[i - 1]``; ``right[i] = cur[-1]``.
"""
from __future__ import annotations

import torch


def lcs_tiles_ref(s_tiles: torch.Tensor, t_tiles: torch.Tensor,
                  top: torch.Tensor, left: torch.Tensor, corner: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """T tiles at once (the tiles of one anti-diagonal): s_tiles (T, M),
    t_tiles (T, N), top (T, N), left (T, M), corner (T,), all int32.
    Returns (bottom (T, N), right (T, M))."""
    prev, prev_corner = top, corner
    rights = []
    for i in range(s_tiles.shape[1]):
        li = left[:, i]
        eq = (t_tiles == s_tiles[:, i:i + 1]).to(prev.dtype)
        diag = torch.cat([prev_corner[:, None], prev[:, :-1]], dim=1)
        a = torch.maximum(prev, diag + eq)
        cur = torch.maximum(torch.cummax(a, dim=1).values, li[:, None])
        rights.append(cur[:, -1])
        prev, prev_corner = cur, li
    return prev, torch.stack(rights, dim=1)


def lcs_tile_ref(s_tile: torch.Tensor, t_tile: torch.Tensor,
                 top: torch.Tensor, left: torch.Tensor, corner: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One (M, N) tile: s_tile (M,), t_tile (N,), top (N,), left (M,),
    corner (1,).  Returns (bottom_row (N,), right_col (M,))."""
    bottom, right = lcs_tiles_ref(s_tile[None], t_tile[None], top[None],
                                  left[None], corner.reshape(1))
    return bottom[0], right[0]
