"""Dense float32 oracles for the paged attention paths (port of
``repro.kernels.attention.ref``'s paged GQA oracles)."""
from __future__ import annotations

import math

import torch


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor, *, window: int | None = None,
                        logit_cap: float | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """Dense oracle for the paged decode path.

    q: (B, 1, Hq, D) one query token per sequence; k_pages/v_pages:
    (n_pages, page, Hkv, D); block_tables: (B, pages_per_seq) int32;
    lengths: (B,) valid cache positions.  Materializes each sequence's
    gathered cache and runs a dense f32 softmax.  Returns (B, 1, Hq, D).
    """
    b, _, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    pps = block_tables.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    bt = block_tables.long()
    k = k_pages[bt].reshape(b, pps * page, hkv, d).repeat_interleave(g, 2)
    v = v_pages[bt].reshape(b, pps * page, hkv, d).repeat_interleave(g, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_cap is not None:
        s = torch.tanh(s / logit_cap) * logit_cap
    pos = torch.arange(pps * page, device=q.device)
    mask = pos[None, :] < lengths[:, None]
    if window is not None:
        mask &= pos[None, :] >= (lengths[:, None] - window)
    s = torch.where(mask[:, None, None, :], s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return o.to(q.dtype)


def paged_prefill_ref(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, block_row: torch.Tensor,
                      start: int, *, window: int | None = None,
                      logit_cap: float | None = None,
                      scale: float | None = None) -> torch.Tensor:
    """Dense oracle for the paged chunked-prefill path.

    q: (1, C, Hq, D) one chunk of one slot at global positions
    [start, start+C); block_row: (pages_per_seq,) the slot's page map.
    Dense f32 softmax under the GLOBAL causal mask, which also masks stale
    and future page contents.  Returns (1, C, Hq, D).
    """
    _, c, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    pps = block_row.shape[0]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    row = block_row.long()
    k = k_pages[row].reshape(1, pps * page, hkv, d).repeat_interleave(g, 2)
    v = v_pages[row].reshape(1, pps * page, hkv, d).repeat_interleave(g, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_cap is not None:
        s = torch.tanh(s / logit_cap) * logit_cap
    q_pos = start + torch.arange(c, device=q.device)[:, None]
    k_pos = torch.arange(pps * page, device=q.device)[None, :]
    mask = q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask[None, None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return o.to(q.dtype)
