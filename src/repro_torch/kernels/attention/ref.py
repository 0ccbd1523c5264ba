"""Dense float32 oracles for the attention kernels (port of
``repro.kernels.attention.ref``): the dense flash oracle and its autograd
gradient, and the paged GQA and MLA latent oracles; and the plain versions
of the dense kernels' key-block entries (sequence-parallel attention) on
``repro``'s chunked formulation, which ``models.layers.attention``'s plain
path shares."""
from __future__ import annotations

import math

import torch


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      q_positions: torch.Tensor, k_positions: torch.Tensor,
                      causal: bool = True, window: int | None = None,
                      logit_cap: float | None = None, q_chunk: int = 1024,
                      scale: float | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``repro.models.layers.attention``'s chunked online-softmax
    formulation with its cast points, in the model's layout: q (B, Sq, Hq,
    D); k, v (B, Sk, Hkv, Dv) with Hq % Hkv == 0 -> (O (B, Sq, Hq, Dv)
    f32, row log-sum-exp (B, Hq, Sq) f32, seen (Sq,) bool: the rows that
    see some key).  K/V repeated over the G query heads, f32 scores from
    the stored inputs, the finite -1e30 mask, weights rounded to v's dtype
    before the PV product, f32 accumulation, ``q_chunk`` query rows at a
    time.  A row that sees no key gets ``repro``'s uniform mean."""
    sq, hq, dh = q.shape[1:]
    g = hq // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qc = min(q_chunk, sq)
    kr = k.transpose(1, 2).float()   # (B, Hq, Sk, Dh)
    vr = v.transpose(1, 2)           # (B, Hq, Sk, Dv)
    outs, lses, seen = [], [], []
    for c0 in range(0, sq, qc):
        qi = q[:, c0:c0 + qc].transpose(1, 2).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qi, kr) * scale
        if logit_cap is not None:
            s = torch.tanh(s / logit_cap) * logit_cap
        qp = q_positions[c0:c0 + qc]
        mask = torch.ones((qp.shape[0], k_positions.shape[0]),
                          dtype=torch.bool, device=q.device)
        if causal:
            mask &= qp[:, None] >= k_positions[None, :]
        if window is not None:
            mask &= (qp[:, None] - k_positions[None, :]) < window
        s = torch.where(mask[None, None], s, -1e30)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        z = e.sum(dim=-1, keepdim=True)
        p_mat = (e / torch.clamp(z, min=1e-30)).to(vr.dtype)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p_mat.float(),
                                 vr.float()))
        lses.append((m + torch.log(z))[..., 0])
        seen.append(mask.any(dim=-1))
    return (torch.cat(outs, dim=2).transpose(1, 2), torch.cat(lses, dim=2),
            torch.cat(seen))


def attention_block_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, k_off: int, causal: bool = True,
                        window: int | None = None,
                        logit_cap: float | None = None, q_chunk: int = 1024,
                        scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel 5's key-block entry: q (B, Sq, Hq, D) at
    positions 0 .. Sq - 1 against k, v (B, Sk, Hkv, D), one block of a
    longer sequence at positions k_off .. k_off + Sk - 1 -> (O (B, Sq, Hq,
    D) f32, the block's normalized partial; row log-sum-exp (B, Hq, Sq)
    f32).  ``chunked_attention`` on those positions; a row that sees no key
    of the block gets O = 0 and log-sum-exp -inf (weight 0 in the
    merge)."""
    dev = q.device
    o, lse, seen = chunked_attention(
        q, k, v, q_positions=torch.arange(q.shape[1], device=dev),
        k_positions=k_off + torch.arange(k.shape[1], device=dev),
        causal=causal, window=window, logit_cap=logit_cap, q_chunk=q_chunk,
        scale=scale)
    return (torch.where(seen[None, :, None, None], o, 0.0),
            torch.where(seen, lse, -math.inf))


def attention_block_ref_grad(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, d_o: torch.Tensor, *,
                             k_off: int, causal: bool = True,
                             window: int | None = None,
                             logit_cap: float | None = None,
                             scale: float | None = None
                             ) -> tuple[torch.Tensor, ...]:
    """The plain version of kernel 5b's key-block entry: with o (B, Sq, Hq,
    D) and lse (B, Hq, Sq) the MERGED forward's over every block and d_o
    its cotangent, this block's share of the gradient -> (dq (B, Sq, Hq,
    D) f32, a partial the blocks add; dk, dv (B, Sk, Hkv, D) in k's
    dtype).  The kernels' recompute in f32: P = exp(S - lse) on the
    block's visible pairs, Delta = rowsum(dO O), dS = P (dO V^T - Delta)
    times the softcap's slope, dq = scale dS K, dk = scale dS^T Q, dv =
    P^T dO, dk and dv summed over each kv head's G query heads."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kr = k.repeat_interleave(g, dim=2).float()
    vr = v.repeat_interleave(g, dim=2).float()
    qf, gf = q.float(), d_o.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    slope = 1.0
    if logit_cap is not None:
        t = torch.tanh(s / logit_cap)
        s, slope = t * logit_cap, 1.0 - t * t
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = k_off + torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    delta = (gf * o.float()).sum(-1).transpose(1, 2)        # (B, Hq, Sq)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vr)
              - delta[..., None]) * slope
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    return (dq, dk.reshape(b, sk, hkv, g, d).sum(3).to(k.dtype),
            dv.reshape(b, sk, hkv, g, d).sum(3).to(v.dtype))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  logit_cap: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D).

    Dense f32 softmax with K/V repeated over the G query heads of each kv
    head, scale 1/sqrt(D), the finite -1e30 mask, and the result cast to
    q's dtype: ``repro.kernels.attention.ref.attention_ref`` op for op."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if logit_cap is not None:
        s = torch.tanh(s / logit_cap) * logit_cap
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def attention_ref_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       d_o: torch.Tensor, *, causal: bool = True,
                       window: int | None = None,
                       logit_cap: float | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain gradient of ``attention_ref``: (dq, dk, dv) for the
    output cotangent ``d_o``, by autograd through the dense oracle, in the
    inputs' layouts and dtypes.  Materializes (B, Hq, Sq, Sk) f32."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        o = attention_ref(*leaves, causal=causal, window=window,
                          logit_cap=logit_cap)
        return torch.autograd.grad(o, leaves, d_o)


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


def paged_verify_ref(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor, *, window: int | None = None,
                     logit_cap: float | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """Dense oracle for the speculative-verify path: each slot's W-token
    window (queries at positions lengths[b] + t) as one
    ``paged_prefill_ref`` call over its own block row.  q: (B, W, Hq, D);
    returns (B, W, Hq, D)."""
    return torch.stack([
        paged_prefill_ref(q[i][None], k_pages, v_pages, block_tables[i],
                          int(lengths[i]), window=window,
                          logit_cap=logit_cap, scale=scale)[0]
        for i in range(q.shape[0])])


def _latent_dense(q_lat, q_rope, ckv_pages, kr_pages, rows):
    """The formulation the production path avoids: gathered latent pages,
    the latent pair CONCATENATED into per-position keys and BROADCAST to
    every head.  Returns f32 q (B, Sq, H, kv+rope), k (B, S, H, kv+rope)
    and v (B, S, H, kv_lora)."""
    b, _, h, _ = q_lat.shape
    page, pps = ckv_pages.shape[1], rows.shape[1]
    rows = rows.long()
    q = torch.cat([q_lat, q_rope], dim=-1).float()
    ck = ckv_pages[rows].reshape(b, pps * page, -1).float()
    kr = kr_pages[rows].reshape(b, pps * page, -1).float()
    k = torch.cat([ck, kr], dim=-1)[:, :, None, :].expand(-1, -1, h, -1)
    v = ck[:, :, None, :].expand(-1, -1, h, -1)
    return q, k, v


def paged_latent_prefill_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                             ckv_pages: torch.Tensor, kr_pages: torch.Tensor,
                             block_row: torch.Tensor, start: int, *,
                             scale: float) -> torch.Tensor:
    """Dense oracle for the paged MLA latent chunked-prefill path.

    q_lat (1, C, H, kv_lora); q_rope (1, C, H, qk_rope); head-free pools
    ckv_pages (n_pages, page, kv_lora) / kr_pages (n_pages, page,
    qk_rope); block_row (pages_per_seq,).  Dense f32 softmax under the
    GLOBAL causal mask.  Returns (1, C, H, kv_lora)."""
    c = q_lat.shape[1]
    q, k, v = _latent_dense(q_lat, q_rope, ckv_pages, kr_pages,
                            block_row[None])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    q_pos = start + torch.arange(c, device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    s = torch.where((q_pos >= k_pos)[None, None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).to(q_lat.dtype)


def paged_latent_attention_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                               ckv_pages: torch.Tensor,
                               kr_pages: torch.Tensor,
                               block_tables: torch.Tensor,
                               lengths: torch.Tensor, *, scale: float
                               ) -> torch.Tensor:
    """Dense oracle for the paged MLA latent decode path.

    q_lat (B, 1, H, kv_lora); q_rope (B, 1, H, qk_rope); head-free pools;
    block_tables (B, pages_per_seq); lengths (B,).  Dense f32 softmax
    over positions < length.  Returns (B, 1, H, kv_lora)."""
    q, k, v = _latent_dense(q_lat, q_rope, ckv_pages, kr_pages,
                            block_tables)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    pos = torch.arange(k.shape[1], device=q.device)
    mask = pos[None, :] < lengths[:, None]
    s = torch.where(mask[:, None, None, :], s, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).to(q_lat.dtype)


def paged_latent_verify_ref(q_lat: torch.Tensor, q_rope: torch.Tensor,
                            ckv_pages: torch.Tensor, kr_pages: torch.Tensor,
                            block_tables: torch.Tensor,
                            lengths: torch.Tensor, *, scale: float
                            ) -> torch.Tensor:
    """Dense oracle for the MLA latent speculative-verify path: one
    ``paged_latent_prefill_ref`` call per slot.  q_lat: (B, W, H,
    kv_lora); returns (B, W, H, kv_lora)."""
    return torch.stack([
        paged_latent_prefill_ref(q_lat[i][None], q_rope[i][None], ckv_pages,
                                 kr_pages, block_tables[i], int(lengths[i]),
                                 scale=scale)[0]
        for i in range(q_lat.shape[0])])
