"""Attention entry points of the model code (port of
``repro.kernels.attention.ops``): dense flash attention, and the paged GQA
and MLA latent paths.

Each function has two lowerings.  The plain version is the gather
formulation of ``repro``'s jnp path, op for op and with the same cast
points: scores in f32 from the stored K/V, softmax weights rounded to the
value type before the PV product, f32 accumulation.  It is the CPU
lowering and the oracle of the kernels.  The kernel lowering is the
hand-written Hopper kernel in ``attention.py``.  ``use_kernel=None`` (the
model code's default) takes the kernel exactly when the tensors are on
CUDA (or fake: ``kernels.work.on_card``); ``use_kernel=False`` takes
the plain version on any device.

Under a mesh (DTensor arguments inside ``dist.act_sharding.
use_mesh_rules``), each paged op runs on every rank's block: query heads
cut over the model axis as the pools' heads are (``dist.sharding.
paged_pool_specs``; latent pools are whole), slots over the dp axes, and
the kernel or plain version sees contiguous local tensors.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.dist import act_sharding as act
from repro_torch.kernels.attention import attention as K
from repro_torch.kernels.attention import ref as R
from repro_torch.kernels.work import on_card
from repro_torch.models import layers as L


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    logit_cap: float | None = None,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """q: (B, Sq, Hq, D), k/v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D), positions
    0..Sq-1 against 0..Sk-1 (Sq == Sk: one sequence attending to itself;
    Sq != Sk: a cross-attention).

    The kernel lowering (``attention.flash_attention``, differentiable
    through the backward kernel) reads the model's layout as it is; the
    plain version transposes to (B, H, S, D) around ``ref.attention_ref``,
    as ``repro``'s ops transpose around ``flash_attention_pallas``, and
    autograd differentiates it."""
    if use_kernel is None:
        use_kernel = on_card(q)
    if use_kernel:
        return K.flash_attention(q, k, v, causal=causal, window=window,
                                 logit_cap=logit_cap)
    o = R.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        logit_cap=logit_cap)
    return o.transpose(1, 2)


def gather_kv_pages(pages: torch.Tensor, block_tables: torch.Tensor
                    ) -> torch.Tensor:
    """(n_pages, page, *feat) pool + (B, pages_per_seq) tables ->
    (B, pages_per_seq * page, *feat) per-sequence contiguous cache view."""
    b, pps = block_tables.shape
    page = pages.shape[1]
    return pages[block_tables.long()].reshape(b, pps * page,
                                              *pages.shape[2:])


def _on_shards(latent: bool, per_slot: bool):
    """Run the wrapped paged op on each rank's block under a mesh.  GQA:
    the query heads are cut only where the pools' KV heads are (the model
    axis divides Hkv), so that query head h stays with KV head h // G.
    Latent: query heads cut where they divide, pools whole.  ``per_slot``
    ops take (B, W) block tables and (B,) lengths, cut over dp with the
    slots; the prefill ops take one block row and a start, whole."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not any(act.is_dtensor(a) for a in args):
                return fn(*args, **kw)
            if latent:
                q_names = ("dp", None, "model", None)
                names = (q_names, q_names, (None,) * 3, (None,) * 3)
            else:
                cut = args[1].shape[2] % act.model_size() == 0
                q_names = ("dp", None, "model" if cut else None, None)
                pool = (None, None, "model", None)
                names = (q_names, pool, pool)
            names += (("dp", None), ("dp",)) if per_slot else ((None,),
                                                               None)
            return act.local_call(functools.partial(fn, **kw), names, 0,
                                  *args)
        return wrapper
    return deco


@_on_shards(latent=False, per_slot=True)
def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           window: int | None = None,
                           logit_cap: float | None = None,
                           scale: float | None = None,
                           use_kernel: bool | None = None) -> torch.Tensor:
    """Single-token decode against a paged KV cache.

    q: (B, 1, Hq, D); k_pages/v_pages: (n_pages, page, Hkv, D);
    block_tables: (B, pages_per_seq) int32; lengths: (B,) valid positions;
    ``window`` an int (INT32_MAX or None = global).  Returns (B, 1, Hq, D).
    The cache stays in its grouped Hkv layout: the GQA expansion is never
    materialized.  Dense oracle: ``ref.paged_attention_ref``.
    """
    b, _, hq, d = q.shape
    _, page, hkv, dhv = v_pages.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if use_kernel is None:
        use_kernel = on_card(q)
    if use_kernel:
        return K.paged_flash_decode(q, k_pages, v_pages, block_tables,
                                    lengths, scale=scale, window=window,
                                    logit_cap=logit_cap)
    k = gather_kv_pages(k_pages, block_tables)   # (B, S, Hkv, D)
    v = gather_kv_pages(v_pages, block_tables)
    s = k.shape[1]
    qr = q.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qr.float(), k.float()) * scale
    if logit_cap is not None:
        scores = torch.tanh(scores / logit_cap) * logit_cap
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] < lengths[:, None]
    if window is not None:
        mask &= pos[None, :] >= (lengths[:, None] - window)
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", w.float(), v.float())
    return out.reshape(b, 1, hq, dhv).to(q.dtype)


@_on_shards(latent=False, per_slot=True)
def paged_verify_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           window: int | None = None,
                           logit_cap: float | None = None,
                           scale: float | None = None,
                           use_kernel: bool | None = None) -> torch.Tensor:
    """Speculative-verify attention: a W-token window PER SLOT against the
    paged KV cache.

    q: (B, W, Hq, D), slot b's queries at global positions lengths[b] + t
    (the last emitted token and its drafts, whose K/V the caller has
    already written); k_pages/v_pages: (n_pages, page, Hkv, D);
    block_tables: (B, pages_per_seq) int32; lengths: (B,).  Returns
    (B, W, Hq, D).  The plain version is ``paged_decode_attention``'s op
    sequence with the W positions folded into the grouped-query rows and a
    mask per position (key position <= lengths[b] + t), so at W = 1 it is
    bitwise the plain decode at lengths + 1.  The kernel lowering is
    ``attention.paged_flash_verify``: one launch for all slots.  Dense
    oracle: ``ref.paged_verify_ref``.
    """
    b, w, hq, d = q.shape
    _, page, hkv, dhv = v_pages.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if use_kernel is None:
        use_kernel = on_card(q)
    if use_kernel:
        return K.paged_flash_verify(q, k_pages, v_pages, block_tables,
                                    lengths, scale=scale, window=window,
                                    logit_cap=logit_cap)
    k = gather_kv_pages(k_pages, block_tables)   # (B, S, Hkv, D)
    v = gather_kv_pages(v_pages, block_tables)
    s = k.shape[1]
    # rows (t, g) of each kv head: decode's grouped queries, W times over
    qr = q.reshape(b, w, hkv, g, d).transpose(1, 2).reshape(b, hkv, w * g, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qr.float(), k.float()) * scale
    if logit_cap is not None:
        scores = torch.tanh(scores / logit_cap) * logit_cap
    pos = torch.arange(s, device=q.device)
    q_pos = lengths[:, None] + torch.arange(w, device=q.device)[None, :]
    mask = pos[None, None, :] <= q_pos[:, :, None]           # (B, W, S)
    if window is not None:
        mask &= pos[None, None, :] > (q_pos[:, :, None] - window)
    mask = mask[:, None, :, None, :].expand(b, 1, w, g, s)
    scores = torch.where(mask.reshape(b, 1, w * g, s), scores, -1e30)
    wts = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", wts.float(), v.float())
    out = out.reshape(b, hkv, w, g, dhv).transpose(1, 2)
    return out.reshape(b, w, hq, dhv).to(q.dtype)


@_on_shards(latent=False, per_slot=False)
def paged_prefill_attention(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_row: torch.Tensor,
                            start: int, *, window: int | None = None,
                            logit_cap: float | None = None,
                            scale: float | None = None,
                            use_kernel: bool | None = None) -> torch.Tensor:
    """Chunked prefill for ONE slot straight off the paged KV cache.

    q: (1, C, Hq, D) the chunk's queries at global positions
    [start, start+C); k_pages/v_pages: (n_pages, page, Hkv, D);
    block_row: (pages_per_seq,) int32; ``start`` a host int.  Returns
    (1, C, Hq, D).  The plain version gathers the slot's pages and runs
    ``repro.models.layers.attention``'s softmax with the GLOBAL causal mask
    (q_pos = start + offset), which also masks stale and future page
    contents.  Dense oracle: ``ref.paged_prefill_ref``.
    """
    _, c, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if use_kernel is None:
        use_kernel = on_card(q)
    if use_kernel:
        return K.paged_flash_prefill(q, k_pages, v_pages, block_row, start,
                                     scale=scale, window=window,
                                     logit_cap=logit_cap)
    k = gather_kv_pages(k_pages, block_row[None]).repeat_interleave(g, 2)
    v = gather_kv_pages(v_pages, block_row[None]).repeat_interleave(g, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if logit_cap is not None:
        s = torch.tanh(s / logit_cap) * logit_cap
    q_pos = start + torch.arange(c, device=q.device)[:, None]
    k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask[None, None], s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    z = e.sum(dim=-1, keepdim=True)
    p = (e / torch.clamp(z, min=1e-30)).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return o.to(q.dtype)


@_on_shards(latent=True, per_slot=True)
def paged_latent_decode_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                                  ckv_pages: torch.Tensor,
                                  kr_pages: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  lengths: torch.Tensor, *, scale: float,
                                  use_kernel: bool | None = None
                                  ) -> torch.Tensor:
    """Single-token decode against a COMPRESSED (MLA latent) paged cache.

    q_lat (B, 1, H, kv_lora) absorbed-W_uk queries; q_rope (B, 1, H,
    qk_rope); ckv_pages (n_pages, page, kv_lora) and kr_pages (n_pages,
    page, qk_rope), head-free; block_tables (B, pages_per_seq) int32;
    lengths (B,).  Returns (B, 1, H, kv_lora), expanded through W_uv by
    the caller.  Every head shares one latent key and value; scores are
    q_lat . c_kv + q_rope . k_rope.  Dense oracle:
    ``ref.paged_latent_attention_ref``."""
    if use_kernel is None:
        use_kernel = on_card(q_lat)
    if use_kernel:
        return K.paged_latent_decode(q_lat, q_rope, ckv_pages, kr_pages,
                                     block_tables, lengths, scale=scale)
    ck = gather_kv_pages(ckv_pages, block_tables)   # (B, S, kv_lora)
    kr = gather_kv_pages(kr_pages, block_tables)    # (B, S, qk_rope)
    s = ck.shape[1]
    scores = (torch.einsum("bqhk,bsk->bhqs", q_lat.float(), ck.float())
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kr.float())
              ) * scale
    pos = torch.arange(s, device=q_lat.device)
    mask = pos[None, :] < lengths[:, None]
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(ck.dtype)
    out = torch.einsum("bhqs,bsk->bqhk", w.float(), ck.float())
    return out.to(q_lat.dtype)


@_on_shards(latent=True, per_slot=True)
def paged_latent_verify_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                                  ckv_pages: torch.Tensor,
                                  kr_pages: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  lengths: torch.Tensor, *, scale: float,
                                  use_kernel: bool | None = None
                                  ) -> torch.Tensor:
    """Speculative-verify attention against a COMPRESSED (MLA latent)
    paged cache: a W-token window per slot at positions lengths[b] + t.

    q_lat (B, W, H, kv_lora); q_rope (B, W, H, qk_rope); head-free pools;
    block_tables (B, pages_per_seq) int32; lengths (B,).  Returns (B, W, H,
    kv_lora).  The plain version is ``paged_latent_decode_attention``'s
    decomposed-score op sequence with a mask per position, so at W = 1 it
    is bitwise the plain decode at lengths + 1.  The kernel lowering is
    ``attention.paged_latent_verify``: one launch for all slots.  Dense
    oracle: ``ref.paged_latent_verify_ref``."""
    if use_kernel is None:
        use_kernel = on_card(q_lat)
    if use_kernel:
        return K.paged_latent_verify(q_lat, q_rope, ckv_pages, kr_pages,
                                     block_tables, lengths, scale=scale)
    w = q_lat.shape[1]
    ck = gather_kv_pages(ckv_pages, block_tables)   # (B, S, kv_lora)
    kr = gather_kv_pages(kr_pages, block_tables)    # (B, S, qk_rope)
    s = ck.shape[1]
    scores = (torch.einsum("bqhk,bsk->bhqs", q_lat.float(), ck.float())
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kr.float())
              ) * scale
    pos = torch.arange(s, device=q_lat.device)
    q_pos = lengths[:, None] + torch.arange(w, device=q_lat.device)[None, :]
    mask = pos[None, None, :] <= q_pos[:, :, None]           # (B, W, S)
    scores = torch.where(mask[:, None, :, :], scores, -1e30)
    wts = torch.softmax(scores, dim=-1).to(ck.dtype)
    out = torch.einsum("bhqs,bsk->bqhk", wts.float(), ck.float())
    return out.to(q_lat.dtype)


@_on_shards(latent=True, per_slot=False)
def paged_latent_prefill_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                                   ckv_pages: torch.Tensor,
                                   kr_pages: torch.Tensor,
                                   block_row: torch.Tensor, start: int, *,
                                   scale: float,
                                   use_kernel: bool | None = None
                                   ) -> torch.Tensor:
    """Chunked MLA latent prefill for ONE slot off the compressed pools.

    q_lat (1, C, H, kv_lora); q_rope (1, C, H, qk_rope) at global
    positions [start, start+C); head-free pools; block_row
    (pages_per_seq,) int32; ``start`` a host int.  Returns (1, C, H,
    kv_lora).  The plain version gathers the slot's latent pages and runs
    ``layers.latent_attention`` under the GLOBAL causal mask.  Dense
    oracle: ``ref.paged_latent_prefill_ref``."""
    if use_kernel is None:
        use_kernel = on_card(q_lat)
    if use_kernel:
        return K.paged_latent_prefill(q_lat, q_rope, ckv_pages, kr_pages,
                                      block_row, start, scale=scale)
    c = q_lat.shape[1]
    ck = gather_kv_pages(ckv_pages, block_row[None])  # (1, S, kv_lora)
    kr = gather_kv_pages(kr_pages, block_row[None])
    return L.latent_attention(
        q_lat, q_rope, ck, kr,
        q_positions=start + torch.arange(c, device=q_lat.device),
        k_positions=torch.arange(ck.shape[1], device=q_lat.device),
        scale=scale)
