"""Decoder-only LM backbone (port of ``repro.models.transformer``): the
full-sequence forward of training, serving on a dense cache padded to
max_seq (``prefill_decoder``, ``decode_step_decoder``) and the paged
serving paths; GQA and MLA attention, dense and MoE MLPs.

Parameters are a nested dict of tensors with layer-stacked blocks (leading
L dim), as in ``repro``; the layers run as a Python loop.  Page pools are
dicts {"k", "v"} of (L, n_pages + 1, page, Hkv, Dh) tensors for GQA, and
{"c_kv", "k_rope"} of head-free (L, n_pages + 1, page, kv_lora / qk_rope)
latent tensors for MLA.  Where JAX donates the pool through jit, these
functions write the pool IN PLACE and return the same dict.  Attention
goes through ``kernels.attention.ops``: the hand-written kernels when the
tensors are on CUDA, the plain gather version on the CPU or with
``use_kernel=False``.

Under ``dist.act_sharding.use_mesh_rules`` with DTensor params and pools,
the same code runs sharded: ``repro``'s constraints (``batch_seq``,
``residual``, the vocab-cut logits) redistribute the activations, page
writes go to each rank's local pool shard, and the serving paths hand
back whole logits on every rank.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import act_sharding as act
from repro_torch.kernels.attention import ops as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.sampling import sample_tokens

Params = dict[str, Any]
_NO_WINDOW = 2 ** 31 - 1


class LeafSpec(NamedTuple):
    """Shape and dtype of one layer-stacked cache page leaf."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def _check_decoder(cfg: ArchConfig) -> None:
    if cfg.family != "decoder":
        raise NotImplementedError(
            f"{cfg.name}: this path is the decoder family's (got "
            f"{cfg.family}); paged serving of the ssm, hybrid and encdec "
            f"families is an open item in repro too")


def _layer_windows(cfg: ArchConfig, n_layers: int) -> list[int]:
    """Sliding-window size per layer (INT32_MAX = global)."""
    if not cfg.local_window or not cfg.local_global_period:
        return [_NO_WINDOW] * n_layers
    return [cfg.local_window if i % cfg.local_global_period == 0
            else _NO_WINDOW for i in range(n_layers)]


def _layer(blocks: Params, i: int) -> Params:
    """Layer i of layer-stacked blocks (a leaf cut on its layer dim, a
    stacked (L, d) vector under a mesh, is gathered first), its weights
    gathered over the data-parallel axes (``act.dp_gathered``)."""
    return {k: _layer(v, i) if isinstance(v, dict)
            else act.dp_gathered(act.unshard_dim(v, 0)[i])
            for k, v in blocks.items()}


def gathered(blk: Params) -> Params:
    """One layer's weights gathered over the data-parallel axes: a block
    function's first step, inside its remat, so that only the running
    layer's gathered weights are alive."""
    return {k: gathered(v) if isinstance(v, dict) else act.dp_gathered(v)
            for k, v in blk.items()}


def _unstack(blocks: Params, n: int) -> list[Params]:
    """Layer-stacked blocks -> one dict per layer, by ``unbind``: the
    backward stacks the n layers' gradients once, where n separate index
    views would each scatter into a zero tensor of the whole stack."""
    cols = {k: (_unstack(v, n) if isinstance(v, dict)
                else act.unshard_dim(v, 0).unbind(0))
            for k, v in blocks.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def init_block(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype
               ) -> Params:
    _check_decoder(cfg)
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dtype,  # noqa: E731
                                device=gen.device)
    p: Params = {"ln1": zeros(), "ln2": zeros()}
    if cfg.softcap_attn is not None:  # gemma2-style post-norms
        p["ln1_post"] = zeros()
        p["ln2_post"] = zeros()
    p["attn"] = (L.init_mla(gen, cfg, dtype) if cfg.attn == "mla"
                 else L.init_gqa(gen, cfg, dtype))
    p["mlp"] = (M.init_moe(gen, cfg, dtype) if cfg.moe
                else L.init_mlp(gen, cfg, cfg.d_ff, dtype))
    return p


def _stack(trees: list[Params]) -> Params:
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def embed_table(gen: torch.Generator, cfg: ArchConfig) -> torch.Tensor:
    """(padded_vocab, d_model) normal embeddings of std 1/sqrt(d_model)."""
    return (torch.randn(cfg.padded_vocab, cfg.d_model, generator=gen,
                        device=gen.device)
            / math.sqrt(cfg.d_model)).to(cfg.dtype)


def init_decoder(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Random weights with ``repro``'s shapes and scales, drawn from
    ``gen`` on its device."""
    _check_decoder(cfg)
    dtype = cfg.dtype
    p: Params = {
        "embed": embed_table(gen, cfg),
        "blocks": _stack([init_block(gen, cfg, dtype)
                          for _ in range(cfg.n_layers)]),
        "final_norm": torch.zeros(cfg.d_model, dtype=dtype,
                                  device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                    dtype)
    return p


def paged_cache_leaf_specs(cfg: ArchConfig, page_size: int
                           ) -> dict[str, LeafSpec]:
    """Shape of ONE layer-stacked cache page per leaf; ``serve.paging.
    init_pool`` adds the physical-page dimension.  GQA: "k" and "v" of
    (L, page, Hkv, Dh).  MLA keeps the cache compressed: head-free "c_kv"
    (L, page, kv_lora) and "k_rope" (L, page, qk_rope)."""
    _check_decoder(cfg)
    if cfg.attn == "mla":
        m = cfg.mla
        return {"c_kv": LeafSpec((cfg.n_layers, page_size, m.kv_lora),
                                 cfg.dtype),
                "k_rope": LeafSpec((cfg.n_layers, page_size, m.qk_rope),
                                   cfg.dtype)}
    shape = (cfg.n_layers, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": LeafSpec(shape, cfg.dtype), "v": LeafSpec(shape, cfg.dtype)}


def _embed(params: Params, cfg: ArchConfig, tokens: torch.Tensor
           ) -> torch.Tensor:
    emb = params["embed"]
    # sqrt(d_model) rounded to the parameter dtype first, as in repro
    return act.batch_seq(L.embed_rows(emb, tokens) * torch.tensor(
        math.sqrt(cfg.d_model), dtype=emb.dtype, device=emb.device))


def _mlp_residual(blk: Params, cfg: ArchConfig, x: torch.Tensor,
                  a: torch.Tensor) -> torch.Tensor:
    if "ln1_post" in blk:
        a = L.rms_norm(a, blk["ln1_post"])
    # a row-parallel projection's Partial output is summed here, once,
    # before the norm (else the MLP's column-parallel weights are gathered
    # to meet it)
    x = act.residual(x + a)
    h = L.rms_norm(x, blk["ln2"])
    f = (M.apply_moe(blk["mlp"], cfg, h) if cfg.moe
         else L.apply_mlp(blk["mlp"], cfg, h))
    if "ln2_post" in blk:
        f = L.rms_norm(f, blk["ln2_post"])
    return act.residual(x + f)


def _logits(params: Params, cfg: ArchConfig, x: torch.Tensor
            ) -> torch.Tensor:
    """Logits (..., V) f32; under a mesh cut over the vocab (model) axis,
    as ``repro``'s."""
    x = L.rms_norm(x, params["final_norm"])
    head = act.dp_gathered(params["embed"].T if cfg.tie_embeddings
                           else params["lm_head"])
    logits = act.constrain(x @ head, *("dp",) + (None,) * (x.dim() - 2)
                           + ("model",))
    return L.mask_vocab(L.softcap(logits.float(), cfg.softcap_logits),
                        cfg.vocab)


def _local(pool: torch.Tensor) -> torch.Tensor:
    """A pool's local shard under a mesh (written in place), else the
    pool."""
    return pool.to_local() if act.is_dtensor(pool) else pool


def _write_rows(pool: torch.Tensor, i: int, index: tuple,
                new: torch.Tensor) -> None:
    """pool[i][index] = new, IN PLACE.  Under a mesh the write goes to
    each rank's local pool shard: ``new`` is gathered to the pool's own
    cut (its trailing dims are the pool's), and the index (pages and
    offsets, alike on every rank) is whole everywhere."""
    if not act.is_dtensor(pool):
        pool[i][index] = new
        return
    from torch.distributed.tensor import Replicate, Shard

    lead = pool.ndim - new.ndim
    want = tuple(Shard(p.dim - lead) if isinstance(p, Shard) else Replicate()
                 for p in pool.placements)
    new = act.as_dtensor(new, pool.device_mesh)
    if tuple(new.placements) != want:
        new = new.redistribute(pool.device_mesh, want)
    index = tuple(act.replicate(t) for t in index)
    _local(pool)[i][index] = new.to_local()


def _block_apply(p: Params, cfg: ArchConfig, x: torch.Tensor,
                 positions: torch.Tensor, window: int,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """One decoder block over whole sequences: (B, S, D) -> (B, S, D)."""
    p = gathered(p)
    x = act.residual(x)
    h = L.rms_norm(x, p["ln1"])
    if cfg.attn == "mla":
        a = L.apply_mla(p["attn"], cfg, h, positions)
    else:
        a = L.apply_gqa(p["attn"], cfg, h, positions, window=window,
                        use_kernel=use_kernel)
    return _mlp_residual(p, cfg, x, a)


def forward_decoder(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                    *, remat: bool = True,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) f32.

    ``remat`` recomputes each block in the backward
    (``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint``
    wraps ``repro``'s scan body: only the blocks' inputs are kept, and on
    CUDA each block launches the flash forward kernel twice per training
    step (forward and recompute) and the backward kernel once.  Global
    layers take the window INT32_MAX, as ``repro`` threads it.  The blocks
    draw no random numbers, so the recompute keeps no RNG state
    (``preserve_rng_state=False``, in every family's remat)."""
    _check_decoder(cfg)
    _, s = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, device=x.device)
    windows = _layer_windows(cfg, cfg.n_layers)
    for blk, window in zip(_unstack(params["blocks"], cfg.n_layers),
                           windows):
        if remat and torch.is_grad_enabled():
            x = checkpoint(_block_apply, blk, cfg, x, positions, window,
                           use_kernel, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _block_apply(blk, cfg, x, positions, window, use_kernel)
    return _logits(params, cfg, x)


# ---------------------------------------------------------------------------
# Serving on a dense cache padded to max_seq (the non-paged path)
# ---------------------------------------------------------------------------

def cache_spec_decoder(cfg: ArchConfig, batch: int, max_seq: int
                       ) -> dict[str, LeafSpec]:
    """The layer-stacked dense cache: GQA "k" and "v" of (L, B, max_seq,
    Hkv, Dh); MLA the head-free latents "c_kv" (L, B, max_seq, kv_lora)
    and "k_rope" (L, B, max_seq, qk_rope)."""
    _check_decoder(cfg)
    lyr = cfg.n_layers
    if cfg.attn == "mla":
        m = cfg.mla
        return {"c_kv": LeafSpec((lyr, batch, max_seq, m.kv_lora),
                                 cfg.dtype),
                "k_rope": LeafSpec((lyr, batch, max_seq, m.qk_rope),
                                   cfg.dtype)}
    shape = (lyr, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": LeafSpec(shape, cfg.dtype), "v": LeafSpec(shape, cfg.dtype)}


def zeros_of(spec: dict[str, LeafSpec], device: torch.device | str,
             cfg: ArchConfig | None = None) -> Params:
    """Zeros of ``spec``; under mesh rules (with ``cfg``) laid out by
    ``dist.sharding.cache_specs``, each rank allocating its own block."""
    mesh = act.current_mesh()
    if mesh is not None and cfg is not None:
        from repro_torch.dist.sharding import cache_specs, zeros_laid_out
        return zeros_laid_out(mesh, spec, cache_specs(cfg, mesh, spec),
                              device)
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in spec.items()}


def init_cache_decoder(cfg: ArchConfig, batch: int, max_seq: int, *,
                       device: torch.device | str = "cuda") -> Params:
    return zeros_of(cache_spec_decoder(cfg, batch, max_seq), device, cfg)


def write_at(cache_l: torch.Tensor, new: torch.Tensor,
             lengths: torch.Tensor) -> torch.Tensor:
    """Write each row's one new position ``new`` (B, 1, ...) into
    ``cache_l`` (B, S, ...) at ``lengths`` (B,), IN PLACE.  A length past
    the cache writes its last position, as ``jax.lax.dynamic_update_slice``
    clamps its start.  Under a mesh the write goes to each rank's local
    block: a rank whose block of positions does not hold a row's position
    writes that row's old value back."""
    b, s = cache_l.shape[:2]
    if act.is_dtensor(cache_l):
        local, offs = act.local_block(cache_l)
        lb, ls = local.shape[:2]
        new_l = act.laid_out_as(new, cache_l, whole=(1,))[:, 0]
        lens = act.replicate(lengths)[offs[0]:offs[0] + lb]
        pos = torch.clamp(lens, max=s - 1).long() - offs[1]
        inside = ((pos >= 0) & (pos < ls)).reshape(
            (lb,) + (1,) * (new_l.dim() - 1))
        pos = torch.clamp(pos, 0, ls - 1)
        rows = torch.arange(lb, device=local.device)
        local[rows, pos] = torch.where(inside, new_l, local[rows, pos])
        return cache_l
    rows = torch.arange(b, device=cache_l.device)
    cache_l[rows, torch.clamp(lengths, max=s - 1).long()] = new[:, 0]
    return cache_l


def write_span(leaf: torch.Tensor, i: int, new: torch.Tensor) -> None:
    """leaf[i][:, :n] = new (B, n, ...) IN PLACE, for a layer-stacked
    cache or state leaf (L, B, S, ...).  Under a mesh each rank writes the
    part of ``new`` that meets its local block (a new as long as the
    leaf's dim 2 is cut as the leaf is, with no communication; a shorter
    one is gathered along that dim first)."""
    n = new.shape[1]
    if not act.is_dtensor(leaf):
        leaf[i, :, :n] = new
        return
    local, offs = act.local_block(leaf)
    whole = () if n == leaf.shape[2] else (1,)
    new_l = act.laid_out_as(new, leaf, lead=1, whole=whole)
    lo, ls = offs[2], local.shape[2]
    if whole:
        hi = min(n, lo + ls)
        if hi > lo:
            local[i, :, :hi - lo] = new_l[:, lo:hi]
    else:
        local[i] = new_l


def prefill_decoder(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                    max_seq: int, *, use_kernel: bool | None = None
                    ) -> tuple[torch.Tensor, Params, torch.Tensor]:
    """Full forward over the prompts tokens (B, S) -> (last logits (B, V)
    f32, the cache of ``cache_spec_decoder`` holding the prompts' K/V (or
    MLA latents) at positions [0, S) and zeros to max_seq, lengths (B,)
    int32 = S).  GQA attention is ``layers.attention`` (the flash kernel
    on CUDA, causal over arange(S)); MLA the absorbed latent attention."""
    _check_decoder(cfg)
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, device=x.device)
    windows = _layer_windows(cfg, cfg.n_layers)
    cache = init_cache_decoder(cfg, b, max_seq, device=x.device)
    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        h = L.rms_norm(x, blk["ln1"])
        if cfg.attn == "mla":
            c_kv, k_rope = L.mla_latents(blk["attn"], cfg, h, positions)
            write_span(cache["c_kv"], i, c_kv)
            write_span(cache["k_rope"], i, k_rope)
            a = L.apply_mla(blk["attn"], cfg, h, positions)
        else:
            q, kk, v = L.gqa_qkv(blk["attn"], cfg, h, positions)
            write_span(cache["k"], i, kk)
            write_span(cache["v"], i, v)
            o = L.attention(q, kk, v, q_positions=positions,
                            k_positions=positions, causal=True,
                            window=windows[i], logit_cap=cfg.softcap_attn,
                            q_chunk=cfg.q_chunk, use_kernel=use_kernel)
            a = o.reshape(b, s, -1) @ blk["attn"]["wo"]
        x = _mlp_residual(blk, cfg, x, a)
    logits = _logits(params, cfg, x[:, -1:])[:, 0]
    lengths = torch.full((b,), s, dtype=torch.int32, device=x.device)
    return logits, cache, lengths


def decode_step_decoder(params: Params, cfg: ArchConfig,
                        tokens: torch.Tensor, cache: Params,
                        lengths: torch.Tensor
                        ) -> tuple[torch.Tensor, Params, torch.Tensor]:
    """One new token per sequence, tokens (B, 1) at positions ``lengths``
    (B,) -> (logits (B, V) f32, the cache with the new K/V (or latents)
    written IN PLACE at ``lengths``, lengths + 1).  Attention is
    ``layers.decode_attention`` / ``latent_decode_attention`` over the
    first lengths + 1 positions (torch operations: ``repro`` has no Pallas
    kernel on this path)."""
    _check_decoder(cfg)
    b = tokens.shape[0]
    x = _embed(params, cfg, tokens)                     # (B, 1, D)
    positions = lengths[:, None]
    windows = _layer_windows(cfg, cfg.n_layers)
    attn_len = lengths + 1
    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        h = L.rms_norm(x, blk["ln1"])
        if cfg.attn == "mla":
            q_lat, q_rope = L.mla_absorbed_q(blk["attn"], cfg, h, positions)
            c_kv_new, k_rope_new = L.mla_latents(blk["attn"], cfg, h,
                                                 positions)
            c_kv = write_at(cache["c_kv"][i], c_kv_new, lengths)
            k_rope = write_at(cache["k_rope"][i], k_rope_new, lengths)
            o_lat = L.latent_decode_attention(
                q_lat, q_rope, c_kv, k_rope, lengths=attn_len,
                scale=L.mla_scale(cfg))
            a = L.mla_out(blk["attn"], cfg, o_lat)
        else:
            q, kk, v = L.gqa_qkv(blk["attn"], cfg, h, positions)
            k_c = write_at(cache["k"][i], kk, lengths)
            v_c = write_at(cache["v"][i], v, lengths)
            o = L.decode_attention(q, k_c, v_c, lengths=attn_len,
                                   window=windows[i],
                                   logit_cap=cfg.softcap_attn)
            a = o.reshape(b, 1, -1) @ blk["attn"]["wo"]
        x = _mlp_residual(blk, cfg, x, a)
    return _logits(params, cfg, x)[:, 0], cache, lengths + 1


def prefill_chunk_decoder(params: Params, cfg: ArchConfig,
                          tokens: torch.Tensor, start: int, pages: Params,
                          block_row: torch.Tensor, *,
                          use_kernel: bool | None = None
                          ) -> tuple[torch.Tensor, Params]:
    """One prompt chunk for ONE slot: tokens (1, C) at positions
    [start, start+C), written into the slot's pages via ``block_row``
    (IN PLACE).  Chunks are page-aligned, so each chunk writes C/page whole
    pages.  Returns (logits (C, V) f32, pages)."""
    b, c = tokens.shape
    page = next(iter(pages.values())).shape[2]
    if c % page or start % page:
        raise ValueError(f"chunk [{start}, {start + c}) is not aligned to "
                         f"pages of {page}")
    x = _embed(params, cfg, tokens)
    positions = start + torch.arange(c, device=x.device)
    windows = _layer_windows(cfg, cfg.n_layers)
    page_ids = block_row[start // page:(start + c) // page].long()

    def scatter(pool: torch.Tensor, i: int, new: torch.Tensor) -> None:
        """Write this chunk's C positions as C/page WHOLE pages."""
        _write_rows(pool, i, (page_ids,),
                    new.reshape(c // page, page, *new.shape[2:]))

    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        h = L.rms_norm(x, blk["ln1"])
        # each branch attends over the slot's whole context (past pages +
        # this chunk); unwritten and stale positions are masked by the
        # global causal rule
        if cfg.attn == "mla":
            c_kv, k_rope = L.mla_latents(blk["attn"], cfg, h, positions)
            scatter(pages["c_kv"], i, c_kv)
            scatter(pages["k_rope"], i, k_rope)
            q_lat, q_rope = L.mla_absorbed_q(blk["attn"], cfg, h, positions)
            o_lat = A.paged_latent_prefill_attention(
                q_lat, q_rope, pages["c_kv"][i], pages["k_rope"][i],
                block_row, start, scale=L.mla_scale(cfg),
                use_kernel=use_kernel)
            a = L.mla_out(blk["attn"], cfg, o_lat)
        else:
            q, kk, v = L.gqa_qkv(blk["attn"], cfg, h, positions)
            scatter(pages["k"], i, kk)
            scatter(pages["v"], i, v)
            o = A.paged_prefill_attention(q, pages["k"][i], pages["v"][i],
                                          block_row, start,
                                          window=windows[i],
                                          logit_cap=cfg.softcap_attn,
                                          use_kernel=use_kernel)
            a = o.reshape(b, c, -1) @ blk["attn"]["wo"]
        x = _mlp_residual(blk, cfg, x, a)
    return act.replicate(_logits(params, cfg, x))[0], pages


def _paged_tick(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                pages: Params, block_tables: torch.Tensor,
                lengths: torch.Tensor,
                write_mask: torch.Tensor | None = None,
                null_page: int | None = None, *,
                use_kernel: bool | None = None
                ) -> tuple[torch.Tensor, Params]:
    """One paged decode tick over all slots (the shared body of
    ``decode_step_paged_decoder`` and ``decode_ticks_decoder``).

    tokens (B, 1); block_tables (B, width) int32; lengths (B,) int32
    (the new token lands at position lengths).  ``write_mask`` (B,) bool
    routes masked-off slots' cache writes to ``null_page``.  Returns
    (logits (B, V) f32, pages updated in place)."""
    b = tokens.shape[0]
    page = next(iter(pages.values())).shape[2]
    x = _embed(params, cfg, tokens)                     # (B, 1, D)
    windows = _layer_windows(cfg, cfg.n_layers)
    # The tables may be width-sliced to the live context, and a masked-off
    # slot's length can point one page past the slice: clamp (as JAX's
    # gather does), then route that slot to the null page.
    col = torch.clamp(lengths // page, max=block_tables.shape[1] - 1)
    write_page = block_tables[torch.arange(b, device=x.device), col.long()]
    if write_mask is not None:
        if null_page is None:
            null_page = next(iter(pages.values())).shape[1] - 1
        write_page = torch.where(write_mask, write_page, null_page)
    write_page = write_page.long()
    write_off = (lengths % page).long()
    positions = lengths[:, None]
    attn_len = lengths + 1
    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        h = L.rms_norm(x, blk["ln1"])
        if cfg.attn == "mla":
            c_kv, k_rope = L.mla_latents(blk["attn"], cfg, h, positions)
            _write_rows(pages["c_kv"], i, (write_page, write_off),
                        c_kv[:, 0])
            _write_rows(pages["k_rope"], i, (write_page, write_off),
                        k_rope[:, 0])
            q_lat, q_rope = L.mla_absorbed_q(blk["attn"], cfg, h, positions)
            o_lat = A.paged_latent_decode_attention(
                q_lat, q_rope, pages["c_kv"][i], pages["k_rope"][i],
                block_tables, attn_len, scale=L.mla_scale(cfg),
                use_kernel=use_kernel)
            a = L.mla_out(blk["attn"], cfg, o_lat)
        else:
            q, kk, v = L.gqa_qkv(blk["attn"], cfg, h, positions)
            _write_rows(pages["k"], i, (write_page, write_off), kk[:, 0])
            _write_rows(pages["v"], i, (write_page, write_off), v[:, 0])
            o = A.paged_decode_attention(q, pages["k"][i], pages["v"][i],
                                         block_tables, attn_len,
                                         window=windows[i],
                                         logit_cap=cfg.softcap_attn,
                                         use_kernel=use_kernel)
            a = o.reshape(b, 1, -1) @ blk["attn"]["wo"]
        x = _mlp_residual(blk, cfg, x, a)
    return act.replicate(_logits(params, cfg, x))[:, 0], pages


def decode_step_paged_decoder(params: Params, cfg: ArchConfig,
                              tokens: torch.Tensor, pages: Params,
                              block_tables: torch.Tensor,
                              lengths: torch.Tensor, *,
                              use_kernel: bool | None = None
                              ) -> tuple[torch.Tensor, Params]:
    """One decode tick over every slot; inactive slots ride along pointed
    at the null page.  Returns (logits (B, V), pages updated in place)."""
    return _paged_tick(params, cfg, tokens, pages, block_tables, lengths,
                       use_kernel=use_kernel)


def decode_ticks_decoder(params: Params, cfg: ArchConfig,
                         tokens: torch.Tensor, pages: Params,
                         block_tables: torch.Tensor, lengths: torch.Tensor,
                         active: torch.Tensor, budget: torch.Tensor,
                         eos: torch.Tensor, n_ticks: int, *, max_seq: int,
                         top_k: int | None = None, temperature: float = 1.0,
                         generator: torch.Generator | None = None,
                         null_page: int | None = None,
                         use_kernel: bool | None = None
                         ) -> tuple[torch.Tensor, Params]:
    """``n_ticks`` decode steps with device-side sampling, cache append and
    per-slot retirement flags; the host reads one (N, B) token block.

    tokens (B,) last emitted token per slot; lengths (B,) int32 positions
    written; active (B,) bool; budget (B,) int32 remaining new tokens;
    eos (B,) int32 (-1 = never).  A slot whose emitted token retires it
    (budget spent, eos, or context reaching ``max_seq``: the engine's
    ``_emit`` rule) turns inactive: later ticks freeze its token and
    length and route its writes to the null page.  Returns (toks (N, B)
    int32, -1 where the slot was already inactive; pages, updated in
    place)."""
    toks, lens, act, bud = tokens, lengths, active, budget
    out = []
    for _ in range(n_ticks):
        logits, pages = _paged_tick(params, cfg, toks[:, None], pages,
                                    block_tables, lens, write_mask=act,
                                    null_page=null_page,
                                    use_kernel=use_kernel)
        nxt = sample_tokens(logits, generator=generator, top_k=top_k,
                            temperature=temperature)
        nxt = torch.where(act, nxt, toks)          # freeze inactive lanes
        step = act.to(torch.int32)
        lens = lens + step                         # the old token's KV landed
        bud = bud - step
        # _emit's rule on the just-emitted token: after the emit,
        # prompt + out == lens + 1 (the new token's KV is unwritten)
        done = (bud <= 0) | (nxt == eos) | (lens + 1 >= max_seq)
        out.append(torch.where(act, nxt, -1))
        act = act & ~done
        toks = nxt
    return torch.stack(out), pages


# ---------------------------------------------------------------------------
# Speculative decoding: batched paged verify of device-drafted windows
# ---------------------------------------------------------------------------

def _verify_window(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                   pages: Params, block_tables: torch.Tensor,
                   lengths: torch.Tensor, write_page: torch.Tensor,
                   write_off: torch.Tensor, *,
                   use_kernel: bool | None = None
                   ) -> tuple[torch.Tensor, Params]:
    """One speculative verify forward: W window tokens per slot in one pass
    (the multi-token sibling of ``_paged_tick``).

    tokens (B, W): slot b's last emitted token and its W - 1 drafts, at
    positions lengths[b] + t; write_page/write_off (B, W) int64 pool
    coordinates (out-of-plan positions already at the null page).  Every
    layer writes the window's K/V (or MLA latents) into the pool IN PLACE,
    then attends through the paged verify attention (``ops.
    paged_verify_attention``, ``paged_latent_verify_attention``: the decode
    tick's op sequence with a mask per position).  Returns (logits (B, W,
    V) f32, pages)."""
    b, w = tokens.shape
    x = _embed(params, cfg, tokens)                     # (B, W, D)
    positions = lengths[:, None] + torch.arange(w, dtype=lengths.dtype,
                                                device=x.device)[None, :]
    windows = _layer_windows(cfg, cfg.n_layers)
    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        h = L.rms_norm(x, blk["ln1"])
        if cfg.attn == "mla":
            c_kv, k_rope = L.mla_latents(blk["attn"], cfg, h, positions)
            _write_rows(pages["c_kv"], i, (write_page, write_off), c_kv)
            _write_rows(pages["k_rope"], i, (write_page, write_off), k_rope)
            q_lat, q_rope = L.mla_absorbed_q(blk["attn"], cfg, h, positions)
            o_lat = A.paged_latent_verify_attention(
                q_lat, q_rope, pages["c_kv"][i], pages["k_rope"][i],
                block_tables, lengths, scale=L.mla_scale(cfg),
                use_kernel=use_kernel)
            a = L.mla_out(blk["attn"], cfg, o_lat)
        else:
            q, kk, v = L.gqa_qkv(blk["attn"], cfg, h, positions)
            _write_rows(pages["k"], i, (write_page, write_off), kk)
            _write_rows(pages["v"], i, (write_page, write_off), v)
            o = A.paged_verify_attention(q, pages["k"][i], pages["v"][i],
                                         block_tables, lengths,
                                         window=windows[i],
                                         logit_cap=cfg.softcap_attn,
                                         use_kernel=use_kernel)
            a = o.reshape(b, w, -1) @ blk["attn"]["wo"]
        x = _mlp_residual(blk, cfg, x, a)
    return act.replicate(_logits(params, cfg, x)), pages


def verify_ticks_decoder(params: Params, cfg: ArchConfig,
                         tokens: torch.Tensor, pages: Params,
                         block_tables: torch.Tensor, lengths: torch.Tensor,
                         active: torch.Tensor, budget: torch.Tensor,
                         eos: torch.Tensor, history: torch.Tensor,
                         write_limit: torch.Tensor, n_steps: int, *,
                         max_seq: int, draft_len: int, ngram: int = 2,
                         null_page: int | None = None,
                         use_kernel: bool | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, Params]:
    """``n_steps`` speculative draft -> verify -> accept steps, each
    advancing every live slot by 1..draft_len + 1 tokens.

    Per step and slot: the n-gram drafter (``models.draft``) proposes
    ``draft_len`` tokens from the slot's history; one ``_verify_window``
    scores the W = draft_len + 1 window (last token + drafts) and writes its
    K/V; drafted token t is accepted iff it and every earlier draft equal
    the argmax before them, and the slot emits argmax[0 .. accepted] (the
    accepted drafts and one correction token), cut by the engine's ``_emit``
    rule (budget, eos, max_seq), which also turns exhausted slots inactive;
    window positions past the emitted prefix are rolled back to their
    pre-step pool contents.

    tokens/lengths/active/budget/eos: as in ``decode_ticks_decoder``;
    history (B, H) int32 per-slot context (history[b, lengths[b]] ==
    tokens[b]), appended on the lanes that emitted so that later steps draft
    from tokens accepted earlier; write_limit (B,) int32 one past the last
    position with a mapped page (0 for inactive slots): window writes at or
    past it go to the null page.  Returns (blocks (N, B, W) int32, -1 past
    each step's emitted prefix; accepted (N, B) int32, the accepted drafts
    among the emitted tokens; the updated history; pages, updated in
    place)."""
    from repro_torch.models.draft import draft_ngram_propose

    w = draft_len + 1
    b = tokens.shape[0]
    leaf0 = next(iter(pages.values()))
    page, width = leaf0.shape[2], block_tables.shape[1]
    if null_page is None:
        null_page = leaf0.shape[1] - 1
    dev = tokens.device
    offs = torch.arange(w, dtype=torch.int32, device=dev)
    toks, lens, act, bud, hist = tokens, lengths, active, budget, history
    n_hist = hist.shape[1]
    blocks, accepted = [], []
    for _ in range(n_steps):
        props = draft_ngram_propose(hist, lens + 1, draft_len=draft_len,
                                    ngram=ngram)
        win = torch.cat([toks[:, None], props], dim=1)        # (B, W)
        # the window's pool coordinates; out-of-plan positions (past the
        # mapped write plan, or any position of an inactive slot) go to
        # the null page, as _paged_tick's write_mask routes them
        positions = lens[:, None] + offs[None, :]              # (B, W)
        pp = torch.clamp(positions // page, 0, width - 1).long()
        wp = block_tables.gather(1, pp)
        in_plan = act[:, None] & (positions < write_limit[:, None])
        wp = torch.where(in_plan, wp, null_page).long()
        wo = (positions % page).long()
        # pre-step window contents, for rolling back rejected writes (on
        # each rank's pool shard under a mesh: the coordinates are whole)
        local = {name: _local(leaf) for name, leaf in pages.items()}
        old = {name: leaf[:, wp, wo] for name, leaf in local.items()}
        logits, pages = _verify_window(params, cfg, win, pages, block_tables,
                                       lens, wp, wo, use_kernel=use_kernel)
        g = logits.argmax(-1).to(torch.int32)                  # (B, W)
        ok = (props == g[:, :draft_len]).to(torch.int32)
        acc = torch.cumprod(ok, dim=1).sum(dim=1)              # (B,)
        # the _emit rule replayed over the window: token j is emitted while
        # the slot is alive and every earlier draft was accepted
        alive, new_toks, new_lens, new_bud = act, toks, lens, bud
        cols = []
        for j in range(w):
            tok_j = g[:, j]
            can = alive & (j <= acc)
            step = can.to(torch.int32)
            cols.append(torch.where(can, tok_j, -1))
            new_toks = torch.where(can, tok_j, new_toks)
            new_lens = new_lens + step
            new_bud = new_bud - step
            done = ((new_bud <= 0) | (tok_j == eos)
                    | (new_lens + 1 >= max_seq))
            alive = alive & ~(can & done)
        n_emit = new_lens - lens
        # rollback: window offsets >= n_emit get their pre-step contents
        keep = offs[None, :] < n_emit[:, None]                 # (B, W)
        for name, leaf in local.items():
            cur = leaf[:, wp, wo]
            k_mask = keep.reshape((1, b, w) + (1,) * (cur.dim() - 3))
            leaf[:, wp, wo] = torch.where(k_mask, cur, old[name])
        # history: emitted token j becomes context index lens + 1 + j; the
        # other lanes land in a spare column that is dropped
        out = torch.stack(cols, dim=1)                         # (B, W)
        hidx = torch.where(keep, lens[:, None] + 1 + offs[None, :], n_hist)
        pad = torch.cat([hist, hist.new_zeros(b, 1)], dim=1)
        pad.scatter_(1, torch.clamp(hidx, max=n_hist).long(), out)
        hist = pad[:, :n_hist].contiguous()
        blocks.append(out)
        accepted.append(torch.minimum(n_emit, acc).to(torch.int32))
        toks, lens, act, bud = new_toks, new_lens, alive, new_bud
    return torch.stack(blocks), torch.stack(accepted), hist, pages
