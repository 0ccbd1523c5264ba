"""The pure-SSM backbone (mamba2-780m) and the hybrid SSM + shared-attention
backbone (zamba2-7b), the port of ``repro.models.hybrid``.

zamba2: groups of ``attn_every`` Mamba-2 layers, each group followed by ONE
weight-shared full-attention block (the same weights every time).  The
Mamba layers are stacked as ``params["groups"]`` of (n_groups, attn_every,
...) leaves, as in ``repro``.  The shared block's attention is
``layers.apply_gqa``: on CUDA the flash kernel (kernel 5, causal, at
zamba2's head_dim 112), once a group.  Decode states are layer-stacked
tensors written IN PLACE: ``conv`` (L, B, W - 1, C) in the model's dtype,
``ssm`` (L, B, H, P, N) f32 and, for the hybrid, the shared block's dense
K/V cache (n_groups, B, max_seq, Hkv, Dh).
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import act_sharding as act
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import (LeafSpec, _layer, _stack,
                                            _unstack, embed_table, gathered,
                                            write_at, write_span)

Params = dict[str, Any]


def _zeros(cfg: ArchConfig, gen: torch.Generator) -> torch.Tensor:
    return torch.zeros(cfg.d_model, dtype=cfg.dtype, device=gen.device)


def _mamba_block(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return {"ln": _zeros(cfg, gen), "mixer": S.init_mamba2(gen, cfg,
                                                           cfg.dtype)}


def _logits(params: Params, cfg: ArchConfig, x: torch.Tensor
            ) -> torch.Tensor:
    x = L.rms_norm(x, params["final_norm"])
    head = act.dp_gathered(params["lm_head"])
    return L.mask_vocab(act.constrain((x @ head).float(), "dp",
                                      *(None,) * (x.dim() - 2), "model"),
                        cfg.vocab)


def _mamba_apply(blk: Params, cfg: ArchConfig, x: torch.Tensor
                 ) -> torch.Tensor:
    blk = gathered(blk)
    x = act.residual(x)
    return act.residual(
        x + S.apply_mamba2(blk["mixer"], cfg, L.rms_norm(x, blk["ln"])))


def _mamba_layers(blocks: list[Params], cfg: ArchConfig, x: torch.Tensor,
                  remat: bool) -> torch.Tensor:
    """Residual Mamba-2 blocks over whole sequences; with ``remat`` (and
    grad mode) each block is recomputed in the backward, as
    ``jax.checkpoint`` wraps ``repro``'s scan body."""
    for blk in blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(_mamba_apply, blk, cfg, x, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _mamba_apply(blk, cfg, x)
    return x


# ---------------------------------------------------------------------------
# Pure SSM (mamba2)
# ---------------------------------------------------------------------------

def init_ssm_lm(cfg: ArchConfig, gen: torch.Generator) -> Params:
    return {
        "embed": embed_table(gen, cfg),
        "blocks": _stack([_mamba_block(gen, cfg)
                          for _ in range(cfg.n_layers)]),
        "final_norm": _zeros(cfg, gen),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                cfg.dtype),
    }


def forward_ssm_lm(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                   *, remat: bool = True) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) f32.  The embedding is not scaled
    (``repro``'s SSM LM)."""
    x = act.batch_seq(L.embed_rows(params["embed"], tokens))
    x = _mamba_layers(_unstack(params["blocks"], cfg.n_layers), cfg, x,
                      remat)
    return _logits(params, cfg, x)


def state_spec_ssm(cfg: ArchConfig, batch: int) -> dict[str, LeafSpec]:
    conv_s, ssm_s = S.mamba2_state_shapes(cfg, batch)
    return {"conv": LeafSpec((cfg.n_layers, *conv_s), cfg.dtype),
            "ssm": LeafSpec((cfg.n_layers, *ssm_s), torch.float32)}


def _mamba_step(blk: Params, cfg: ArchConfig, x: torch.Tensor,
                state: Params, i: int) -> torch.Tensor:
    """Layer i's decode step; its states are written IN PLACE."""
    y, conv, ssm_st = S.step_mamba2(blk["mixer"], cfg,
                                    L.rms_norm(x, blk["ln"]),
                                    state["conv"][i], state["ssm"][i])
    write_span(state["conv"], i, conv)
    write_span(state["ssm"], i, ssm_st)
    return x + y


def decode_step_ssm(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                    state: Params, lengths: torch.Tensor
                    ) -> tuple[torch.Tensor, Params, torch.Tensor]:
    """tokens (B, 1) -> (logits (B, V) f32, the state updated IN PLACE,
    lengths + 1)."""
    x = L.embed_rows(params["embed"], tokens[:, 0])         # (B, D)
    for i in range(cfg.n_layers):
        x = _mamba_step(_layer(params["blocks"], i), cfg, x, state, i)
    return _logits(params, cfg, x), state, lengths + 1


# ---------------------------------------------------------------------------
# Hybrid (zamba2)
# ---------------------------------------------------------------------------

def _n_groups(cfg: ArchConfig) -> int:
    if cfg.n_layers % cfg.attn_every:
        raise ValueError("hybrid requires n_layers % attn_every == 0")
    return cfg.n_layers // cfg.attn_every


def init_hybrid(cfg: ArchConfig, gen: torch.Generator) -> Params:
    n_groups = _n_groups(cfg)
    embed = embed_table(gen, cfg)
    stacked = _stack([_mamba_block(gen, cfg) for _ in range(cfg.n_layers)])

    def grouped(t):
        return {k: grouped(v) for k, v in t.items()} if isinstance(
            t, dict) else t.reshape(n_groups, cfg.attn_every, *t.shape[1:])

    shared = {"ln1": _zeros(cfg, gen),
              "attn": L.init_gqa(gen, cfg, cfg.dtype),
              "ln2": _zeros(cfg, gen),
              "mlp": L.init_mlp(gen, cfg, cfg.d_ff, cfg.dtype)}
    return {
        "embed": embed,
        "groups": grouped(stacked),
        "shared_attn": shared,  # ONE set of weights, applied every group
        "final_norm": _zeros(cfg, gen),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                cfg.dtype),
    }


def _shared_block(shared: Params, cfg: ArchConfig, x: torch.Tensor,
                  positions: torch.Tensor, use_kernel: bool | None
                  ) -> torch.Tensor:
    shared = gathered(shared)
    h = L.rms_norm(x, shared["ln1"])
    x = x + L.apply_gqa(shared["attn"], cfg, h, positions,
                        use_kernel=use_kernel)
    h = L.rms_norm(x, shared["ln2"])
    return x + L.apply_mlp(shared["mlp"], cfg, h)


def forward_hybrid(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                   *, remat: bool = True, use_kernel: bool | None = None
                   ) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) f32: each group's Mamba-2 layers,
    then the shared attention block (causal over arange(S))."""
    s = tokens.shape[1]
    x = act.batch_seq(L.embed_rows(params["embed"], tokens))
    positions = torch.arange(s, device=x.device)
    shared = params["shared_attn"]
    for grp in _unstack(params["groups"], _n_groups(cfg)):
        x = _mamba_layers(_unstack(grp, cfg.attn_every), cfg, x, remat)
        if remat and torch.is_grad_enabled():
            x = checkpoint(_shared_block, shared, cfg, x, positions,
                           use_kernel, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _shared_block(shared, cfg, x, positions, use_kernel)
    return _logits(params, cfg, x)


def state_spec_hybrid(cfg: ArchConfig, batch: int, max_seq: int
                      ) -> dict[str, LeafSpec]:
    kv = LeafSpec((_n_groups(cfg), batch, max_seq, cfg.n_kv_heads,
                   cfg.head_dim), cfg.dtype)
    return {**state_spec_ssm(cfg, batch), "k": kv, "v": kv}


def decode_step_hybrid(params: Params, cfg: ArchConfig,
                       tokens: torch.Tensor, state: Params,
                       lengths: torch.Tensor
                       ) -> tuple[torch.Tensor, Params, torch.Tensor]:
    """tokens (B, 1) at positions ``lengths`` -> (logits (B, V) f32, the
    state updated IN PLACE, lengths + 1).  The shared block's attention
    is ``layers.decode_attention`` over each group's own K/V cache."""
    b = tokens.shape[0]
    x = L.embed_rows(params["embed"], tokens[:, 0])         # (B, D)
    shared = params["shared_attn"]
    for g in range(_n_groups(cfg)):
        grp = _layer(params["groups"], g)
        for j in range(cfg.attn_every):
            x = _mamba_step(_layer(grp, j), cfg, x, state,
                            g * cfg.attn_every + j)
        h = L.rms_norm(x[:, None], shared["ln1"])
        q, kk, v = L.gqa_qkv(shared["attn"], cfg, h, lengths[:, None])
        k_c = write_at(state["k"][g], kk, lengths)
        v_c = write_at(state["v"][g], v, lengths)
        o = L.decode_attention(q, k_c, v_c, lengths=lengths + 1)
        x = x + o.reshape(b, -1) @ shared["attn"]["wo"]
        h = L.rms_norm(x, shared["ln2"])
        x = x + L.apply_mlp(shared["mlp"], cfg, h)
    return _logits(params, cfg, x), state, lengths + 1
