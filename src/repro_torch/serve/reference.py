"""Single-request reference decode, the engine's parity oracle (port of
``repro.serve.reference``).

A path independent of the serving engine: no KV cache at all.  Each
generated token re-runs a dense forward over the whole context with the
dense oracle attention (``kernels.attention.ref.attention_ref``) and takes
the greedy argmax of the last position.  O(steps * ctx^2): meant for
checks, at test scale on the CPU and for a few requests on the card.  It
runs on the device its params are on.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.transformer import _NO_WINDOW, _layer, _layer_windows

Params = dict[str, Any]


def mla_materialized_qkv(p: Params, cfg: ArchConfig, x: torch.Tensor,
                         positions: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Naive uncompressed MLA: per-head k and v materialized from the
    latent, k[b, s, h] = [W_uk c_kv | k_rope] and v[b, s, h] = W_uv c_kv,
    the textbook form the absorbed-W_uk serving path is algebraically
    equal to.  Returns q, k (B, S, H, qk_nope + qk_rope) and v (B, S, H,
    v_head)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = L.mla_queries(p, cfg, x, positions)
    c_kv, k_rope = L.mla_latents(p, cfg, x, positions)
    w_uk = p["w_uk"].reshape(m.kv_lora, h, m.qk_nope)
    w_uv = p["w_uv"].reshape(m.kv_lora, h, m.v_head)
    k_nope = torch.einsum("bsk,khd->bshd", c_kv, w_uk)
    v = torch.einsum("bsk,khd->bshd", c_kv, w_uv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, m.qk_rope)],
                  dim=-1)
    return q, k, v


def forward_ref(params: Params, cfg: ArchConfig, tokens: torch.Tensor
                ) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V) f32 by a plain per-layer loop with
    the oracle attention and no cache.  MLA archs run the uncompressed
    formulation (materialized per-head k and v)."""
    if cfg.family != "decoder" or cfg.attn not in ("gqa", "mla"):
        raise NotImplementedError(
            "reference decode covers GQA/MLA decoders (the paged-engine "
            "scope)")
    b, s = tokens.shape
    emb = params["embed"]
    x = emb[tokens] * torch.tensor(math.sqrt(cfg.d_model), dtype=emb.dtype,
                                   device=emb.device)
    positions = torch.arange(s, device=x.device)
    windows = _layer_windows(cfg, cfg.n_layers)
    for i in range(cfg.n_layers):
        blk = _layer(params["blocks"], i)
        window = None if windows[i] == _NO_WINDOW else windows[i]
        h = L.rms_norm(x, blk["ln1"])
        if cfg.attn == "mla":
            q, k, v = mla_materialized_qkv(blk["attn"], cfg, h, positions)
        else:
            q, k, v = L.gqa_qkv(blk["attn"], cfg, h, positions)
        o = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True, window=window,
                          logit_cap=cfg.softcap_attn)
        a = o.transpose(1, 2).reshape(b, s, -1) @ blk["attn"]["wo"]
        if "ln1_post" in blk:
            a = L.rms_norm(a, blk["ln1_post"])
        x = x + a
        h = L.rms_norm(x, blk["ln2"])
        f = (M.apply_moe(blk["mlp"], cfg, h) if cfg.moe
             else L.apply_mlp(blk["mlp"], cfg, h))
        if "ln2_post" in blk:
            f = L.rms_norm(f, blk["ln2_post"])
        x = x + f
    x = L.rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return L.mask_vocab(L.softcap((x @ head).float(), cfg.softcap_logits),
                        cfg.vocab)


def reference_decode(params: Params, cfg: ArchConfig, prompt: list[int], *,
                     max_new_tokens: int, eos_id: int = -1,
                     max_seq: int = 128) -> list[int]:
    """Greedy decode of one request with the engine's retirement rule: stop
    after max_new_tokens, on emitting eos_id, or when the context (prompt +
    generated) reaches max_seq."""
    device = params["embed"].device
    ctx = list(prompt)
    out: list[int] = []
    while len(out) < max_new_tokens and len(ctx) < max_seq:
        logits = forward_ref(params, cfg, torch.tensor(
            [ctx], dtype=torch.int32, device=device))
        tok = int(logits[0, -1].argmax())
        out.append(tok)
        ctx.append(tok)
        if tok == eos_id:
            break
    return out
