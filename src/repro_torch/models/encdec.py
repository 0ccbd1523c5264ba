"""Encoder-decoder backbone (seamless-m4t-medium), the port of
``repro.models.encdec``.

The modality frontend is a stub, as in ``repro``: the encoder takes
precomputed frame embeddings (B, S_src, d_model), the decoder target
tokens.  Cross-attention K/V are computed once from the encoder's output
and cached for decode.  On CUDA the flash kernel (kernel 5) runs three
ways: the encoder's self-attention without a mask, the decoder's causal
self-attention, and the cross-attention of S target positions against
S_src frames (Sq != Sk, no mask); training differentiates all three
through the backward kernel (kernel 5b), the cross-attention's at its own
key length.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import act_sharding as act
from repro_torch.models import layers as L
from repro_torch.models.hybrid import _logits, _zeros
from repro_torch.models.transformer import (LeafSpec, _embed, _layer, _stack,
                                            _unstack, embed_table, gathered,
                                            write_at)

Params = dict[str, Any]


def _init_xattn(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype
                ) -> Params:
    dh = cfg.head_dim
    return {
        "wq": L.dense_init(gen, cfg.d_model, cfg.n_heads * dh, dtype),
        "wk": L.dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype),
        "wv": L.dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype),
        "wo": L.dense_init(gen, cfg.n_heads * dh, cfg.d_model, dtype),
    }


def init_encdec(cfg: ArchConfig, gen: torch.Generator) -> Params:
    dtype = cfg.dtype

    def enc_block():
        return {"ln1": _zeros(cfg, gen),
                "attn": L.init_gqa(gen, cfg, dtype),
                "ln2": _zeros(cfg, gen),
                "mlp": L.init_mlp(gen, cfg, cfg.d_ff, dtype)}

    def dec_block():
        return {"ln1": _zeros(cfg, gen),
                "attn": L.init_gqa(gen, cfg, dtype),
                "lnx": _zeros(cfg, gen),
                "xattn": _init_xattn(gen, cfg, dtype),
                "ln2": _zeros(cfg, gen),
                "mlp": L.init_mlp(gen, cfg, cfg.d_ff, dtype)}

    return {
        "embed": embed_table(gen, cfg),
        "enc_blocks": _stack([enc_block() for _ in range(cfg.n_enc_layers)]),
        "dec_blocks": _stack([dec_block() for _ in range(cfg.n_layers)]),
        "enc_norm": _zeros(cfg, gen),
        "final_norm": _zeros(cfg, gen),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype),
    }


def _enc_block(blk: Params, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor, use_kernel: bool | None
               ) -> torch.Tensor:
    blk = gathered(blk)
    x = act.residual(x)
    h = L.rms_norm(x, blk["ln1"])
    x = x + L.apply_gqa(blk["attn"], cfg, h, positions, causal=False,
                        use_kernel=use_kernel)
    h = L.rms_norm(x, blk["ln2"])
    return act.residual(x + L.apply_mlp(blk["mlp"], cfg, h))


def encode(params: Params, cfg: ArchConfig, src_emb: torch.Tensor, *,
           remat: bool = True, use_kernel: bool | None = None
           ) -> torch.Tensor:
    """src_emb (B, S_src, d_model) precomputed frames -> encoder states.

    The frames are taken in the weights' dtype (cast here): ``repro``
    promotes the whole encoder to f32 when f32 frames meet bf16 weights,
    which a torch matmul of mixed dtypes does not do.  With f32 weights
    the two are the same."""
    x = act.batch_seq(src_emb.to(params["enc_norm"].dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    for blk in _unstack(params["enc_blocks"], cfg.n_enc_layers):
        if remat and torch.is_grad_enabled():
            x = checkpoint(_enc_block, blk, cfg, x, positions, use_kernel,
                           use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _enc_block(blk, cfg, x, positions, use_kernel)
    return L.rms_norm(x, params["enc_norm"])


def cross_kv(p: Params, cfg: ArchConfig, enc: torch.Tensor, *,
             keys: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross-attention K and V (B, S_src, Hkv, Dh);
    ``keys`` lays them out for the key cut (``layers.split_heads``)."""
    return (L.split_heads(enc @ p["wk"], cfg.n_kv_heads, cfg.head_dim,
                          keys=keys),
            L.split_heads(enc @ p["wv"], cfg.n_kv_heads, cfg.head_dim,
                          keys=keys))


def _cross_attention(p: Params, cfg: ArchConfig, h: torch.Tensor,
                     enc: torch.Tensor, use_kernel: bool | None = None
                     ) -> torch.Tensor:
    """Decoder states h (B, S, D) attend to every encoder state (B, S_src,
    D), no mask and no rope: ``layers.attention`` over q_positions
    arange(S) and k_positions arange(S_src), the flash kernel's Sq != Sk
    entry on CUDA."""
    b, s, _ = h.shape
    q = L.split_heads(h @ p["wq"], cfg.n_heads, cfg.head_dim)
    k, v = cross_kv(p, cfg, enc, keys=L.key_cut(cfg, enc, enc.shape[1]))
    o = L.attention(q, k, v, q_positions=torch.arange(s, device=h.device),
                    k_positions=torch.arange(enc.shape[1], device=h.device),
                    causal=False, q_chunk=cfg.q_chunk, use_kernel=use_kernel)
    return o.reshape(b, s, -1) @ p["wo"]


def _dec_block(blk: Params, cfg: ArchConfig, x: torch.Tensor,
               enc: torch.Tensor, positions: torch.Tensor,
               use_kernel: bool | None) -> torch.Tensor:
    blk = gathered(blk)
    x = act.residual(x)
    h = L.rms_norm(x, blk["ln1"])
    x = x + L.apply_gqa(blk["attn"], cfg, h, positions, causal=True,
                        use_kernel=use_kernel)
    h = L.rms_norm(x, blk["lnx"])
    x = x + _cross_attention(blk["xattn"], cfg, h, enc, use_kernel)
    h = L.rms_norm(x, blk["ln2"])
    return act.residual(x + L.apply_mlp(blk["mlp"], cfg, h))


def forward_encdec(params: Params, cfg: ArchConfig, src_emb: torch.Tensor,
                   tgt_tokens: torch.Tensor, *, remat: bool = True,
                   use_kernel: bool | None = None) -> torch.Tensor:
    """Teacher-forced forward -> logits (B, S_tgt, V) f32."""
    enc = encode(params, cfg, src_emb, remat=remat, use_kernel=use_kernel)
    x = _embed(params, cfg, tgt_tokens)
    positions = torch.arange(tgt_tokens.shape[1], device=x.device)
    for blk in _unstack(params["dec_blocks"], cfg.n_layers):
        if remat and torch.is_grad_enabled():
            x = checkpoint(_dec_block, blk, cfg, x, enc, positions,
                           use_kernel, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _dec_block(blk, cfg, x, enc, positions, use_kernel)
    return _logits(params, cfg, x)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def cache_spec_encdec(cfg: ArchConfig, batch: int, max_seq: int,
                      src_len: int) -> dict[str, LeafSpec]:
    kv = LeafSpec((cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
                   cfg.head_dim), cfg.dtype)
    xkv = LeafSpec((cfg.n_layers, batch, src_len, cfg.n_kv_heads,
                    cfg.head_dim), cfg.dtype)
    return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}


def decode_step_encdec(params: Params, cfg: ArchConfig,
                       tokens: torch.Tensor, cache: Params,
                       lengths: torch.Tensor
                       ) -> tuple[torch.Tensor, Params, torch.Tensor]:
    """One decode step, tokens (B, 1) at positions ``lengths``; the cross
    K/V are precomputed in the cache (``xk``, ``xv``).  Returns (logits
    (B, V) f32, the cache with the self-attention K/V written IN PLACE,
    lengths + 1).  Both attentions are ``layers.decode_attention``."""
    b = tokens.shape[0]
    x = _embed(params, cfg, tokens)                            # (B, 1, D)
    positions = lengths[:, None]
    src_len = cache["xk"].shape[2]
    src_lengths = torch.full((b,), src_len, dtype=torch.int32,
                             device=x.device)
    for i in range(cfg.n_layers):
        blk = _layer(params["dec_blocks"], i)
        h = L.rms_norm(x, blk["ln1"])
        q, kk, v = L.gqa_qkv(blk["attn"], cfg, h, positions)
        k_c = write_at(cache["k"][i], kk, lengths)
        v_c = write_at(cache["v"][i], v, lengths)
        o = L.decode_attention(q, k_c, v_c, lengths=lengths + 1)
        x = x + o.reshape(b, 1, -1) @ blk["attn"]["wo"]
        # cross attention against the precomputed source K/V
        h = L.rms_norm(x, blk["lnx"])
        qx = (h @ blk["xattn"]["wq"]).reshape(b, 1, cfg.n_heads,
                                              cfg.head_dim)
        ox = L.decode_attention(qx, cache["xk"][i], cache["xv"][i],
                                lengths=src_lengths)
        x = x + ox.reshape(b, 1, -1) @ blk["xattn"]["wo"]
        h = L.rms_norm(x, blk["ln2"])
        x = x + L.apply_mlp(blk["mlp"], cfg, h)
    return _logits(params, cfg, x)[:, 0], cache, lengths + 1
