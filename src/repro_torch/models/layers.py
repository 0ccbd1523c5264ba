"""Layers of the port (``repro.models.layers``), as plain functions on
tensors.

Layouts follow ``repro``: activations (B, S, D), heads (B, S, H, Dh),
weights (d_in, d_out) used as ``x @ W``.  The mesh-sharding constraints of
the JAX layers are kept (``dist.act_sharding``): the identity without a
mesh, a DTensor ``redistribute`` under ``use_mesh_rules``.  Under a mesh
the attention kernels run on each rank's head shard (``local_call``), or,
where the model axis divides neither head count, on its block of keys
(``head_names``).

Dense attention over a whole sequence (``attention``) has two lowerings:
on CUDA the hand-written flash kernels (``kernels.attention.attention.
flash_attention``, differentiable through its backward kernel), and
elsewhere, or with ``use_kernel=False``, ``repro``'s chunked online-softmax
formulation.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.dist import act_sharding as act
from repro_torch.kernels.attention import attention as K
from repro_torch.kernels.attention import ref as R
from repro_torch.kernels import work

Params = dict[str, Any]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = act.summed(x).float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def mask_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mask padded logit columns (>= vocab) to -1e30, so argmax and the
    sampler see exactly the true vocab."""
    if logits.shape[-1] == vocab:
        return logits
    pos = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(pos < vocab, logits, -1e30)


def act_fn(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    if kind == "sq_relu":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens] by ``F.embedding`` (the same rows).  Under a mesh the
    table is gathered whole first: torch 2.11's DTensor has no rule for
    the ``index_put`` of an indexing's backward, nor for the backward of
    a vocab-parallel embedding (its masked partial sum)."""
    return F.embedding(tokens.long(), act.whole(table))


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device: torch.device | str | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, *, head_axis: bool = True
               ) -> torch.Tensor:
    """x: (..., S, H, Dh) -- or (..., S, Dh) with ``head_axis=False``;
    positions: (..., S).  Rotates the pairs (x[i], x[i + Dh/2]) (the
    half-split convention) in f32 and returns x's dtype.  Under a mesh
    per-row positions (decode's lengths) take the rows' layout first, so
    the angles meet x without a redistribution of their own."""
    if act.is_dtensor(positions) and positions.dim() > 1:
        positions = act.constrain(positions, "dp",
                                  *(None,) * (positions.dim() - 1))
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    ang = positions.float()[..., None] * freqs
    if head_axis:
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.float().reshape(*x.shape[:-1], 2, dh // 2)
    x1, x2 = xf[..., 0, :], xf[..., 1, :]
    # the pair dim by its positive index: torch 2.11's DTensor shifts a
    # cut on the head dim past a negative stack dim
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                      dim=x.dim() - 1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Dense attention over a whole sequence
# ---------------------------------------------------------------------------

def _is_arange(pos: torch.Tensor, n: int, start: int = 0) -> bool:
    """pos is arange(start, start + n), read unseen by the step counters;
    a fake tensor (no data) is held to its shape only."""
    if pos.dim() != 1 or pos.shape[0] != n:
        return False
    if work.is_fake(pos):
        return True
    with work.suspended():
        return bool((pos == torch.arange(start, start + n,
                                         device=pos.device)).all())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_positions: torch.Tensor, k_positions: torch.Tensor,
              causal: bool = True, window: int | None = None,
              logit_cap: float | None = None, q_chunk: int = 1024,
              scale: float | None = None,
              use_kernel: bool | None = None) -> torch.Tensor:
    """Softmax attention: q (B, Sq, Hq, Dh); k, v (B, Sk, Hkv, Dh) with
    Hq % Hkv == 0 (GQA) -> (B, Sq, Hq, Dh).

    ``use_kernel=None`` takes the flash kernels exactly when q is on CUDA;
    they take q_positions == arange(Sq) and k_positions == arange(Sk) (one
    sequence attending to itself when Sq == Sk, a cross-attention when
    not) at the default scale 1/sqrt(Dh), and any other call raises there
    (checking the positions reads them on the host).  The plain version is
    ``repro``'s chunked online-softmax formulation with its cast points
    (``ref.chunked_attention``: K/V repeated over the G query heads, f32
    scores from the stored inputs, the finite -1e30 mask, weights rounded
    to v's dtype before the PV product, f32 accumulation, ``q_chunk``
    query rows at a time).  ``repro`` also rematerializes each chunk in
    its backward; here autograd keeps each chunk's weights, and the
    model's per-layer remat bounds that to one layer."""
    if act.is_dtensor(q):
        return _sharded_attention(
            q, k, v, q_positions=q_positions, k_positions=k_positions,
            causal=causal, window=window, logit_cap=logit_cap,
            q_chunk=q_chunk, scale=scale, use_kernel=use_kernel)
    sq, dh, sk = q.shape[1], q.shape[3], k.shape[1]
    if use_kernel is None:
        use_kernel = work.on_card(q)
    if use_kernel:
        if not (_is_arange(q_positions, sq) and _is_arange(k_positions, sk)):
            raise ValueError("the flash kernels take positions arange(Sq) "
                             "and arange(Sk)")
        if scale is not None and scale != 1.0 / math.sqrt(dh):
            raise ValueError(f"the flash kernels use scale 1/sqrt({dh}), "
                             f"got {scale}")
        return K.flash_attention(q, k, v, causal=causal, window=window,
                                 logit_cap=logit_cap)
    o, _, _ = R.chunked_attention(
        q, k, v, q_positions=q_positions, k_positions=k_positions,
        causal=causal, window=window, logit_cap=logit_cap, q_chunk=q_chunk,
        scale=scale)
    return o.to(q.dtype)


def split_heads(y: torch.Tensor, h: int, d: int, *, rows: bool = True,
                keys: bool = False) -> torch.Tensor:
    """(..., h * d) -> (..., h, d).  Under a mesh the last dim is laid out
    in whole heads first (cut over the model axis only where it divides
    h; a k-cut's partial sums are added), so that the reshape splits no
    head; ``rows`` puts the leading dim over dp (activations, not
    weights).  ``keys`` lays (B, S, h * d) K or V out for the key cut of
    ``head_names`` instead: the sequence over the model axis, each rank
    every head of its own positions (a row-parallel product's partial
    sums reduce-scattered there), so that no rank holds all of K or V."""
    if act.is_dtensor(y):
        if keys:
            y = act.constrain(y, "dp", "model", *(None,) * (y.ndim - 2))
        else:
            names = (("dp",) if rows else (None,)) + (None,) * (y.ndim - 2)
            y = act.constrain(y, *names,
                              "model" if h % act.model_size() == 0 else None)
    return y.reshape(*y.shape[:-1], h, d)


def head_names(hq: int, hkv: int, sk: int) -> tuple[tuple, tuple, str]:
    """The PACO cut of the attention cuboid under the active mesh: logical
    names for q (B, Sq, Hq, D) and for k / v (B, Sk, Hkv, D), and the cut:
    ``"heads"``, ``"repeat"`` (heads, K/V first repeated over the G query
    heads of a group), ``"keys"`` or ``"whole"``.

    The port's kernels share K/V across a group's G heads, where ``repro``
    repeats K/V before cutting heads.  When the model axis divides Hkv,
    q is cut in blocks of Hq/pm heads and K/V in blocks of Hkv/pm, so
    query head h stays with KV head h // G; when it divides Hq only, K/V
    are repeated as ``repro`` does.  When it divides neither, the cut goes
    to the longest dim left, the key sequence, as in ``repro``
    (sequence-parallel attention): K/V in contiguous blocks of Sk/pm keys
    over the model axis, q whole over it.  Where the model axis does not
    divide Sk either, no cut is left (``repro``'s constraint drops it) and
    every rank attends whole."""
    pm = act.model_size()
    q_names = ("dp", None, "model", None)
    if hkv % pm == 0:
        return q_names, q_names, "heads"
    if hq % pm == 0:
        return q_names, q_names, "repeat"
    whole = ("dp", None, None, None)
    if sk % pm == 0:
        return whole, ("dp", "model", None, None), "keys"
    return whole, whole, "whole"


def key_cut(cfg, x: torch.Tensor, sk: int) -> bool:
    """Whether attention over ``sk`` keys projected from the DTensor ``x``
    takes the key cut (``head_names``), whose K and V are then laid out
    over the sequence from their projection on."""
    return act.is_dtensor(x) and head_names(
        cfg.n_heads, cfg.n_kv_heads, sk)[2] == "keys"


def repeat_kv(x: torch.Tensor, g: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv * g, D), each KV head repeated over
    its g query heads (``repeat_interleave`` by expand and reshape, which
    DTensor lays out)."""
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, g, d).reshape(b, s, h * g, d)


def _sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, q_positions: torch.Tensor,
                       k_positions: torch.Tensor, **kw) -> torch.Tensor:
    """``attention`` on DTensors, cut as ``head_names`` says.  A head cut
    runs the whole-sequence kernel (or the plain version) on each rank's
    block of heads and batch rows; a key cut runs ``_key_block_attention``
    on each rank's block of keys (K and V come laid out so from their
    projection, ``split_heads(keys=True)``), q and the output whole over
    the model axis."""
    q_names, kv_names, cut = head_names(q.shape[2], k.shape[2], k.shape[1])
    if cut == "repeat":
        g = q.shape[2] // k.shape[2]
        k, v = repeat_kv(k, g), repeat_kv(v, g)
    if cut == "keys":
        mesh = act.current_mesh()
        _, offs = act.block_of(tuple(k.shape), mesh, act.placements(
            mesh, act.spec_for(mesh, tuple(k.shape), kv_names)))
        blocks = K.KeyBlocks(mesh.get_group("model"))
        return act.local_call(
            lambda q, k, v, qp, kp: _key_block_attention(
                q, k, v, qp, kp, offs[1], blocks, **kw),
            (q_names, kv_names, kv_names, None, ("model",)), 0, q, k, v,
            q_positions, k_positions)

    def body(q, k, v, qp, kp):
        return attention(q, k, v, q_positions=qp, k_positions=kp, **kw)

    return act.local_call(body, (q_names, kv_names, kv_names, None, None),
                          0, q, k, v, q_positions, k_positions)


def _key_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_positions: torch.Tensor, k_positions: torch.Tensor,
                         k_off: int, blocks, *, causal: bool = True,
                         window: int | None = None,
                         logit_cap: float | None = None, q_chunk: int = 1024,
                         scale: float | None = None,
                         use_kernel: bool | None = None) -> torch.Tensor:
    """One rank's share of sequence-parallel attention, on local tensors:
    q (B, Sq, Hq, D) whole against this rank's block of keys k, v (B, n,
    Hkv, D) at positions ``k_positions`` (its block of them), which must
    be arange(k_off, k_off + n), and q_positions arange(Sq); the key-block
    entries (or their plain versions) and the merge across the model
    axis's ranks (``kernels.attention.attention.seq_attention``)."""
    sq, n = q.shape[1], k.shape[1]
    if not (_is_arange(q_positions, sq)
            and _is_arange(k_positions, n, k_off)):
        raise ValueError(f"sequence-parallel attention takes q positions "
                         f"arange({sq}) and this rank's key positions "
                         f"arange({k_off}, {k_off + n})")
    # every row must see some key of some block: the whole sequence's Sk
    # is the last block's end (ranks hold equal blocks)
    K._check_window(window, sq, n * act.model_size())
    return K.seq_attention(q, [k], [v], [k_off], blocks=blocks,
                           causal=causal, window=window, logit_cap=logit_cap,
                           q_chunk=q_chunk, scale=scale,
                           use_kernel=use_kernel)


# ---------------------------------------------------------------------------
# Single-token decode against a dense (non-paged) cache
# ---------------------------------------------------------------------------

def kv_cache_constrain(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) decode cache: heads over the model axis when they
    divide, else the sequence (sequence-parallel KV), as
    ``dist.sharding.cache_specs``."""
    if not act.active():
        return x
    if x.shape[2] % act.model_size() == 0:
        return act.constrain(x, "dp", None, "model", None)
    return act.constrain(x, "dp", "model", None, None)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, lengths: torch.Tensor,
                     window: int | None = None,
                     logit_cap: float | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """Single-token decode: q (B, 1, Hq, Dh) against a cache (B, S, Hkv, Dh)
    of which the first ``lengths`` (B,) positions are valid.

    ``repro``'s ``decode_attention`` op for op (it has no Pallas kernel
    here either): the cache stays in its grouped (Hkv) layout, never
    expanded over the G query heads; f32 scores from the stored inputs,
    the finite -1e30 mask ``pos < lengths`` (and ``pos >= lengths -
    window`` with a window), weights rounded to the cache's dtype before
    the PV product, f32 accumulation, the result in q's dtype.

    Under a mesh the cache is cut as ``kv_cache_constrain`` cuts it: over
    its heads, when the model axis divides Hkv, and then each rank attends
    its own heads and rows (``local_call``); else over the sequence, and
    the softmax's reductions run across ranks on DTensors, every rank
    holding all of q's heads."""
    hkv = v_cache.shape[2]
    pm = act.model_size()
    if act.is_dtensor(q) and hkv % pm == 0 and pm > 1:
        names = ("dp", None, "model", None)
        return act.local_call(
            lambda q, k, v, n: decode_attention(
                q, k, v, lengths=n, window=window, logit_cap=logit_cap,
                scale=scale),
            (names, names, names, ("dp",)), 0, q, k_cache, v_cache, lengths)
    b, _, hq, dh = q.shape
    _, s, hkv, dhv = v_cache.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    k_cache = kv_cache_constrain(k_cache)
    v_cache = kv_cache_constrain(v_cache)
    if hkv % pm:
        # the cache is cut over the sequence: every rank needs all heads
        q = act.constrain(q, "dp", None, None, None)
    qr = q.reshape(b, hkv, g, dh)
    scores = torch.einsum("bhgd,bshd->bhgs", qr.float(),
                          k_cache.float()) * scale
    scores = softcap(scores, logit_cap)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] < lengths[:, None]                      # (B, S)
    if window is not None:
        mask &= pos[None, :] >= (lengths[:, None] - window)
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", w.float(), v_cache.float())
    return out.reshape(b, 1, hq, dhv).to(q.dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(d_in, d_out) normal weights with std 1/sqrt(d_in), drawn in f32
    on the generator's device."""
    std = 1.0 / math.sqrt(d_in)
    return (torch.randn(d_in, d_out, generator=gen, device=gen.device)
            * std).to(dtype)


def init_mlp(gen: torch.Generator, cfg, d_ff: int, dtype: torch.dtype
             ) -> Params:
    p = {"down": dense_init(gen, d_ff, cfg.d_model, dtype)}
    if cfg.act in ("swiglu", "geglu"):
        p["gate"] = dense_init(gen, cfg.d_model, d_ff, dtype)
        p["up"] = dense_init(gen, cfg.d_model, d_ff, dtype)
    else:  # sq_relu / plain
        p["up"] = dense_init(gen, cfg.d_model, d_ff, dtype)
    return p


def apply_mlp(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """The MLP.  Under a mesh its hidden activations are laid out batch
    over dp and hidden features over the model axis before the down
    projection (DTensor may have cut the tokens over the model axis for
    a row-parallel gate, a cut that the down projection's flattening
    turns into a strided shard it cannot propagate)."""
    if cfg.act == "swiglu":
        h = F.silu(x @ p["gate"]) * (x @ p["up"])
    elif cfg.act == "geglu":
        h = F.gelu(x @ p["gate"], approximate="tanh") * (x @ p["up"])
    else:
        h = act_fn(cfg.act, x @ p["up"])
    h = act.constrain(h, "dp", *(None,) * (h.dim() - 2), "model")
    return h @ p["down"]


def init_gqa(gen: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    dh = cfg.head_dim
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * dh, dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * dh, dtype),
        "wo": dense_init(gen, cfg.n_heads * dh, cfg.d_model, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(dh, dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros(dh, dtype=dtype, device=gen.device)
    return p


def gqa_qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B, S, Hq, Dh), k, v (B, S, Hkv, Dh); qk-norm
    before rope, as ``repro.models.layers.gqa_qkv``."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    keys = key_cut(cfg, x, s)
    q = split_heads(x @ p["wq"], cfg.n_heads, dh)
    k = split_heads(x @ p["wk"], cfg.n_kv_heads, dh, keys=keys)
    v = split_heads(x @ p["wv"], cfg.n_kv_heads, dh, keys=keys)
    # the head layout (dh whole) before qk-norm and rope, as repro; under
    # the key cut K and V keep their sequence blocks (no rank gathers them)
    q = act.heads(q)
    if not keys:
        k, v = act.heads(k), act.heads(v)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_gqa(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              use_kernel: bool | None = None) -> torch.Tensor:
    """Grouped-query self-attention over a whole sequence: (B, S, D) ->
    (B, S, D)."""
    b, s, _ = x.shape
    q, k, v = gqa_qkv(p, cfg, x, positions)
    o = attention(q, k, v, q_positions=positions, k_positions=positions,
                  causal=causal, window=window, logit_cap=cfg.softcap_attn,
                  q_chunk=cfg.q_chunk, use_kernel=use_kernel)
    return o.reshape(b, s, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention), absorbed form
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    m = cfg.mla
    h = cfg.n_heads
    zeros = lambda n: torch.zeros(n, dtype=dtype,  # noqa: E731
                                  device=gen.device)
    return {
        "w_dq": dense_init(gen, cfg.d_model, m.q_lora, dtype),
        "q_norm": zeros(m.q_lora),
        "w_uq": dense_init(gen, m.q_lora, h * (m.qk_nope + m.qk_rope),
                           dtype),
        "w_dkv": dense_init(gen, cfg.d_model, m.kv_lora + m.qk_rope, dtype),
        "kv_norm": zeros(m.kv_lora),
        "w_uk": dense_init(gen, m.kv_lora, h * m.qk_nope, dtype),
        "w_uv": dense_init(gen, m.kv_lora, h * m.v_head, dtype),
        "wo": dense_init(gen, h * m.v_head, cfg.d_model, dtype),
    }


def mla_scale(cfg) -> float:
    """MLA softmax scale: per-head query width is qk_nope + qk_rope."""
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope + m.qk_rope)


def mla_latents(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compressed KV latents, head-free: c_kv (B, S, kv_lora) and
    k_rope (B, S, qk_rope)."""
    m = cfg.mla
    # [c_kv | k_rope] whole before it is sliced (repro's MLA rule)
    ckv_kr = act.constrain(x @ p["w_dkv"], "dp", None, None)
    c_kv = rms_norm(ckv_kr[..., :m.kv_lora], p["kv_norm"])
    k_rope = apply_rope(ckv_kr[..., m.kv_lora:], positions, cfg.rope_theta,
                        head_axis=False)
    return (act.constrain(c_kv, "dp", None, None),
            act.constrain(k_rope, "dp", None, None))


def mla_queries(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """q_nope (B, S, H, qk_nope) and roped q_rope (B, S, H, qk_rope)."""
    m = cfg.mla
    b, s, _ = x.shape
    q = rms_norm(x @ p["w_dq"], p["q_norm"]) @ p["w_uq"]
    q = act.heads(split_heads(q, cfg.n_heads, m.qk_nope + m.qk_rope))
    q_nope, q_rope = q[..., :m.qk_nope], q[..., m.qk_nope:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_absorbed_q(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Queries projected into the latent space (W_uk absorbed):
    q_lat (B, S, H, kv_lora) and q_rope (B, S, H, qk_rope).  The two stay
    separate: scores are q_lat . c_kv + q_rope . k_rope, never a concat."""
    m = cfg.mla
    q_nope, q_rope = mla_queries(p, cfg, x, positions)
    w_uk = split_heads(p["w_uk"], cfg.n_heads, m.qk_nope, rows=False)
    q_lat = torch.einsum("bshd,khd->bshk", q_nope, w_uk)
    return act.heads(q_lat.contiguous()), act.heads(q_rope.contiguous())


def mla_out(p: Params, cfg, o_lat: torch.Tensor) -> torch.Tensor:
    """Latent attention output (B, S, H, kv_lora) -> (B, S, d_model):
    expand through W_uv per head, then the output projection."""
    m = cfg.mla
    b, s = o_lat.shape[:2]
    w_uv = split_heads(p["w_uv"], cfg.n_heads, m.v_head, rows=False)
    o = torch.einsum("bshk,khd->bshd", act.heads(o_lat), w_uv)
    return o.reshape(b, s, cfg.n_heads * m.v_head) @ p["wo"]


def latent_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     c_kv: torch.Tensor, k_rope: torch.Tensor, *,
                     q_positions: torch.Tensor, k_positions: torch.Tensor,
                     scale: float, causal: bool = True) -> torch.Tensor:
    """Softmax attention against the SHARED compressed latent (absorbed
    MLA, the MQA extreme): q_lat (B, Sq, H, kv_lora), q_rope (B, Sq, H,
    qk_rope) vs head-free c_kv (B, Sk, kv_lora), k_rope (B, Sk, qk_rope)
    -> (B, Sq, H, kv_lora).  c_kv is also the value.  The cast points are
    ``repro``'s: f32 scores from the stored inputs, the finite -1e30 mask,
    softmax weights rounded to c_kv's dtype before the PV product, f32
    accumulation.  ``repro`` scans over query chunks to bound its memory;
    rows are independent, so one pass computes the same values.  Under
    a mesh each rank attends its own heads and rows against the whole
    latent (``local_call``)."""
    if act.is_dtensor(q_lat):
        qn, cn = ("dp", None, "model", None), ("dp", None, None)
        return act.local_call(
            lambda ql, qr, ck, kr, qp, kp: latent_attention(
                ql, qr, ck, kr, q_positions=qp, k_positions=kp,
                scale=scale, causal=causal),
            (qn, qn, cn, cn, None, None), 0, q_lat, q_rope, c_kv, k_rope,
            q_positions, k_positions)
    s = (torch.einsum("bqhk,bsk->bhqs", q_lat.float(), c_kv.float())
         + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), k_rope.float())
         ) * scale
    if causal:
        mask = q_positions[:, None] >= k_positions[None, :]
        s = torch.where(mask[None, None], s, -1e30)
    mx = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - mx)
    z = e.sum(dim=-1, keepdim=True)
    p_mat = (e / torch.clamp(z, min=1e-30)).to(c_kv.dtype)
    o = torch.einsum("bhqs,bsk->bqhk", p_mat.float(), c_kv.float())
    return o.to(q_lat.dtype)


def apply_mla(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor
              ) -> torch.Tensor:
    """MLA over a whole sequence with the latent kept compressed: queries
    projected into the latent space (absorbed W_uk) attend to c_kv
    directly through ``latent_attention`` (``repro`` has no Pallas kernel
    here either), then expand through W_uv."""
    q_lat, q_rope = mla_absorbed_q(p, cfg, x, positions)
    c_kv, k_rope = mla_latents(p, cfg, x, positions)
    o_lat = latent_attention(q_lat, q_rope, c_kv, k_rope,
                             q_positions=positions, k_positions=positions,
                             scale=mla_scale(cfg), causal=True)
    return mla_out(p, cfg, o_lat)


def latent_decode_attention(q_lat: torch.Tensor, q_rope: torch.Tensor,
                            c_kv: torch.Tensor, k_rope: torch.Tensor, *,
                            lengths: torch.Tensor, scale: float
                            ) -> torch.Tensor:
    """Single-token decode against a shared-latent cache (absorbed MLA):
    q_lat (B, 1, H, kv_lora), q_rope (B, 1, H, qk_rope) against head-free
    c_kv (B, S, kv_lora), k_rope (B, S, qk_rope), the first ``lengths``
    positions valid -> (B, 1, H, kv_lora).  ``repro``'s
    ``latent_decode_attention``: scores in the decomposed form q_lat . c_kv
    + q_rope . k_rope in f32, the finite -1e30 mask, weights rounded to
    c_kv's dtype before the PV product (c_kv is also the value).  Under a
    mesh each rank attends its own heads and rows against the whole
    latent cache (``local_call``)."""
    if act.is_dtensor(q_lat):
        qn, cn = ("dp", None, "model", None), ("dp", None, None)
        return act.local_call(
            lambda ql, qr, ck, kr, n: latent_decode_attention(
                ql, qr, ck, kr, lengths=n, scale=scale),
            (qn, qn, cn, cn, ("dp",)), 0, q_lat, q_rope, c_kv, k_rope,
            lengths)
    s = c_kv.shape[1]
    scores = (torch.einsum("bqhk,bsk->bhqs", q_lat.float(), c_kv.float())
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                             k_rope.float())) * scale
    pos = torch.arange(s, device=c_kv.device)
    mask = pos[None, :] < lengths[:, None]                      # (B, S)
    scores = torch.where(mask[:, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(c_kv.dtype)
    out = torch.einsum("bhqs,bsk->bqhk", w.float(), c_kv.float())
    return out.to(q_lat.dtype)
