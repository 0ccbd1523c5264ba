"""Mixture-of-Experts layer (port of the single-device path of
``repro.models.moe``): softmax top-k router over routed experts, sort-based
capacity dispatch, a SwiGLU per expert, and optional always-on shared
experts.

On one device ``repro``'s activation sharding is inactive, so all tokens
form one dispatch group (G = 1).  The dispatch keeps ``repro``'s exact
semantics: f32 router softmax, top-k renormalized, capacity
``max(1, int(capacity_factor * n * top_k / n_experts))``, position-in-
expert from a stable sort of the (token, slot) stream, tokens at or past
capacity dropped, slot-by-slot dispatch into a buffer whose extra last row
is the drop slot, and a combine in the activation dtype.  The expert
products are plain batched matmuls, as ``repro`` leaves them to XLA.
``apply_moe_paco_ep`` (expert parallelism over a mesh) is not ported yet.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Params = dict[str, Any]


def init_moe(gen: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    m = cfg.moe
    e, d, f = m.n_experts, cfg.d_model, m.d_ff_expert
    std = 1.0 / math.sqrt(d)

    def w(*shape):
        return (torch.randn(*shape, generator=gen, device=gen.device)
                * std).to(dtype)

    p = {"router": w(d, e), "gate": w(e, d, f), "up": w(e, d, f),
         "down": w(e, f, d)}
    if m.n_shared:
        p["shared"] = L.init_mlp(gen, cfg, m.d_ff_expert * m.n_shared, dtype)
    return p


def router_topk(p: Params, cfg, x: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, d) -> (weights (N, k) f32, ids (N, k) int64); weights
    renormalized over the k chosen experts.  Ties go to the lower expert
    id, as ``jax.lax.top_k`` breaks them (a stable descending sort;
    ``torch.topk`` promises no order among equal values)."""
    m = cfg.moe
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :m.top_k], ids[:, :m.top_k]
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, ids


def aux_load_balance_loss(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss: n_experts * sum over
    experts of (share of top-k choices) * (mean router probability), over
    top_k.  x (N, d); the choices take ``router_topk``'s tie rule (lower
    expert id first), and only the probabilities carry a gradient."""
    m = cfg.moe
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    ids = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :m.top_k]
    frac = F.one_hot(ids, m.n_experts).float().mean(dim=(0, 1))
    return m.n_experts * torch.sum(frac * probs.mean(0)) / m.top_k


def _expert_ffn(p: Params, xs: torch.Tensor) -> torch.Tensor:
    """xs (E, C, d) -> (E, C, d); SwiGLU per expert."""
    h = F.silu(torch.bmm(xs, p["gate"])) * torch.bmm(xs, p["up"])
    return torch.bmm(h, p["down"])


def apply_moe(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): capacity-bound dispatch of all B*S tokens
    as one group."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    xg = x.reshape(n, d)
    w, ids = router_topk(p, cfg, xg)                  # (n, k)
    cap = max(1, int(m.capacity_factor * n * m.top_k / m.n_experts))
    cap_total = m.n_experts * cap                     # row cap_total = drop
    # Position-in-expert (the PACO sort of repro): bucket the (token, slot)
    # stream by expert with a stable sort; rank = index - bucket start.
    flat_ids = ids.reshape(n * m.top_k)
    sorted_ids, order = torch.sort(flat_ids, stable=True)
    starts = torch.searchsorted(
        sorted_ids, torch.arange(m.n_experts, device=x.device), side="left")
    rank_sorted = (torch.arange(n * m.top_k, device=x.device)
                   - starts[sorted_ids])
    pos = torch.empty_like(rank_sorted)
    pos[order] = rank_sorted
    pos = pos.reshape(n, m.top_k)
    keep = pos < cap

    # Dispatch slot by slot: a kept (expert, position) row receives exactly
    # one token, so the add is a copy; dropped tokens pile into the drop row.
    buf = torch.zeros(cap_total + 1, d, dtype=x.dtype, device=x.device)
    for j in range(m.top_k):
        flat_j = torch.where(keep[:, j], ids[:, j] * cap + pos[:, j],
                             cap_total)
        buf.index_add_(0, flat_j, torch.where(keep[:, j, None], xg, 0))
    out_e = _expert_ffn(p, buf[:cap_total].reshape(m.n_experts, cap, d))
    out_e = out_e.reshape(cap_total, d)

    # Combine in the activation dtype, as repro does.
    out = torch.zeros(n, d, dtype=x.dtype, device=x.device)
    for j in range(m.top_k):
        flat_j = torch.where(keep[:, j], ids[:, j] * cap + pos[:, j], 0)
        g = out_e[flat_j]
        out = out + torch.where(keep[:, j, None],
                                g * w[:, j, None].to(g.dtype), 0)
    if m.n_shared:
        out = out + L.apply_mlp(p["shared"], cfg, xg).to(out.dtype)
    return out.reshape(b, s, d).to(x.dtype)
