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
Under a mesh the dispatch runs in G = gcd(B, dp size) groups, one per
data shard, as ``repro``'s does.  ``apply_moe_paco_ep`` is the
expert-parallel dispatch over one mesh axis by ``all_to_all_single``.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.dist import act_sharding as act
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


def _dispatch(x: torch.Tensor, router: torch.Tensor, cfg, groups: int
              ) -> tuple[torch.Tensor, ...]:
    """Route and dispatch x (B, S, d) as ``groups`` groups of whole rows,
    each with its own capacity.  Returns (buf (G, E, cap, d), w, ids, pos
    (G, ng, k)).  Per group: top-k routing, position-in-expert from a
    stable sort of the (token, slot) stream (the PACO sort of ``repro``),
    slot-by-slot dispatch into a buffer whose extra last row is the drop
    slot."""
    m = cfg.moe
    b, s, d = x.shape
    ng = b * s // groups
    xg = x.reshape(groups, ng, d)
    cap = max(1, int(m.capacity_factor * ng * m.top_k / m.n_experts))
    cap_total = m.n_experts * cap                     # row cap_total = drop
    bufs, ws, idss, poss = [], [], [], []
    for gi in range(groups):
        w, ids = router_topk({"router": router}, cfg, xg[gi])   # (ng, k)
        flat_ids = ids.reshape(ng * m.top_k)
        sorted_ids, order = torch.sort(flat_ids, stable=True)
        starts = torch.searchsorted(
            sorted_ids, torch.arange(m.n_experts, device=x.device),
            side="left")
        rank_sorted = (torch.arange(ng * m.top_k, device=x.device)
                       - starts[sorted_ids])
        pos = torch.empty_like(rank_sorted)
        pos[order] = rank_sorted
        pos = pos.reshape(ng, m.top_k)
        keep = pos < cap
        # a kept (expert, position) row receives exactly one token, so the
        # add is a copy; dropped tokens pile into the drop row
        buf = torch.zeros(cap_total + 1, d, dtype=x.dtype, device=x.device)
        for j in range(m.top_k):
            flat_j = torch.where(keep[:, j], ids[:, j] * cap + pos[:, j],
                                 cap_total)
            buf.index_add_(0, flat_j, torch.where(keep[:, j, None], xg[gi],
                                                  0))
        bufs.append(buf[:cap_total].reshape(m.n_experts, cap, d))
        ws.append(w)
        idss.append(ids)
        poss.append(pos)
    return (torch.stack(bufs), torch.stack(ws), torch.stack(idss),
            torch.stack(poss))


def _experts(buf: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
             down: torch.Tensor) -> torch.Tensor:
    """(G, E, cap, d) -> (G, E, cap, d), each group through
    ``_expert_ffn``."""
    p = {"gate": gate, "up": up, "down": down}
    return torch.stack([_expert_ffn(p, buf[gi])
                        for gi in range(buf.shape[0])])


def _combine(x: torch.Tensor, out_e: torch.Tensor, w: torch.Tensor,
             ids: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Gather each kept (token, slot)'s expert output, weighted, summed in
    the activation dtype, as ``repro`` does -> x's shape."""
    groups, n_e, cap, d = out_e.shape
    out_flat = out_e.reshape(groups, n_e * cap, d)
    outs = []
    for gi in range(groups):
        keep = pos[gi] < cap
        out = torch.zeros(pos.shape[1], d, dtype=x.dtype, device=x.device)
        for j in range(pos.shape[2]):
            flat_j = torch.where(keep[:, j],
                                 ids[gi][:, j] * cap + pos[gi][:, j], 0)
            g = out_flat[gi][flat_j]
            out = out + torch.where(keep[:, j, None],
                                    g * w[gi][:, j, None].to(g.dtype), 0)
        outs.append(out)
    return torch.stack(outs).reshape(x.shape)


def apply_moe(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): capacity-bound dispatch in G groups,
    G = gcd(B, dp size) under a mesh (one group per data shard, each with
    its own capacity, as ``repro``) and 1 without.

    Under a mesh the routing and dispatch run on each rank's data shard,
    the experts on each rank's block of experts (E over the model axis:
    expert parallelism; an FSDP cut of the expert weights is gathered
    first), and the combine on each data shard with every expert's output
    gathered."""
    m = cfg.moe
    b, s, d = x.shape
    groups = math.gcd(b, act.dp_size()) if act.active() else 1
    rows = ("dp", None, None)

    def dispatch(x_loc, router):
        # a data shard's rows are whole groups (its cut divides G)
        return _dispatch(x_loc, router, cfg, groups * x_loc.shape[0] // b)

    buf, w, ids, pos = act.local_call(dispatch, (rows, (None, None)),
                                      (0, 0, 0, 0), x, p["router"])
    experts = ("model", None, None)
    out_e = act.local_call(_experts, (("dp", "model", None, None), experts,
                                      experts, experts),
                           0, buf, p["gate"], p["up"], p["down"])
    out = act.local_call(_combine, (rows, ("dp", None, None, None),
                                    rows, rows, rows),
                         0, x, out_e, w, ids, pos)
    if m.n_shared:
        out = out + L.apply_mlp(p["shared"], cfg, x).to(out.dtype)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# PACO expert-parallel dispatch (all_to_all over one mesh axis, Sect. III-G)
# ---------------------------------------------------------------------------

def apply_moe_paco_ep(p: Params, cfg, x: torch.Tensor, mesh, axis: str
                      ) -> torch.Tensor:
    """Expert-parallel MoE over the mesh axis ``axis`` (its size must
    divide E); top-1 routing, as ``repro``'s.

    Each rank takes its block of the batch rows of x (whole tensors alike
    on every rank, or DTensors), routes its tokens, buckets them by
    destination rank (expert id // experts per rank: the PACO sort's pivot
    step) with a fixed capacity max(1, int(capacity_factor * nb // ep)),
    exchanges the buckets with ``all_to_all_single`` (the count-matrix
    redistribution), runs its local experts, sends the results back and
    combines.  A bucket slot holds an expert id, or -1 when it is empty;
    a token past capacity is dropped (its output is 0), and only kept
    tokens write their id.  Returns a DTensor, the rows cut over
    ``axis``."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import shard_of

    m = cfg.moe
    group = mesh.get_group(axis)
    ep = dist.get_world_size(group)
    me = dist.get_rank(group)
    if m.n_experts % ep:
        raise ValueError(f"{m.n_experts} experts do not divide over {ep}")
    e_local = m.n_experts // ep
    place = act.placements(mesh, (axis,))

    def block(t: torch.Tensor) -> torch.Tensor:
        if act.is_dtensor(t):
            t = t.full_tensor()
        return shard_of(t, mesh, place).to_local()

    x_blk = block(x)
    gate, up, down = (block(p[k]) for k in ("gate", "up", "down"))
    router = act.replicate(p["router"])
    b, s, d = x_blk.shape
    nb = b * s
    xf = x_blk.reshape(nb, d)
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    wt, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    eid, wt = ids[:, 0], wt[:, 0]
    dest = eid // e_local
    cap = max(1, int(m.capacity_factor * nb // ep))
    order = torch.argsort(dest, stable=True)
    xs, eids, dests, wts = xf[order], eid[order], dest[order], wt[order]
    counts = torch.bincount(dests, minlength=ep)
    rank = torch.arange(nb, device=x_blk.device) - (torch.cumsum(counts, 0)
                                                    - counts)[dests]
    ok = rank < cap
    slot = torch.clamp(rank, max=cap - 1)
    send = torch.zeros(ep, cap, d, dtype=x_blk.dtype, device=x_blk.device)
    send.index_put_((dests, slot), torch.where(ok[:, None], xs, 0),
                    accumulate=True)
    send_eid = torch.full((ep, cap), -1, dtype=torch.int64,
                          device=x_blk.device)
    send_eid[dests[ok], slot[ok]] = eids[ok]
    recv, recv_eid = torch.empty_like(send), torch.empty_like(send_eid)
    dist.all_to_all_single(recv, send, group=group)
    dist.all_to_all_single(recv_eid, send_eid, group=group)
    # local experts: recv (ep, cap, d) tokens for this rank's e_local
    le = recv_eid - me * e_local
    le_ok = recv_eid >= 0
    onehot = F.one_hot(torch.where(le_ok, le, 0), e_local).to(
        recv.dtype) * le_ok[..., None]
    h = F.silu(torch.einsum("pce,pcd,edf->pcef", onehot, recv, gate))
    h = h * torch.einsum("pce,pcd,edf->pcef", onehot, recv, up)
    y = torch.einsum("pcef,efd->pcd", h, down).contiguous()
    back = torch.empty_like(y)
    dist.all_to_all_single(back, y, group=group)
    # un-bucket: back (ep, cap, d) is aligned with the send slots; invert
    # the counting-sort permutation
    out_sorted = torch.where(ok[:, None], back[dests, slot], 0)
    out = (out_sorted * wts[:, None].to(out_sorted.dtype))[
        torch.argsort(order)].reshape(b, s, d)
    if m.n_shared:
        shared = {k: act.replicate(v) for k, v in p["shared"].items()}
        out = out + L.apply_mlp(shared, cfg, xf).reshape(b, s, d)
    return DTensor.from_local(out, mesh, place, run_check=False,
                              shape=torch.Size((x.shape[0], s, d)),
                              stride=(s * d, d, 1))
