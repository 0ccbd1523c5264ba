"""Mamba-2 / SSD (state-space duality) mixer [arXiv:2405.21060], the port
of ``repro.models.ssm``.

Chunked SSD: within a chunk the recurrence is a masked attention-like
quadratic form; across chunks the states propagate through a log-space
cumulative-decay product.  Decode keeps (conv_state, ssm_state) per layer
and advances one token in O(d_state * d_inner).

The SSD always runs in f32, as in ``repro``: the ``ssm`` state is f32, the
conv state is in the model's dtype.  ``repro`` writes the chunked scan as
three- and four-operand ``einsum``s; here each is the sequence of pairwise
contractions ``jnp.einsum`` takes for them (opt_einsum's optimal path at
these shapes), so that no larger intermediate appears.  The largest is
the intra-chunk score tensor (B, c, l, l, H) of ``ssd_chunked`` (c chunks
of l positions, H heads): at zamba2-7b's widths (H 112, chunk 256) it is
B x S x 256 x 112 f32 values, 235 MB a sequence of 2048 tokens.  No
Pallas kernel runs here in ``repro``, so these are torch operations on the
card too.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.dist import act_sharding as act

Params = dict[str, Any]


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k] for
    i >= j, -inf elsewhere."""
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -math.inf)


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int, h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.  x: (B, S, H, P); a: (B, S, H) log-decay (dt * A, negative);
    b, c: (B, S, G, N) with H % G == 0.  Returns (y (B, S, H, P),
    final_state (B, H, P, N)).  Under a mesh each rank scans its own rows
    and block of heads (``_on_head_blocks``)."""
    if act.is_dtensor(x):
        if h0 is None:
            h0 = torch.zeros((x.shape[0], x.shape[2], x.shape[3],
                              b.shape[3]), dtype=x.dtype, device=x.device)
        hn, gn = _head_names(x.shape[2], b.shape[2])
        return act.local_call(
            lambda *t: ssd_chunked(*t[:4], chunk, t[4]),
            (("dp", None, hn, None), ("dp", None, hn), ("dp", None, gn, None),
             ("dp", None, gn, None), ("dp", hn, None, None)), (0, 4),
            x, a, b, c, h0)
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    xr = x.reshape(bs, nc, chunk, h, p)
    ar = a.reshape(bs, nc, chunk, h).permute(0, 3, 1, 2)      # (B, H, c, l)
    br_h = b.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cr_h = c.reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    a_cum = torch.cumsum(ar, dim=-1)                          # (B, H, c, l)

    # 1) intra-chunk (diagonal blocks): "bclhn,bcshn,bhcls,bcshp->bclhp"
    # as C B^T over n, times the decay mask, then over s with x
    lmat = act.constrain(torch.exp(segsum(ar)),
                         "dp", "model", None, None, None)     # (B,H,c,l,l)
    scores = torch.einsum("bclhn,bcshn->bclsh", cr_h, br_h)   # (B,c,l,l,H)
    scores = scores * lmat.permute(0, 2, 3, 4, 1)
    y_diag = act.constrain(torch.einsum("bclsh,bcshp->bclhp", scores, xr),
                           "dp", None, None, "model", None)
    del scores
    # 2) per-chunk output states: "bclhn,bhcl,bclhp->bchpn" as the decay
    # times x first, then over l with B
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)         # (B, H, c, l)
    xd = decay_states.permute(0, 2, 3, 1)[..., None] * xr     # (B,c,l,H,P)
    states = act.constrain(torch.einsum("bclhn,bclhp->bchpn", br_h, xd),
                           "dp", None, "model", None, None)
    # 3) inter-chunk recurrence (includes the initial state h0)
    if h0 is None:
        h0 = torch.zeros((bs, h, p, n), dtype=x.dtype, device=x.device)
    states = torch.cat([h0[:, None], states], dim=1)
    chunk_decay = a_cum[..., -1]                              # (B, H, c)
    dmat = torch.exp(segsum(F.pad(chunk_decay, (1, 0))))      # (B,H,c+1,c+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", dmat, states)
    states_in, final = new_states[:, :-1], new_states[:, -1]
    # 4) state -> output within each chunk: "bclhn,bchpn,bhcl->bclhp" as C
    # against the states over n, then the decay
    state_decay = torch.exp(a_cum)                            # (B, H, c, l)
    y_off = act.constrain(
        torch.einsum("bclhn,bchpn->bclhp", cr_h, states_in)
        * state_decay.permute(0, 2, 3, 1)[..., None],
        "dp", None, None, "model", None)
    y = (y_diag + y_off).reshape(bs, s, h, p)
    return y, final


def _head_names(h: int, g: int) -> tuple[str | None, str | None]:
    """Logical names of the SSM's head and group dims under the active
    mesh: heads over the model axis when it divides them and the groups
    (one group whole on every rank, or groups cut alongside their heads),
    else both whole."""
    pm = act.model_size()
    if h % pm or (g > 1 and g % pm):
        return None, None
    return "model", ("model" if g > 1 else None)


def ssd_step(h_prev: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  h_prev (B, H, P, N); x (B, H, P); a (B, H);
    b, c (B, G, N).  Returns (y (B, H, P), h_new).  Under a mesh on each
    rank's rows and block of heads."""
    if act.is_dtensor(h_prev) or act.is_dtensor(x):
        hn, gn = _head_names(h_prev.shape[1], b.shape[1])
        return act.local_call(
            ssd_step, (("dp", hn, None, None), ("dp", hn, None), ("dp", hn),
                       ("dp", gn, None), ("dp", gn, None)), (1, 0),
            h_prev, x, a, b, c)
    rep = h_prev.shape[1] // b.shape[1]
    bh = b.repeat_interleave(rep, dim=1)                      # (B, H, N)
    ch = c.repeat_interleave(rep, dim=1)
    decay = torch.exp(a)[..., None, None]                     # (B, H, 1, 1)
    h_new = decay * h_prev + x[..., None] * bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h_new, ch)
    return y, h_new


# ---------------------------------------------------------------------------
# Mamba-2 block (in_proj -> conv -> SSD -> gated norm -> out_proj)
# ---------------------------------------------------------------------------

def _dims(cfg) -> tuple[int, int, int]:
    """(d_inner, n_groups * d_state, n_heads)."""
    m = cfg.ssm
    d_in = m.expand * cfg.d_model
    return d_in, m.n_groups * m.d_state, d_in // m.headdim


def init_mamba2(gen: torch.Generator, cfg, dtype: torch.dtype) -> Params:
    """``repro``'s shapes and scales; ``a_log``, ``dt_bias`` and ``d_skip``
    stay f32 whatever the model's dtype."""
    m = cfg.ssm
    d_in, gn, nheads = _dims(cfg)
    d_proj = 2 * d_in + 2 * gn + nheads
    std = 1.0 / math.sqrt(cfg.d_model)
    dev = gen.device

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    return {
        "in_proj": (normal(cfg.d_model, d_proj) * std).to(dtype),
        "conv_w": (normal(m.conv_width, d_in + 2 * gn) * 0.1).to(dtype),
        "a_log": torch.zeros(nheads, dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(nheads, dtype=torch.float32, device=dev),
        "d_skip": torch.ones(nheads, dtype=torch.float32, device=dev),
        "norm": torch.zeros(d_in, dtype=dtype, device=dev),
        "out_proj": (normal(d_in, cfg.d_model) * std).to(dtype),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    d_in, gn, nheads = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * gn]
    dt = zxbcdt[..., 2 * d_in + 2 * gn:]
    assert dt.shape[-1] == nheads
    return z, xbc, dt


def _gate_out(p: Params, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    from repro_torch.models.layers import rms_norm
    return rms_norm(y * F.silu(z), p["norm"]) @ p["out_proj"]


def apply_mamba2(p: Params, cfg, u: torch.Tensor) -> torch.Tensor:
    """u: (B, S, d_model) -> (B, S, d_model); the training / prefill path."""
    m = cfg.ssm
    bs, s, _ = u.shape
    d_in, gn, nheads = _dims(cfg)
    z, xbc, dt = _split_proj(cfg, act.constrain(u @ p["in_proj"], "dp",
                                                *(None,) * (u.dim() - 2),
                                                "model"))
    # causal depthwise conv over (x, B, C), in repro's order of sums
    w = p["conv_w"]                                           # (W, d_in+2gn)
    pad = F.pad(xbc, (0, 0, m.conv_width - 1, 0))
    conv = sum(pad[:, i:i + s] * w[i] for i in range(m.conv_width))
    conv = F.silu(conv)
    x = act.constrain(conv[..., :d_in].reshape(bs, s, nheads, m.headdim),
                      "dp", None, "model", None)
    b = conv[..., d_in:d_in + gn].reshape(bs, s, m.n_groups, m.d_state)
    c = conv[..., d_in + gn:].reshape(bs, s, m.n_groups, m.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (B, S, H)
    a = -torch.exp(p["a_log"])[None, None] * dt               # log decay
    y, _ = ssd_chunked((x * dt[..., None]).float(), a, b.float(), c.float(),
                       min(m.chunk, s))
    y = y + x.float() * p["d_skip"][None, None, :, None]
    return _gate_out(p, y.reshape(bs, s, d_in).to(u.dtype), z)


def mamba2_state_shapes(cfg, batch: int) -> tuple[tuple, tuple]:
    m = cfg.ssm
    d_in, gn, nheads = _dims(cfg)
    return ((batch, m.conv_width - 1, d_in + 2 * gn),
            (batch, nheads, m.headdim, m.d_state))


def step_mamba2(p: Params, cfg, u: torch.Tensor, conv_state: torch.Tensor,
                ssm_state: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode.  u: (B, d_model); conv_state (B, W - 1, C) in
    the model's dtype; ssm_state (B, H, P, N) f32.  Returns (y (B,
    d_model), new conv_state, new ssm_state)."""
    m = cfg.ssm
    bs = u.shape[0]
    d_in, gn, nheads = _dims(cfg)
    z, xbc, dt = _split_proj(cfg, act.constrain(u @ p["in_proj"], "dp",
                                                *(None,) * (u.dim() - 2),
                                                "model"))
    window = torch.cat([conv_state, xbc[:, None]], dim=1)
    conv = F.silu(torch.einsum("bwc,wc->bc", window, p["conv_w"]))
    new_conv_state = window[:, 1:]
    x = conv[..., :d_in].reshape(bs, nheads, m.headdim)
    b = conv[..., d_in:d_in + gn].reshape(bs, m.n_groups, m.d_state)
    c = conv[..., d_in + gn:].reshape(bs, m.n_groups, m.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (B, H)
    a = -torch.exp(p["a_log"])[None] * dt
    y, h_new = ssd_step(ssm_state.float(), (x * dt[..., None]).float(), a,
                        b.float(), c.float())
    y = y + x.float() * p["d_skip"][None, :, None]
    y = _gate_out(p, y.reshape(bs, d_in).to(u.dtype), z)
    return y, new_conv_state, h_new.to(ssm_state.dtype)
