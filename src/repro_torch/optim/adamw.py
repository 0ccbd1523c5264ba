"""AdamW with f32 moments over (possibly bf16) params, a warmup + cosine
schedule and global-norm clipping (port of ``repro.optim.adamw``).

The semantics are ``repro``'s: moments in f32, the bias-corrected update
and the decoupled weight decay applied to an f32 copy of each parameter,
the result cast back to the parameter's dtype, the step counter an int32
scalar.  Where ``repro`` donates params and state to its jitted step, the
port updates them IN PLACE under ``torch.no_grad()``; the schedule and
the clip scale stay on the parameters' device, so a step reads nothing
back to the host.  Trees are nested dicts of tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

Params = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac * lr, in f32 on the
    step's device."""
    step = step.float()
    warm = torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_opt_state(params: Params) -> dict:
    device = tree_leaves(params)[0].device
    # zeros_like keeps a DTensor leaf's layout (the moments are cut as
    # their parameter is)
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(grads: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> tuple[Params, torch.Tensor]:
    """(grads scaled so that their global norm is at most max_norm, in f32;
    the norm before clipping)."""
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Params, grads: Params,
                 state: dict) -> tuple[Params, dict, dict]:
    """One AdamW step: clip, then update each leaf of ``params`` and the
    moments of ``state`` IN PLACE (one leaf at a time, so no f32 copy of
    the whole gradient tree is held).  Returns (params, state, {"lr",
    "grad_norm"}) with the same objects."""
    gnorm = _global_norm(grads)
    clip = _clip_scale(gnorm, cfg.clip_norm)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.float() * clip
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mh = m / b1c
        vh = v / b2c
        pf = p.float()
        pf = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                        + cfg.weight_decay * pf)
        p.copy_(pf.to(p.dtype))
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
