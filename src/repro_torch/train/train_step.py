"""The train step: loss -> grads -> (optional compression) -> AdamW (port
of ``repro.train.train_step``).

PyTorch runs it eagerly: autograd takes the gradient of ``loss_fn`` with
respect to every parameter leaf, and ``adamw_update`` then writes params
and optimizer state IN PLACE, where ``repro`` donates both to its jitted
step.  Gradient accumulation over ``microbatches`` slices sums the slices'
gradients in f32 and divides, as ``repro``'s scan does.

On a mesh the params (and the optimizer moments made from them) are
DTensors laid out by ``dist.sharding.param_specs`` and the batch by
``batch_specs``: the step runs under ``use_mesh_rules``, each gradient is
reduced to its parameter's layout (the data-parallel sum), AdamW updates
the DTensor leaves in place, and the metrics come back whole on every
rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import act_sharding as act
from repro_torch.models import loss_fn
from repro_torch.optim import (AdamWConfig, adamw_update, compress_grads,
                               init_error_buffer, init_opt_state)
from repro_torch.optim.adamw import tree_leaves, tree_map

Params = Any
COMPRESSION_SEED = 17   # repro's jax.random.PRNGKey(17)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    remat: bool = True
    compress_dp_grads: bool = False


def init_train_state(cfg: ArchConfig, tcfg: TrainConfig, params: Params
                     ) -> dict:
    """{"opt": AdamW state} plus, with compression, the error buffer and
    ``key``: an int64 CPU scalar that seeds each step's noise generator
    (and counts up by one per step)."""
    state = {"opt": init_opt_state(params)}
    if tcfg.compress_dp_grads:
        state["err"] = init_error_buffer(params)
        state["key"] = torch.tensor(COMPRESSION_SEED, dtype=torch.int64)
    return state


def _value_and_grad(params: Params, cfg: ArchConfig, tcfg: TrainConfig,
                    batch: dict
                    ) -> tuple[torch.Tensor, dict, list[torch.Tensor]]:
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)
    loss, metrics = loss_fn(tracked, cfg, batch, remat=tcfg.remat)
    grads = torch.autograd.grad(loss, leaves)
    # each gradient in its parameter's layout: a Partial (data-parallel
    # or k-cut) gradient is summed here
    grads = [g.redistribute(p.device_mesh, p.placements)
             if act.is_dtensor(g) and g.placements != p.placements else g
             for g, p in zip(grads, leaves)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            list(grads))


def _grads(params: Params, cfg: ArchConfig, tcfg: TrainConfig, batch: dict
           ) -> tuple[torch.Tensor, dict, Params]:
    if tcfg.microbatches <= 1:
        loss, metrics, grads = _value_and_grad(params, cfg, tcfg, batch)
    else:
        mb = tcfg.microbatches
        rows = next(iter(batch.values())).shape[0]
        if rows % mb:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{mb} microbatches")
        acc = [torch.zeros_like(p, dtype=torch.float32)
               for p in tree_leaves(params)]
        loss_sum = None
        for i in range(mb):
            sl = slice(i * rows // mb, (i + 1) * rows // mb)
            loss, _, g = _value_and_grad(
                params, cfg, tcfg, {k: v[sl] for k, v in batch.items()})
            for a, gi in zip(acc, g):
                a += gi.float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads = [a / mb for a in acc]
        loss = loss_sum / mb
        metrics = {"nll": loss}
    it = iter(grads)
    return loss, metrics, tree_map(lambda _: next(it), params)


def train_step(params: Params, state: dict, batch: dict, *,
               cfg: ArchConfig, tcfg: TrainConfig
               ) -> tuple[Params, dict, dict]:
    """One step.  Returns (params, state, metrics) with params and the
    optimizer state updated in place; metrics are 0-d tensors ("loss",
    the loss function's metrics, "lr", "grad_norm").  Attention takes the
    flash kernels when the params are on CUDA.  With DTensor params the
    step runs under their mesh's rules (unless a mesh is bound already)
    and the metrics come back whole, plain tensors on every rank."""
    lead = tree_leaves(params)[0]
    meshed = act.is_dtensor(lead)
    with (act.use_mesh_rules(lead.device_mesh)
          if meshed and not act.active() else contextlib.nullcontext()):
        params, state, metrics = _step(params, state, batch, cfg, tcfg)
    if meshed:
        metrics = {k: act.replicate(v) for k, v in metrics.items()}
    return params, state, metrics


def _step(params: Params, state: dict, batch: dict, cfg: ArchConfig,
          tcfg: TrainConfig) -> tuple[Params, dict, dict]:
    loss, metrics, grads = _grads(params, cfg, tcfg, batch)
    if tcfg.compress_dp_grads:
        device = tree_leaves(params)[0].device
        gen = torch.Generator(device=device).manual_seed(int(state["key"]))
        grads, err = compress_grads(grads, state["err"], gen)
        state = dict(state, err=err, key=state["key"] + 1)
    params, opt, om = adamw_update(tcfg.opt, params, grads, state["opt"])
    state = dict(state, opt=opt)
    return params, state, {"loss": loss, **metrics, **om}
