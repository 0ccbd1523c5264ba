"""The train step: loss -> grads -> (optional compression) -> AdamW (port
of ``repro.train.train_step``).

PyTorch runs it eagerly: autograd takes the gradient of ``loss_fn`` with
respect to every parameter leaf, and ``adamw_update`` then writes params
and optimizer state IN PLACE, where ``repro`` donates both to its jitted
step.  Gradient accumulation over ``microbatches`` slices sums the slices'
gradients in f32 and divides, as ``repro``'s scan does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
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
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
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
    flash kernels when the params are on CUDA."""
    loss, metrics, grads = _grads(params, cfg, tcfg, batch)
    if tcfg.compress_dp_grads:
        device = tree_leaves(params)[0].device
        gen = torch.Generator(device=device).manual_seed(int(state["key"]))
        grads, err = compress_grads(grads, state["err"], gen)
        state = dict(state, err=err, key=state["key"] + 1)
    params, opt, om = adamw_update(tcfg.opt, params, grads, state["opt"])
    state = dict(state, opt=opt)
    return params, state, {"loss": loss, **metrics, **om}
