"""Elastic scaling and fault tolerance (port of ``repro.ft.elastic``).

The PACO property that makes this work (the paper's headline): the
planner accepts an arbitrary processor count, so after losing ranks the
surviving p' re-plans with <= 1/p' + o(1) imbalance, without p' having to
divide anything.  Even-sharding frameworks idle ranks down to the next
divisor; PACO re-tiles.

``ElasticRunner`` wraps a train loop on a ``DeviceMesh``: on a change of
the rank count it rebuilds the mesh, re-plans the specs, restores the
latest checkpoint onto the new layout and continues.  Every rank of the
default group runs it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as C
from repro_torch.core.cuboid import plan_mm_1piece
from repro_torch.dist.act_sharding import replicate


def mesh_shape_for(p: int, model_axis: int | None = None
                   ) -> tuple[int, int]:
    """(data, model) of the best 2-D mesh for p ranks: the largest model
    axis up to sqrt(p) that divides p, (p, 1) for primes (still balanced,
    per Corollary 10)."""
    if model_axis is None:
        model_axis = 1
        for m in range(int(np.sqrt(p)), 0, -1):
            if p % m == 0:
                model_axis = m
                break
    return p // model_axis, model_axis


def make_mesh_for(ranks: Sequence[int] | int, model_axis: int | None = None,
                  device_type: str | None = None) -> Any:
    """Best 2-D (data, model) ``DeviceMesh`` over ``ranks`` (a list of
    global ranks, or a count: the first ones), of any count.  Every rank
    of the default group calls it, also one outside ``ranks`` (building
    the mesh's groups is collective); there it returns a mesh the rank is
    not part of."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(ranks)) if isinstance(ranks, int) else list(ranks)
    data_axis, model_axis = mesh_shape_for(len(ranks), model_axis)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.tensor(ranks[:data_axis * model_axis]).reshape(
        data_axis, model_axis)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def in_mesh(mesh: Any) -> bool:
    """Whether this rank belongs to ``mesh``."""
    return mesh.get_coordinate() is not None


@dataclasses.dataclass
class ElasticRunner:
    ckpt_dir: str
    build: Callable[[Any], dict]   # mesh -> {"params", "state", "step_fn"}
    save_every: int = 10

    def _start(self, ranks: Sequence[int]):
        mesh = make_mesh_for(ranks)
        if not in_mesh(mesh):
            return mesh, None
        ctx = self.build(mesh)
        return mesh, ctx

    def run(self, ranks: Sequence[int] | int, batches, *,
            start_step: int = 0, fail_at: int | None = None,
            surviving: int | None = None):
        """Train over ``batches`` on a mesh of ``ranks``; if ``fail_at`` is
        set, simulate losing ranks at that step and continue on the first
        ``surviving`` of them from the latest checkpoint.  Returns (params,
        state, losses); a rank left out of the mesh returns what it had
        when it left."""
        ranks = list(range(ranks)) if isinstance(ranks, int) else list(ranks)
        mesh, ctx = self._start(ranks)
        if ctx is None:
            return None, None, []
        params, state, step_fn = ctx["params"], ctx["state"], ctx["step_fn"]
        step = start_step
        last = C.latest_step(self.ckpt_dir)
        if last is not None:
            params, _ = C.restore(self.ckpt_dir, last, params)
            state, _ = C.restore(self.ckpt_dir + "_state", last, state)
            step = last
        losses: list[float] = []
        for batch in batches:
            if fail_at is not None and step == fail_at:
                # --- simulated failure: drop to the surviving ranks ------
                ranks = ranks[:surviving]
                mesh, ctx = self._start(ranks)
                if ctx is None:
                    return params, state, losses
                params, state, step_fn = (ctx["params"], ctx["state"],
                                          ctx["step_fn"])
                last = C.latest_step(self.ckpt_dir)
                assert last is not None, "failure before first checkpoint"
                params, _ = C.restore(self.ckpt_dir, last, params)
                state, _ = C.restore(self.ckpt_dir + "_state", last, state)
                step = last
                fail_at = None  # replay from the checkpoint
                continue
            params, state, metrics = step_fn(params, state, batch)
            step += 1
            losses.append(float(replicate(metrics["loss"])))
            if step % self.save_every == 0:
                C.save(self.ckpt_dir, step, params)
                C.save(self.ckpt_dir + "_state", step, state)
        return params, state, losses


def replan_report(n: int, m: int, k: int, p_before: int, p_after: int
                  ) -> dict:
    """Quantify the elastic re-plan: balance before and after a failure."""
    a = plan_mm_1piece(n, m, k, p_before)
    b = plan_mm_1piece(n, m, k, p_after)

    def imb(plan):
        v = plan.per_proc_volume()
        return (max(v) - min(v)) / (sum(v) / len(v))

    return {"p_before": p_before, "p_after": p_after,
            "imbalance_before": imb(a), "imbalance_after": imb(b),
            "even_sharding_would_idle":
                p_after - max(d for d in range(1, p_after + 1)
                              if m % d == 0 or n % d == 0)}
