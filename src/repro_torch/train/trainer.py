"""Training loop (port of ``repro.train.trainer``): data -> train step ->
metrics and checkpoints, with the same history keys and checkpoint
cadence as ``repro``'s ``Trainer``.  Runs on one device, the card unless
the caller asks for the CPU, or with ``mesh`` (a ``DeviceMesh``) on every
rank of it: params laid out by ``dist.sharding.param_specs``, each batch
by ``batch_specs``, the step under ``use_mesh_rules``."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as C
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, global_batch_rowwise
from repro_torch.dist import act_sharding as act
from repro_torch.dist import sharding as D
from repro_torch.ft.straggler import ThroughputTracker
from repro_torch.models import init_params
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          train_step)


@dataclasses.dataclass
class Trainer:
    cfg: ArchConfig
    tcfg: TrainConfig
    dcfg: DataConfig
    ckpt_dir: str | None = None
    save_every: int = 50
    log_every: int = 10
    hooks: list[Callable[[int, dict], None]] = dataclasses.field(
        default_factory=list)
    device: str = "cuda"
    mesh: Any = None

    def __post_init__(self) -> None:
        if torch.device(self.device).type == "cuda" \
                and not torch.cuda.is_available():
            raise RuntimeError(
                f"Trainer(device={self.device!r}): no CUDA device on this "
                "host; pass device='cpu' to train on the CPU")

    def init(self, seed: int = 0) -> tuple[dict, dict]:
        params = init_params(self.cfg, seed=seed, device=self.device)
        if self.mesh is not None:
            params = D.distribute(self.mesh, params, D.param_specs(
                self.cfg, params, self.mesh))
        state = init_train_state(self.cfg, self.tcfg, params)
        return params, state

    def _cm(self):
        return (act.use_mesh_rules(self.mesh) if self.mesh is not None
                else contextlib.nullcontext())

    def run(self, steps: int, *, params=None, state=None,
            start_step: int = 0) -> tuple[Any, Any, list[dict]]:
        """``steps`` train steps from ``start_step``; returns (params,
        state, history).  Each history entry holds the step, the step's
        metrics as floats, and ``step_time_s``: host clock around the step,
        after ``torch.cuda.synchronize()`` on the card (else it would time
        the launches, not the step)."""
        if params is None:
            params, state = self.init()
        on_card = torch.device(self.device).type == "cuda"
        history: list[dict] = []
        tracker = ThroughputTracker(n_hosts=1)
        for step in range(start_step, start_step + steps):
            batch = global_batch_rowwise(self.dcfg, step,
                                         d_model=self.cfg.d_model,
                                         device=self.device)
            if self.mesh is not None:
                batch = D.distribute(self.mesh, batch, D.batch_specs(
                    self.cfg, self.mesh, batch))
            t0 = time.perf_counter()
            with self._cm():
                params, state, metrics = train_step(
                    params, state, batch, cfg=self.cfg, tcfg=self.tcfg)
            if on_card:
                torch.cuda.synchronize(self.device)
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics["step_time_s"] = time.perf_counter() - t0
            tracker.update(np.array([metrics["step_time_s"]]))
            history.append({"step": step, **metrics})
            for hook in self.hooks:
                hook(step, metrics)
            if (self.log_every and step % self.log_every == 0
                    and (self.mesh is None or torch.distributed.get_rank()
                         == 0)):
                print(f"step {step:5d} loss {metrics['loss']:.4f} "
                      f"lr {metrics.get('lr', 0):.2e} "
                      f"{metrics['step_time_s'] * 1e3:.0f} ms")
            if (self.ckpt_dir and self.save_every
                    and (step + 1) % self.save_every == 0):
                C.save(self.ckpt_dir, step + 1, params)
                C.save(self.ckpt_dir + "_state", step + 1, state)
        return params, state, history
