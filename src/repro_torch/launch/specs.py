"""Fake-tensor stand-ins for every model input, per (arch x shape) (port of
``repro.launch.specs``).

Nothing here allocates: params, optimizer state and inputs are
``FakeTensor``s made under a ``FakeTensorMode`` (shape, dtype and device;
no storage), on ``cost.trace_device()``: CUDA where this build of torch
has it.  The modality frontends are stubs, as in ``repro``: encdec's
``src_emb`` is a precomputed frame embedding.  Every function takes the
fake mode to make its tensors in (``fake_mode()`` makes one); tensors
of one step must come from one mode.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.launch import cost
from repro_torch.models import cache_spec, decode_step, forward, prefill
from repro_torch.models.model import init_params
from repro_torch.optim import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                          train_step)


def fake_mode() -> Any:
    """A ``FakeTensorMode`` for one step's tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def param_shapes(cfg: ArchConfig, mode: Any) -> Any:
    """The param tree of ``init_params`` as fake tensors."""
    with mode:
        return init_params(cfg, device=cost.trace_device())


def opt_state_shapes(cfg: ArchConfig, tcfg: TrainConfig, params: Any,
                     mode: Any) -> Any:
    """``init_train_state``'s tree (AdamW's f32 moments and step) for
    ``params``, as fake tensors."""
    with mode:
        return init_train_state(cfg, tcfg, params)


def input_specs(cfg: ArchConfig, shape: ShapeCell, mode: Any) -> dict:
    """Batch / serving inputs of one shape cell, as fake tensors: train
    {"batch": tokens, labels (and src_emb)}, prefill {"batch": tokens
    (and src_emb)}, decode {"tokens" (B, 1), "cache" of ``cache_spec``
    over seq_len (src_len seq_len), "lengths" (B,)}."""
    device = cost.trace_device()
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    with mode:
        def empty(shp, dtype):
            return torch.empty(shp, dtype=dtype, device=device)

        if shape.kind in ("train", "prefill"):
            batch = {"tokens": empty((b, s), i32)}
            if shape.kind == "train":
                batch["labels"] = empty((b, s), i32)
            if cfg.family == "encdec":
                batch["src_emb"] = empty((b, s, cfg.d_model), cfg.dtype)
            return {"batch": batch}
        return {
            "tokens": empty((b, 1), i32),
            "cache": {k: empty(v.shape, v.dtype) for k, v in
                      cache_spec(cfg, b, s, src_len=s).items()},
            "lengths": empty((b,), i32),
        }


def step_fn_for(cfg: ArchConfig, shape: ShapeCell,
                tcfg: TrainConfig | None = None) -> tuple[Callable, str]:
    """(fn, name) to trace for this cell: train -> train_step; prefill ->
    prefill (forward for SSM/hybrid, whose chunked-SSD forward *is* the
    prefill compute); decode -> decode_step (serve_step)."""
    tcfg = tcfg or TrainConfig(opt=AdamWConfig())
    if shape.kind == "train":

        def train_fn(params, state, batch):
            return train_step(params, state, batch, cfg=cfg, tcfg=tcfg)

        return train_fn, "train_step"
    if shape.kind == "prefill":
        if cfg.family in ("ssm", "hybrid"):
            def fwd_fn(params, batch):
                with torch.no_grad():
                    return forward(params, cfg, batch, remat=False)
            return fwd_fn, "prefill(forward)"

        def prefill_fn(params, batch):
            with torch.no_grad():
                return prefill(params, cfg, batch, max_seq=shape.seq_len)

        return prefill_fn, "prefill"

    def serve_fn(params, tokens, cache, lengths):
        with torch.no_grad():
            return decode_step(params, cfg, tokens, cache, lengths)

    return serve_fn, "serve_step"
