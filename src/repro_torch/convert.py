"""Bridge from ``repro``'s pytrees to the port's tensors.

``from_jax`` takes the nested dict that ``repro.models.init_params``
returns, and ``train_state_from_jax`` the train state of
``repro.train.init_train_state`` (or of a later step), with every leaf
already turned into a numpy array by the caller (this module takes numpy
only, never JAX).  The port keeps ``repro``'s layouts (layer-stacked
blocks, (d_in, d_out) weights, the optimizer's f32 moments per leaf), so
the conversion is leaf by leaf.  bfloat16 leaves (numpy's ``ml_dtypes``
bfloat16, which torch cannot read) go through a uint16 view of the same
bits.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _tensor(x: np.ndarray, device: torch.device | str) -> torch.Tensor:
    """One numpy leaf -> a tensor of the same dtype, shape and bits."""
    x = np.array(x, order="C")
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x.copy())
    return t.to(device)


# Leaves of the Mamba-2 mixer that ``repro`` keeps in f32 whatever the
# model's dtype (``repro/models/ssm.py:117-119``).
F32_MIXER_LEAVES = frozenset({"a_log", "dt_bias", "d_skip"})


def _leaf(x: np.ndarray, dtype: torch.dtype,
          device: torch.device | str, path: str) -> torch.Tensor:
    t = _tensor(x, device)
    if t.dtype != dtype:
        raise TypeError(f"leaf {path} of dtype {x.dtype} where the config "
                        f"says {dtype}")
    return t


def from_jax(params: dict[str, Any], cfg: ArchConfig,
             device: torch.device | str = "cuda", _path: str = ""
             ) -> dict[str, Any]:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device``, each leaf bit-identical and of ``cfg.dtype``, except the
    Mamba-2 mixer's ``a_log``, ``dt_bias`` and ``d_skip``, which are f32 in
    every model.  Any other dtype raises."""
    out = {}
    for k, v in params.items():
        path = f"{_path}/{k}" if _path else k
        if isinstance(v, dict):
            out[k] = from_jax(v, cfg, device, path)
        else:
            f32 = (k in F32_MIXER_LEAVES
                   and _path.rsplit("/", 1)[-1] == "mixer")
            out[k] = _leaf(v, torch.float32 if f32 else cfg.dtype, device,
                           path)
    return out


def _tree(tree: dict[str, Any], device: torch.device | str) -> dict:
    return {k: _tree(v, device) if isinstance(v, dict) else _tensor(v, device)
            for k, v in tree.items()}


def train_state_from_jax(state: dict[str, Any],
                         device: torch.device | str = "cuda"
                         ) -> dict[str, Any]:
    """``repro``'s train state (numpy leaves) -> the port's: ``opt.m`` and
    ``opt.v`` (f32 trees), ``opt.step`` (int32 scalar) and, with gradient
    compression, the error buffer ``err``, all bit-identical.  ``repro``'s
    ``key`` (a ``jax.random`` key) has no counterpart in the port's
    ``torch.Generator`` stream: the port's state takes its own seed
    (``train_step.COMPRESSION_SEED``).  A JAX run resumes in the port with
    ``from_jax`` of its params and this of its state."""
    opt = state["opt"]
    out = {"opt": {"m": _tree(opt["m"], device), "v": _tree(opt["v"], device),
                   "step": _tensor(np.asarray(opt["step"], np.int32),
                                   device)}}
    if "err" in state:
        from repro_torch.train.train_step import COMPRESSION_SEED
        out["err"] = _tree(state["err"], device)
        out["key"] = torch.tensor(COMPRESSION_SEED, dtype=torch.int64)
    return out
