"""Weight bridge: ``repro``'s parameter pytree -> the port's tensors.

``from_jax`` takes the nested dict that ``repro.models.init_params``
returns, with every leaf already turned into a numpy array by the caller
(this module takes numpy only, never JAX).  The port keeps ``repro``'s
layout (layer-stacked blocks, (d_in, d_out) weights), so the conversion is
leaf by leaf.  bfloat16 leaves (numpy's ``ml_dtypes`` bfloat16, which torch
cannot read) go through a uint16 view of the same bits.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _leaf(x: np.ndarray, dtype: torch.dtype,
          device: torch.device | str) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x.copy())
    if t.dtype != dtype:
        raise TypeError(f"leaf of dtype {x.dtype} where the config says "
                        f"{dtype}")
    return t.to(device)


def from_jax(params: dict[str, Any], cfg: ArchConfig,
             device: torch.device | str = "cuda") -> dict[str, Any]:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device``, each leaf bit-identical and of ``cfg.dtype``."""
    return {k: (from_jax(v, cfg, device) if isinstance(v, dict)
                else _leaf(v, cfg.dtype, device))
            for k, v in params.items()}
