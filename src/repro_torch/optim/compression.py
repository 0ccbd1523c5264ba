"""Gradient compression for the data-parallel all-reduce: int8 stochastic
quantization with error feedback (port of ``repro.optim.compression``).

The compressor maps grads -> (compressed-then-decompressed grads, new
error buffer); the residual carries to the next step.  The rounding noise
comes from a ``torch.Generator``, so its numbers differ from ``repro``'s
``jax.random`` stream for the same seed: the scheme, not the bits, is the
same.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map

Params = Any


def init_error_buffer(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quant_dequant_int8(x: torch.Tensor, gen: torch.Generator
                        ) -> torch.Tensor:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    noise = torch.rand(x.shape, generator=gen, device=x.device) - 0.5
    q = torch.clamp(torch.round(x / scale + noise), -127, 127)
    return q * scale


def compress_grads(grads: Params, err: Params, gen: torch.Generator
                   ) -> tuple[Params, Params]:
    """Returns (decompressed grads to apply, updated error buffer); the
    noise of each leaf is drawn from ``gen`` in leaf order."""
    out, new_err = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        target = g.float() + e
        deq = _quant_dequant_int8(target, gen)
        out.append(deq.to(g.dtype))
        new_err.append(target - deq)
    it_out, it_err = iter(out), iter(new_err)
    return (tree_map(lambda _: next(it_out), grads),
            tree_map(lambda _: next(it_err), grads))


def compressed_bytes(params: Params) -> tuple[int, int]:
    """(raw fp32 bytes, int8+scale bytes) for the DP gradient payload."""
    leaves = tree_leaves(params)
    raw = sum(x.numel() * 4 for x in leaves)
    comp = sum(x.numel() * 1 + 4 for x in leaves)
    return raw, comp
