"""Layer-to-stage pipeline partitioning over one mesh axis (port of
``repro.dist.pipeline``).

``stage_ranges`` applies the 1-piece balanced-partition rule (the
floor(p/2):ceil(p/2) processor split of ``core.cuboid.plan_mm_1piece``) to
the 1-D layer interval: stages are contiguous, cover every layer, and
differ in size by at most one for ANY (n_layers, n_stages), primes
included.

``pipeline_apply`` runs a GPipe forward schedule: each rank on the
pipeline axis owns one stage's layer slice, microbatch t enters stage 0 at
step t, activations hop one stage per step (``batch_isend_irecv``, where
``repro`` uses ``ppermute``), and the last stage broadcasts its outputs.
Total steps = M + S - 1 (the GPipe bubble).
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.dist.act_sharding import is_dtensor
from repro_torch.dist.sharding import tree_map


def stage_ranges(n_layers: int, n_stages: int) -> list[tuple[int, int]]:
    """Contiguous half-open layer ranges [lo, hi) per stage, PACO-balanced:
    max stage size - min stage size <= 1 for any inputs."""
    if not 1 <= n_stages:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")

    def rec(lo: int, hi: int, p: int) -> list[tuple[int, int]]:
        if p == 1:
            return [(lo, hi)]
        pl = p // 2  # floor:ceil processor split, layers cut by the ratio
        cut = lo + ((hi - lo) * pl) // p
        return rec(lo, cut, pl) + rec(cut, hi, p - pl)

    return rec(0, n_layers, n_stages)


def stack_stage_params(layers: Sequence[Any], n_stages: int
                       ) -> tuple[Any, torch.Tensor]:
    """Stack per-layer param trees into per-stage slabs.

    Returns (stage_params, mask): leaves gain leading (n_stages, max_per)
    dims; short stages are zero-padded and ``mask[s, j]`` marks real
    layers.  Cut the leading dim over the pipeline axis so that each rank
    holds its stage's layers."""
    ranges = stage_ranges(len(layers), n_stages)
    max_per = max(hi - lo for lo, hi in ranges)
    zero = tree_map(torch.zeros_like, layers[0])
    stage_trees = []
    mask_rows = []
    for lo, hi in ranges:
        sel = list(layers[lo:hi]) + [zero] * (max_per - (hi - lo))
        stage_trees.append(tree_map(lambda *xs: torch.stack(xs), *sel))
        mask_rows.append([j < hi - lo for j in range(max_per)])
    stage_params = tree_map(lambda *xs: torch.stack(xs), *stage_trees)
    return stage_params, torch.tensor(mask_rows)


def pipeline_apply(stage_params: Any, mask: torch.Tensor, xs: torch.Tensor,
                   apply_layer: Callable[[Any, torch.Tensor], torch.Tensor],
                   mesh: Any, axis: str) -> torch.Tensor:
    """GPipe forward over the mesh axis ``axis``.

    xs: (M, mb, ...) microbatches, alike on every rank; returns the
    sequential layer stack's output for every microbatch, on every rank.
    stage_params / mask come from ``stack_stage_params`` with n_stages ==
    the axis size: full stacks (each rank takes its own stage) or DTensors
    cut over the axis on dim 0."""
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    idx = dist.get_rank(group)
    m_total = xs.shape[0]

    def mine(t: torch.Tensor) -> torch.Tensor:
        return t.to_local()[0] if is_dtensor(t) else t[idx]

    my_layers = tree_map(mine, stage_params)
    my_mask = [bool(v) for v in mine(mask)]

    def apply_stage(x: torch.Tensor) -> torch.Tensor:
        for j, valid in enumerate(my_mask):
            if valid:
                x = apply_layer(tree_map(lambda t: t[j], my_layers), x)
        return x

    nxt = (dist.get_global_rank(group, idx + 1)
           if idx + 1 < n_stages else None)
    prv = dist.get_global_rank(group, idx - 1) if idx > 0 else None
    state = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for t in range(m_total + n_stages - 1):
        # stage s receives stage s-1's step-(t-1) output; stage 0 feeds
        # microbatch t (the clamp only re-feeds values that can no longer
        # reach the last stage before the schedule ends)
        ops = []
        prev = torch.zeros_like(state)
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, state.contiguous(), nxt,
                                  group))
        if prv is not None:
            ops.append(dist.P2POp(dist.irecv, prev, prv, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        feed = xs[min(t, m_total - 1)]
        state = apply_stage(feed if idx == 0 else prev)
        out_t = t - (n_stages - 1)
        if out_t >= 0 and idx == n_stages - 1:
            outs[out_t] = state
    # only the last stage holds real outputs; it broadcasts them
    dist.broadcast(outs, dist.get_global_rank(group, n_stages - 1),
                   group=group)
    return outs
