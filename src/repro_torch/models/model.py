"""Model API of the port (the paged-serving subset of
``repro.models.model``): init, paged prefill, paged decode."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as TF

Params = dict[str, Any]


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: torch.device | str = "cuda") -> Params:
    """Random weights drawn on ``device`` from a generator seeded with
    ``seed`` (same shapes and scales as ``repro.models.init_params``; the
    values differ, since the generators differ)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return TF.init_decoder(cfg, gen)


def paged_cache_leaf_specs(cfg: ArchConfig, page_size: int
                           ) -> dict[str, TF.LeafSpec]:
    return TF.paged_cache_leaf_specs(cfg, page_size)


def prefill_chunk(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                  start: int, pages: Params, block_row: torch.Tensor, *,
                  use_kernel: bool | None = None
                  ) -> tuple[torch.Tensor, Params]:
    """One page-aligned prompt chunk for one slot -> (chunk logits, pages
    updated in place)."""
    return TF.prefill_chunk_decoder(params, cfg, tokens, start, pages,
                                    block_row, use_kernel=use_kernel)


def decode_step_paged(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                      pages: Params, block_tables: torch.Tensor,
                      lengths: torch.Tensor, *,
                      use_kernel: bool | None = None
                      ) -> tuple[torch.Tensor, Params]:
    """One decode tick over all slots -> (logits (B, V), pages)."""
    return TF.decode_step_paged_decoder(params, cfg, tokens, pages,
                                        block_tables, lengths,
                                        use_kernel=use_kernel)


def decode_ticks(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                 pages: Params, block_tables: torch.Tensor,
                 lengths: torch.Tensor, active: torch.Tensor,
                 budget: torch.Tensor, eos: torch.Tensor, n_ticks: int, *,
                 max_seq: int, top_k: int | None = None,
                 temperature: float = 1.0,
                 generator: torch.Generator | None = None,
                 null_page: int | None = None,
                 use_kernel: bool | None = None
                 ) -> tuple[torch.Tensor, Params]:
    """N decode ticks with device-side sampling -> (token block (N, B),
    pages); see ``transformer.decode_ticks_decoder``."""
    return TF.decode_ticks_decoder(params, cfg, tokens, pages, block_tables,
                                   lengths, active, budget, eos, n_ticks,
                                   max_seq=max_seq, top_k=top_k,
                                   temperature=temperature,
                                   generator=generator, null_page=null_page,
                                   use_kernel=use_kernel)


def param_count(params: Params) -> int:
    return sum(param_count(v) if isinstance(v, dict) else v.numel()
               for v in params.values())
