"""Model API of the port (the decoder subset of ``repro.models.model``):
init, forward and loss for training, paged prefill, decode and speculative
verify for serving."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as M
from repro_torch.models import transformer as TF

Params = dict[str, Any]


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: torch.device | str = "cuda") -> Params:
    """Random weights drawn on ``device`` from a generator seeded with
    ``seed`` (same shapes and scales as ``repro.models.init_params``; the
    values differ, since the generators differ)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return TF.init_decoder(cfg, gen)


def forward(params: Params, cfg: ArchConfig, batch: dict, *,
            remat: bool = True, use_kernel: bool | None = None
            ) -> torch.Tensor:
    """batch -> logits (B, S, V) f32."""
    return TF.forward_decoder(params, cfg, batch["tokens"], remat=remat,
                              use_kernel=use_kernel)


def loss_fn(params: Params, cfg: ArchConfig, batch: dict, *,
            remat: bool = True, use_kernel: bool | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (+ MoE aux loss), as ``repro``'s
    ``loss_fn``: labels < 0 are masked out, the mean is over unmasked
    tokens.  The gold logit is taken with ``torch.gather``, which gives the
    value ``repro``'s masked vocab-iota sum gives without its (B, S, V)
    integer iota.  The MoE aux loss is ``repro``'s layer-0 proxy: layer 0's
    router over the token embeddings."""
    logits = forward(params, cfg, batch, remat=remat, use_kernel=use_kernel)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    labels = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    metrics = {"nll": loss, "tokens": denom}
    if cfg.moe is not None and cfg.moe.aux_loss_weight:
        emb = params["embed"][batch["tokens"]].reshape(-1, cfg.d_model)
        router0 = TF._layer(params["blocks"], 0)["mlp"]
        aux = M.aux_load_balance_loss(router0, cfg, emb)
        loss = loss + cfg.moe.aux_loss_weight * aux
        metrics["aux"] = aux
    return loss, metrics


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


def verify_ticks(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                 pages: Params, block_tables: torch.Tensor,
                 lengths: torch.Tensor, active: torch.Tensor,
                 budget: torch.Tensor, eos: torch.Tensor,
                 history: torch.Tensor, write_limit: torch.Tensor,
                 n_steps: int, *, max_seq: int, draft_len: int,
                 ngram: int = 2, null_page: int | None = None,
                 use_kernel: bool | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            Params]:
    """N speculative decode steps: device-side n-gram drafting, one batched
    paged verify forward per step, greedy acceptance with rollback of
    rejected writes -> (token blocks (N, B, draft_len + 1), accepted-draft
    counts (N, B), updated history, pages); see
    ``transformer.verify_ticks_decoder``."""
    return TF.verify_ticks_decoder(params, cfg, tokens, pages, block_tables,
                                   lengths, active, budget, eos, history,
                                   write_limit, n_steps, max_seq=max_seq,
                                   draft_len=draft_len, ngram=ngram,
                                   null_page=null_page,
                                   use_kernel=use_kernel)


def param_count(params: Params) -> int:
    return sum(param_count(v) if isinstance(v, dict) else v.numel()
               for v in params.values())


def active_param_count(cfg: ArchConfig, params: Params) -> int:
    """Active (per-token) parameters: for MoE archs the full expert block
    is replaced by top_k experts (shared experts stay), as used for
    MODEL_FLOPS = 6 * N_active * tokens."""
    total = param_count(params)
    if not cfg.moe:
        return total
    m = cfg.moe
    expert_params = 3 * cfg.d_model * m.d_ff_expert  # gate/up/down
    return total - (m.n_experts - m.top_k) * expert_params * cfg.n_layers
