"""Model API of the port (``repro.models.model``): init, forward and loss
for training, per family (decoder, encdec, ssm, hybrid); prefill and decode
on a dense cache padded to max_seq for every family (prefill for decoder
and encdec only, as in ``repro``); paged prefill, decode and speculative
verify for the decoder family."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import act_sharding as act
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as TF

Params = dict[str, Any]


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: torch.device | str = "cuda") -> Params:
    """Random weights drawn on ``device`` from a generator seeded with
    ``seed`` (same shapes and scales as ``repro.models.init_params``; the
    values differ, since the generators differ)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    init = {"decoder": TF.init_decoder, "encdec": ED.init_encdec,
            "ssm": HY.init_ssm_lm, "hybrid": HY.init_hybrid}
    if cfg.family not in init:
        raise ValueError(cfg.family)
    return init[cfg.family](cfg, gen)


def forward(params: Params, cfg: ArchConfig, batch: dict, *,
            remat: bool = True, use_kernel: bool | None = None
            ) -> torch.Tensor:
    """batch -> logits (B, S, V) f32; encdec reads ``batch["src_emb"]``
    beside the target ``tokens``.  ``use_kernel`` picks the attention
    lowering (the SSM LM has no attention)."""
    tokens = batch["tokens"]
    if cfg.family == "decoder":
        return TF.forward_decoder(params, cfg, tokens, remat=remat,
                                  use_kernel=use_kernel)
    if cfg.family == "encdec":
        return ED.forward_encdec(params, cfg, batch["src_emb"], tokens,
                                 remat=remat, use_kernel=use_kernel)
    if cfg.family == "ssm":
        return HY.forward_ssm_lm(params, cfg, tokens, remat=remat)
    if cfg.family == "hybrid":
        return HY.forward_hybrid(params, cfg, tokens, remat=remat,
                                 use_kernel=use_kernel)
    raise ValueError(cfg.family)


def loss_fn(params: Params, cfg: ArchConfig, batch: dict, *,
            remat: bool = True, use_kernel: bool | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy (+ MoE aux loss), as ``repro``'s
    ``loss_fn``: labels < 0 are masked out, the mean is over unmasked
    tokens.  The gold logit is taken with ``torch.gather``, which gives the
    value ``repro``'s masked vocab-iota sum gives without its (B, S, V)
    integer iota.  The MoE aux loss is ``repro``'s layer-0 proxy: layer 0's
    router over the token embeddings.

    Under a mesh whose model axis cuts the vocab the loss stays
    vocab-parallel, as ``repro``'s: the log-sum-exp from each rank's
    columns (a max and a sum reduced across the model axis) and the gold
    logit as ``repro``'s masked sum against a vocab iota cut as the logits
    are, so no rank holds a (B, S, V) tensor whole."""
    logits = forward(params, cfg, batch, remat=remat, use_kernel=use_kernel)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    labels = torch.clamp(labels, min=0).long()
    if act.is_dtensor(logits) and act.model_size() > 1:
        logz, gold = _vocab_parallel_terms(logits, labels)
    else:
        # vocab whole for the gather (a mesh with no model cut)
        logits = act.constrain(logits, "dp", None, None)
        logz = torch.logsumexp(logits, dim=-1)
        # on each rank's rows under a mesh: DTensor's gather backward
        # would build the global (B, S, V) zeros on every rank
        gold = act.local_call(
            lambda lg, lb: lg.gather(-1, lb[..., None])[..., 0],
            (("dp", None, None), ("dp", None)), 1, logits, labels)
    nll = (logz - gold) * mask
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = nll.sum() / denom
    metrics = {"nll": loss, "tokens": denom}
    if cfg.moe is not None and cfg.moe.aux_loss_weight:
        # rows over dp and features whole before the rows are flattened
        emb = act.constrain(L.embed_rows(params["embed"], batch["tokens"]),
                            "dp", None, None).reshape(-1, cfg.d_model)
        router0 = TF._layer(params["blocks"], 0)["mlp"]
        aux = M.aux_load_balance_loss(router0, cfg, emb)
        loss = loss + cfg.moe.aux_loss_weight * aux
        metrics["aux"] = aux
    return loss, metrics


def _vocab_parallel_terms(logits: torch.Tensor, labels: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(log-sum-exp, gold logit) of DTensor logits (B, S, V) with the
    vocab over the model axis, each rank on its own columns."""
    logits = act.constrain(logits, "dp", None, "model")
    mx = logits.detach().amax(dim=-1, keepdim=True)
    logz = (torch.log(torch.exp(logits - mx).sum(dim=-1))
            + mx.squeeze(-1))
    vocab = act.constrain(act.as_dtensor(torch.arange(
        logits.shape[-1], device=logits.device), logits.device_mesh),
        "model")
    gold = torch.where(vocab == labels[..., None], logits, 0.0).sum(dim=-1)
    return logz, gold


# ---------------------------------------------------------------------------
# Serving on a dense cache padded to max_seq
# ---------------------------------------------------------------------------

def cache_spec(cfg: ArchConfig, batch: int, max_seq: int, src_len: int = 0
               ) -> dict[str, TF.LeafSpec]:
    """Shape and dtype of each cache (or state) leaf: the decoder's K/V or
    MLA latents, encdec's self and cross K/V (cross over ``src_len``, or
    max_seq when 0), the SSM's conv and ssm states, and the hybrid's states
    plus the shared block's K/V."""
    if cfg.family == "decoder":
        return TF.cache_spec_decoder(cfg, batch, max_seq)
    if cfg.family == "encdec":
        return ED.cache_spec_encdec(cfg, batch, max_seq, src_len or max_seq)
    if cfg.family == "ssm":
        return HY.state_spec_ssm(cfg, batch)
    if cfg.family == "hybrid":
        return HY.state_spec_hybrid(cfg, batch, max_seq)
    raise ValueError(cfg.family)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, src_len: int = 0,
               *, device: torch.device | str = "cuda") -> Params:
    """Zeros of ``cache_spec`` on ``device`` (under mesh rules laid out by
    ``dist.sharding.cache_specs``)."""
    return TF.zeros_of(cache_spec(cfg, batch, max_seq, src_len), device, cfg)


def decode_step(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                cache: Params, lengths: torch.Tensor
                ) -> tuple[torch.Tensor, Params, torch.Tensor]:
    """One new token per sequence: (logits (B, V), cache, lengths + 1);
    the cache is updated IN PLACE and returned."""
    if cfg.family == "decoder":
        return TF.decode_step_decoder(params, cfg, tokens, cache, lengths)
    if cfg.family == "encdec":
        return ED.decode_step_encdec(params, cfg, tokens, cache, lengths)
    if cfg.family == "ssm":
        return HY.decode_step_ssm(params, cfg, tokens, cache, lengths)
    if cfg.family == "hybrid":
        return HY.decode_step_hybrid(params, cfg, tokens, cache, lengths)
    raise ValueError(cfg.family)


def prefill(params: Params, cfg: ArchConfig, batch: dict, max_seq: int, *,
            use_kernel: bool | None = None
            ) -> tuple[torch.Tensor, Params, torch.Tensor]:
    """Prompt ingestion -> (last logits, cache, lengths).  encdec encodes
    the source and fills every decoder layer's cross K/V; its target starts
    empty (zero logits, lengths 0).  ssm and hybrid raise, as in
    ``repro``."""
    if cfg.family == "decoder":
        return TF.prefill_decoder(params, cfg, batch["tokens"], max_seq,
                                  use_kernel=use_kernel)
    if cfg.family == "encdec":
        enc = ED.encode(params, cfg, batch["src_emb"], use_kernel=use_kernel)
        b, src_len = enc.shape[:2]
        cache = init_cache(cfg, b, max_seq, src_len, device=enc.device)
        for i in range(cfg.n_layers):
            xattn = TF._layer(params["dec_blocks"], i)["xattn"]
            xk, xv = ED.cross_kv(xattn, cfg, enc)
            TF.write_span(cache["xk"], i, xk)
            TF.write_span(cache["xv"], i, xv)
        lengths = torch.zeros((b,), dtype=torch.int32, device=enc.device)
        logits = torch.zeros((b, cfg.vocab), dtype=torch.float32,
                             device=enc.device)
        return logits, cache, lengths
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            "ssm/hybrid prefill: use forward() for scoring and decode_step "
            "for generation; state-returning prefill is future work")
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Paged serving (the decoder family)
# ---------------------------------------------------------------------------

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
