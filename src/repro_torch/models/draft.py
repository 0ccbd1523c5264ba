"""Device-side n-gram (prompt-lookup) drafting for speculative decoding
(port of ``repro.models.draft``).

The drafter proposes ``draft_len`` continuation tokens per slot by matching
the tail n-gram of the slot's own token history against every earlier
position of that history and copying the continuation of the most recent
match: no draft model, no extra weights.  It runs inside the speculative
dispatch (``models.verify_ticks``), on the history's device.  The quality
of the proposals moves only the acceptance rate: the verify step rolls
rejected drafts back, so any deterministic proposal gives the same output.
"""
from __future__ import annotations

import torch


def draft_ngram_propose(history: torch.Tensor, ctx_len: torch.Tensor, *,
                        draft_len: int, ngram: int = 2) -> torch.Tensor:
    """Propose ``draft_len`` tokens per slot from its own history.

    history: (B, H) int32 token ring per slot; positions [0, ctx_len[b])
    hold the slot's context (prompt + generated so far, including the last
    emitted token at index ctx_len[b] - 1).  ctx_len: (B,) int32 in
    [1, H].  Returns (B, draft_len) int32: for each slot, the continuation
    history[i], history[i+1], ... of the most recent full match of the tail
    ``ngram`` tokens (the largest i with history[i-ngram:i] ==
    history[ctx_len-ngram:ctx_len], ngram <= i < ctx_len); positions past
    the known context, and every slot with no match or a context shorter
    than ngram + 1, repeat the last emitted token.  Integer-exact against
    ``repro.models.draft.draft_ngram_propose``."""
    if draft_len < 1:
        raise ValueError(f"draft_len must be >= 1, got {draft_len}")
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")
    b, h = history.shape
    dev = history.device
    ctx_len = ctx_len.long()
    idx = torch.arange(h, device=dev)
    last = history.gather(1, (ctx_len - 1)[:, None])
    # match[b, i]: the ngram window ending at i (exclusive) equals the tail
    # window ending at ctx_len[b], compared element j by element j
    match = torch.ones((b, h), dtype=torch.bool, device=dev)
    for j in range(ngram):
        shifted = history[:, torch.clamp(idx - ngram + j, 0, h - 1)]
        tail_j = history.gather(
            1, torch.clamp(ctx_len - ngram + j, 0, h - 1)[:, None])
        match &= shifted == tail_j
    # i is the continuation start: a full window before it and at least one
    # real context token at it
    valid = ((idx[None, :] >= ngram) & (idx[None, :] < ctx_len[:, None])
             & (ctx_len[:, None] > ngram))
    best = torch.where(match & valid, idx[None, :], -1).amax(dim=1)
    found = best >= 0
    pos = best[:, None] + torch.arange(draft_len, device=dev)[None, :]
    in_ctx = found[:, None] & (pos < ctx_len[:, None])
    copied = history.gather(1, torch.clamp(pos, 0, h - 1))
    return torch.where(in_ctx, copied, last).to(torch.int32)
