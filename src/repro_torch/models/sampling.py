"""Device-side token sampling for the serving decode loop (port of
``repro.models.sampling``): greedy argmax, or top-k with a
``torch.Generator`` on the logits' device.  Tokens stay on the device; the
engine syncs one (ticks, slots) block per dispatch."""
from __future__ import annotations

import torch


def sample_tokens(logits: torch.Tensor, *,
                  generator: torch.Generator | None = None,
                  top_k: int | None = None,
                  temperature: float = 1.0) -> torch.Tensor:
    """logits (B, V) -> sampled token ids (B,) int32.

    ``top_k=None``: greedy argmax (the first maximum on ties, as
    ``jnp.argmax``).  ``top_k=k``: sample from softmax(top-k logits /
    temperature), so a masked vocab entry (-1e30) is never drawn for any
    k <= vocab.
    """
    if top_k is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("top-k sampling needs a torch.Generator")
    if not temperature > 0:
        raise ValueError("temperature must be > 0 for top-k sampling (use "
                         "top_k=None for greedy decoding)")
    vals, idx = torch.topk(logits, top_k, dim=-1)
    probs = torch.softmax(vals.float() / temperature, dim=-1)
    choice = torch.multinomial(probs, 1, generator=generator)
    return torch.gather(idx, 1, choice)[:, 0].to(torch.int32)
