"""PACO-paged KV cache: fixed-size pages in a pool + per-slot block tables
(port of ``repro.serve.paging``).

The pool holds pages of ``page_size`` consecutive positions; each slot's
block table maps its logical position range to physical pages.  The page
size is the sequence extent of a PACO 1-piece leaf tile of the
(slots x max_seq x feat) cache cuboid (``paco_page_size``).  One reserved
null page (index ``pool.null_page``) absorbs writes from inactive decode
slots; no live slot reads it.  Block tables and the free list live on the
host (numpy); the pools are torch tensors on the serving device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cuboid


def paco_page_size(slots: int, max_seq: int, feat_dim: int, *,
                   pages_per_slot: int = 8) -> int:
    """Sequence extent of a PACO 1-piece leaf tile of the cache cuboid.

    Plans (slots x max_seq x feat_dim) for ``slots * pages_per_slot``
    leaves with ``core.cuboid.plan_mm_1piece`` and takes the smallest
    sequence extent, rounded down to the largest divisor of ``max_seq``
    not exceeding it, so block tables stay rectangular for any (odd or
    prime) ``max_seq``."""
    if max_seq < 2:
        return 1
    p = max(2, slots * pages_per_slot)
    plan = cuboid.plan_mm_1piece(max(slots, 1), max_seq, max(feat_dim, 1), p)
    seq_extent = min((c.m for _, c in plan.tiles if c.m > 0),
                     default=max_seq)
    return max(d for d in range(1, seq_extent + 1) if max_seq % d == 0)


def paco_draft_len(slots: int, max_seq: int, feat_dim: int, *,
                   max_window: int = 8) -> int:
    """Draft length for speculative decoding, planned from the verify
    cuboid: the verify window is a leaf tile of the (slots x max_seq x
    feat_dim) cache cuboid (``paco_page_size``'s plan), capped at
    ``max_window`` positions, less the slot the last emitted token takes:
    draft_len = window - 1."""
    page = paco_page_size(slots, max_seq, feat_dim)
    return max(1, min(max_window, page) - 1)


@dataclasses.dataclass
class PagePool:
    """Fixed pool of KV pages plus the host-side free list.

    ``pools`` maps each cache leaf name ("k", "v" for GQA; "c_kv",
    "k_rope" for MLA latents) to a tensor of shape
    (layers, n_pages + 1, page_size, *feature_dims); physical page
    ``n_pages`` is the reserved null page.  The model writes the tensors
    in place.
    """

    pools: dict[str, torch.Tensor]
    page_size: int
    n_pages: int
    free: list[int]

    @property
    def null_page(self) -> int:
        return self.n_pages

    def alloc(self, n: int) -> list[int] | None:
        """Pop ``n`` pages from the free list; None (no change) if short."""
        if n > len(self.free):
            return None
        taken, self.free = self.free[:n], self.free[n:]
        return taken

    def release(self, pages: list[int]) -> None:
        for p in pages:
            if not 0 <= p < self.n_pages:
                raise ValueError(f"page {p} is not in the pool")
            if p in self.free:
                raise ValueError(f"double free of page {p}")
        self.free.extend(pages)

    def free_count(self) -> int:
        return len(self.free)


def init_pool(cache_leaf_specs: dict, n_pages: int, page_size: int,
              device: torch.device | str) -> PagePool:
    """Allocate zeroed pools on ``device`` from per-leaf specs shaped
    (L, page_size, *feat): the pool adds the physical-page dimension after
    the layer dim, plus the null page."""
    pools = {}
    for name, (shape, dtype) in cache_leaf_specs.items():
        lyr, pg, *feat = shape
        if pg != page_size:
            raise ValueError(f"{name}: spec {shape} vs page {page_size}")
        pools[name] = torch.zeros((lyr, n_pages + 1, page_size, *feat),
                                  dtype=dtype, device=device)
    return PagePool(pools=pools, page_size=page_size, n_pages=n_pages,
                    free=list(range(n_pages)))


class BlockTables:
    """Per-slot page maps: host-authoritative numpy, device view on demand.

    Row ``s`` maps slot ``s``'s logical positions ``[i*page_size,
    (i+1)*page_size)`` to physical page ``table[s, i]``; unmapped entries
    point at the null page.
    """

    def __init__(self, slots: int, pages_per_seq: int, null_page: int,
                 device: torch.device | str):
        self.null_page = null_page
        self.device = torch.device(device)
        self._np = np.full((slots, pages_per_seq), null_page, np.int32)
        self._dev: dict[int, torch.Tensor] = {}

    def assign(self, slot: int, first: int, pages: list[int]) -> None:
        self._np[slot, first:first + len(pages)] = pages
        self._dev.clear()

    def clear(self, slot: int) -> list[int]:
        """Reset a slot's row to the null page; returns the freed pages."""
        row = self._np[slot]
        pages = [int(p) for p in row if p != self.null_page]
        row[:] = self.null_page
        self._dev.clear()
        return pages

    def row(self, slot: int) -> np.ndarray:
        return self._np[slot]

    def device_view(self, width: int) -> torch.Tensor:
        """(slots, width) int32 device copy of the first ``width`` table
        columns, cached per width until the mapping changes."""
        if width not in self._dev:
            self._dev[width] = torch.from_numpy(
                np.ascontiguousarray(self._np[:, :width])).to(self.device)
        return self._dev[width]

    def live_pages(self, slot: int) -> list[int]:
        return [int(p) for p in self._np[slot] if p != self.null_page]

    def check_invariants(self, pool: PagePool,
                         live_slots: list[int]) -> None:
        """No physical page is mapped by two live slots, no live slot maps
        a free page, and live + free page counts never exceed the pool."""
        seen: dict[int, int] = {}
        free = set(pool.free)
        assert len(free) == len(pool.free), "free list has duplicates"
        n_live = 0
        for s in live_slots:
            for p in self.live_pages(s):
                assert p not in seen, \
                    f"page {p} shared by live slots {seen[p]} and {s}"
                assert p not in free, f"live page {p} is on the free list"
                seen[p] = s
                n_live += 1
        assert n_live + len(free) <= pool.n_pages
