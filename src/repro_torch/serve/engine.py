"""Continuous-batching serving engine over a PACO-paged KV cache (port of
``repro.serve.engine``, on one device or on a ``DeviceMesh``).

Requests queue up; the scheduler admits them FIFO into fixed decode slots,
prefills their prompts in page-aligned chunks (one ``prefill_chunk`` call
per chunk), and advances every active slot with fused multi-tick decode
dispatches: one ``decode_ticks`` call runs ``ticks_per_dispatch`` decode
steps with sampling, cache append and retirement flags on the device, and
the host syncs one small (ticks, slots) token block per dispatch.  The KV
cache lives in a shared pool of fixed-size pages mapped through per-slot
block tables; the model writes the pool in place.  Retirement frees pages
back to the pool, and pool exhaustion preempts the youngest request (its
pages freed, the request re-queued to resume with identical output).
Speculative decoding (``speculate``) replaces each decode step by a
draft -> verify -> accept step (``models.verify_ticks``), and
``fused=False`` keeps the single-tick decode loop (one ``decode_step_paged``
call and one host argmax per token) as the baseline of the fused loop.

The engine runs on ``device`` ("cuda" unless the caller asks for "cpu");
on CUDA the attention runs through the hand-written kernels.  With
``mesh`` every rank of the mesh runs the same engine: params are laid out
by ``dist.sharding.param_specs`` and the pools by ``paged_pool_specs``
(K/V heads cut over the model axis, latent pools whole, the page dim never
cut), while tokens, lengths, block tables and history stay whole and
alike on every rank; each dispatch's tokens are checked to agree across
ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import act_sharding as act
from repro_torch.dist import sharding as D
from repro_torch.models import (decode_step_paged, decode_ticks,
                                paged_cache_leaf_specs, prefill_chunk,
                                sample_tokens, verify_ticks)
from repro_torch.serve import paging

Params = Any


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int = -1  # -1 = never
    out: list[int] = dataclasses.field(default_factory=list)
    # instrumentation (tests + launch report)
    prefill_calls: int = 0
    preemptions: int = 0


def _width_bucket(width: int, pages_per_seq: int) -> int:
    """Round a live block-table width up to a power of two (clamped to the
    full table)."""
    b = 1
    while b < width:
        b *= 2
    return min(b, pages_per_seq)


def _check_mesh(mesh: Any, device: torch.device) -> None:
    """A mesh needs an initialized process group of the device's backend:
    NCCL for "cuda", gloo for "cpu" (no silent switch between them)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("ServeEngine(mesh=...): no process group; "
                           "initialize one (NCCL on cuda, gloo on cpu)")
    want = "nccl" if device.type == "cuda" else "gloo"
    if dist.get_backend() != want or mesh.device_type != device.type:
        raise RuntimeError(
            f"ServeEngine(mesh=..., device={device.type!r}) needs a "
            f"{want} group and a {device.type} mesh; got "
            f"{dist.get_backend()} and {mesh.device_type}")


def _to_device(params: Params, device: torch.device) -> Params:
    return {k: (_to_device(v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in params.items()}


class ServeEngine:
    """Paged continuous-batching engine (decoder LMs: GQA or MLA latent
    attention, dense or MoE MLPs).

    ``ticks_per_dispatch`` sets how many decode steps one dispatch fuses:
    larger values amortize the host sync over more tokens at the cost of
    token-block latency and up to that many pre-mapped pages per slot.
    ``top_k``/``temperature`` switch the device-side sampler from greedy
    argmax to top-k (``models.sample_tokens``, seeded by ``seed``).
    ``device`` defaults to "cuda"; asking for it on a host without a card
    raises.  ``mesh`` (a ``DeviceMesh`` over an initialized process group:
    NCCL on "cuda", gloo on "cpu") serves on every rank of it, as
    ``repro``'s engine does on a JAX mesh; the fused, speculative and
    single-tick dispatches all take it.

    ``fused=False`` keeps the single-tick decode loop: one
    ``decode_step_paged`` call over full-width tables and one host argmax
    per token (the prefill path is shared), the baseline the fused loop is
    measured against.

    ``speculate`` turns on speculative decoding: each decode dispatch runs
    ``ticks_per_dispatch`` draft -> verify -> accept steps, each advancing
    a live slot by 1..draft_len + 1 tokens; drafts come from the n-gram
    drafter (``models.draft_ngram_propose``, tail ``draft_ngram``), the
    verify forward scores the whole window in one pass, and rejected drafts
    are rolled back.  ``speculate=N`` drafts N tokens a window, 0 plans the
    window as a PACO leaf tile of the cache cuboid
    (``paging.paco_draft_len``).  Greedy only, and only on the fused loop.
    ``spec_min_accept`` is the adaptive fallback: when the acceptance rate
    of the last 32 verify windows drops below it, the engine dispatches the
    fused decode instead, probing speculatively every 16th dispatch; 0
    turns the fallback off.
    """

    def __init__(self, params: Params, cfg: ArchConfig, *, slots: int = 4,
                 max_seq: int = 128, page_size: int | None = None,
                 pool_pages: int | None = None,
                 prefill_chunk_len: int | None = None, mesh=None,
                 ticks_per_dispatch: int = 8, fused: bool = True,
                 top_k: int | None = None, temperature: float = 1.0,
                 speculate: int | None = None, draft_ngram: int = 2,
                 spec_min_accept: float = 0.25, seed: int = 0,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ServeEngine(device={str(device)!r}): no CUDA device on "
                "this host; pass device='cpu' to serve on the CPU")
        if mesh is not None:
            _check_mesh(mesh, self.device)
        self.mesh = mesh
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        # the cache cuboid's per-position feature extent: head_dim for
        # dense GQA KV, the compressed kv_lora face for MLA latents
        feat = cfg.mla.kv_lora if cfg.attn == "mla" else cfg.head_dim
        self.page = page_size or paging.paco_page_size(slots, max_seq, feat)
        if max_seq % self.page != 0:
            raise ValueError(
                f"page_size={self.page} does not divide max_seq="
                f"{max_seq}: every sequence must span whole pages so "
                f"block tables stay rectangular")
        self.pages_per_seq = max_seq // self.page
        if prefill_chunk_len is None:
            prefill_chunk_len = self.page
            while (prefill_chunk_len * 2 <= min(64, max_seq)
                   and max_seq % (prefill_chunk_len * 2) == 0):
                prefill_chunk_len *= 2
        if prefill_chunk_len % self.page != 0:
            raise ValueError(
                f"prefill_chunk_len={prefill_chunk_len} is not a multiple "
                f"of page_size={self.page}: each prefill chunk scatters "
                f"whole pages")
        if max_seq % prefill_chunk_len != 0:
            raise ValueError(
                f"prefill_chunk_len={prefill_chunk_len} does not divide "
                f"max_seq={max_seq}: a padded final chunk would overrun "
                f"the block table")
        self.chunk = prefill_chunk_len
        if ticks_per_dispatch < 1:
            raise ValueError(f"ticks_per_dispatch must be >= 1, got "
                             f"{ticks_per_dispatch}")
        self.ticks = ticks_per_dispatch
        self.fused = fused
        self.top_k = top_k
        self.temperature = temperature
        self.draft_len = None
        self.draft_ngram = draft_ngram
        if speculate is not None:
            if not fused:
                raise ValueError(
                    "speculate requires the fused engine (fused=True): the "
                    "single-tick loop has no verify dispatch")
            if top_k is not None or temperature != 1.0:
                raise NotImplementedError(
                    f"speculative decoding is greedy-only (got top_k="
                    f"{top_k}, temperature={temperature}): sampled decoding "
                    "would need rejection sampling over the draft window")
            if speculate < 0:
                raise ValueError(f"speculate must be >= 0 (0 = PACO-"
                                 f"planned), got {speculate}")
            self.draft_len = (speculate if speculate > 0 else
                              paging.paco_draft_len(slots, max_seq, feat))
        self.spec_min_accept = spec_min_accept
        # adaptive fallback: accepted-draft counts of the last 32 verify
        # windows, and the dispatches skipped since the last probe
        self._spec_recent: deque[int] = deque(maxlen=32)
        self._spec_skipped = 0
        n_pages = (pool_pages if pool_pages is not None
                   else slots * self.pages_per_seq)
        if n_pages < self.pages_per_seq:
            raise ValueError(
                f"pool_pages={n_pages} < pages_per_seq="
                f"{self.pages_per_seq}: the pool must hold at least one "
                f"full max_seq sequence or a lone request can never map")
        self.pool = paging.init_pool(paged_cache_leaf_specs(cfg, self.page),
                                     n_pages, self.page, self.device)
        self.tables = paging.BlockTables(slots, self.pages_per_seq,
                                         self.pool.null_page, self.device)
        self.params = _to_device(params, self.device)
        if mesh is not None:
            self.params = D.distribute(mesh, self.params, D.param_specs(
                cfg, self.params, mesh))
            place = D.pool_shardings(cfg, mesh, self.pool.pools)
            self.pool.pools = {k: D.shard_of(v, mesh, place[k])
                               for k, v in self.pool.pools.items()}

        self.active: list[Request | None] = [None] * slots
        self.queue: deque[Request] = deque()
        self.done: list[Request] = []
        # host-authoritative per-slot state: cache positions written, last
        # emitted token (its KV lands on the next tick), admission order
        # (preemption victims are the youngest).
        self._ctx_len = [0] * slots
        self._last_tok = [0] * slots
        self._admit_order = [-1] * slots
        self._admit_seq = 0
        # per-slot token history (prompt + generated; row s valid up to
        # _ctx_len[s] inclusive, _hist[s, _ctx_len[s]] == _last_tok[s]),
        # the drafter's haystack; ``_hist_dev`` is its device copy between
        # speculative dispatches (their appends mirror the host replay), so
        # it is dropped only when a slot changes or a fused dispatch
        # appends on the host alone
        self._hist = np.zeros((slots, max_seq), np.int32)
        self._hist_dev: torch.Tensor | None = None
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = {"prefill_calls": 0, "decode_steps": 0,
                      "preemptions": 0, "retired": 0, "dispatches": 0,
                      "host_syncs": 0, "max_table_width": 0,
                      "prefill_tokens": 0, "decode_tokens": 0,
                      "prefill_s": 0.0, "decode_s": 0.0,
                      "spec_windows": 0, "drafted_tokens": 0,
                      "accepted_tokens": 0, "spec_fallback_dispatches": 0}

    # -- plumbing -----------------------------------------------------------

    def _mesh_cm(self):
        if self.mesh is None:
            return contextlib.nullcontext()
        return act.use_mesh_rules(self.mesh)

    def _agree(self, t: torch.Tensor, what: str) -> None:
        """Under a mesh, raise unless every rank drew the same tokens."""
        if self.mesh is not None:
            act.assert_replicated(t, self.mesh, what)

    def _i32(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    def submit(self, req: Request) -> None:
        if not (1 <= len(req.prompt) < self.max_seq):
            raise ValueError(
                f"prompt length {len(req.prompt)} must be in "
                f"[1, max_seq={self.max_seq})")
        if req.max_new_tokens < 1:
            # prefill always emits one token
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{req.max_new_tokens}")
        self.queue.append(req)

    def _emit(self, req: Request, tok: int) -> bool:
        """Record a generated token; True when the request retires (eos,
        token budget, or context hitting max_seq).  ``decode_ticks``'s
        device-side flags mirror this rule exactly."""
        req.out.append(tok)
        return (len(req.out) >= req.max_new_tokens or tok == req.eos_id
                or len(req.prompt) + len(req.out) >= self.max_seq)

    def _release_slot(self, slot: int) -> None:
        self.pool.release(self.tables.clear(slot))
        self.active[slot] = None
        self._ctx_len[slot] = 0
        self._last_tok[slot] = 0
        self._admit_order[slot] = -1
        self._hist[slot] = 0
        self._hist_dev = None

    def _retire(self, slot: int) -> None:
        req = self.active[slot]
        self._release_slot(slot)
        self.done.append(req)
        self.stats["retired"] += 1

    def _preempt(self, slot: int) -> None:
        """Evict a slot: pages freed, request re-queued FIRST so it resumes
        (prompt + generated so far re-prefilled) with identical output."""
        req = self.active[slot]
        self._release_slot(slot)
        req.preemptions += 1
        self.stats["preemptions"] += 1
        self.queue.appendleft(req)

    def _youngest_active(self) -> int:
        return max((s for s in range(self.slots)
                    if self.active[s] is not None),
                   key=lambda s: self._admit_order[s])

    # -- scheduler ----------------------------------------------------------

    def _admit(self) -> None:
        """Fill free slots from the queue head (FIFO).  Admission needs
        pages for every padded prefill chunk up front; if the pool cannot
        supply them the queue waits.  The first tokens of all slots
        admitted here reach the host in one sync."""
        pending: list[tuple[int, torch.Tensor]] = []
        for slot in range(self.slots):
            if self.active[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            ctx = req.prompt + req.out
            n_chunks = -(-len(ctx) // self.chunk)
            got = self.pool.alloc(n_chunks * (self.chunk // self.page))
            if got is None:
                break
            self.queue.popleft()
            self.tables.assign(slot, 0, got)
            self.active[slot] = req
            self._admit_order[slot] = self._admit_seq
            self._admit_seq += 1
            pending.append((slot, self._prefill_slot(slot, req, ctx)))
        if pending:
            t0 = time.perf_counter()
            toks = torch.stack([t for _, t in pending]).cpu().tolist()
            self.stats["host_syncs"] += 1
            self.stats["prefill_s"] += time.perf_counter() - t0
            for (slot, _), tok in zip(pending, toks):
                req = self.active[slot]
                self._last_tok[slot] = tok
                self._hist[slot, self._ctx_len[slot]] = tok
                self._hist_dev = None
                if self._emit(req, tok):
                    self._retire(slot)

    def _prefill_slot(self, slot: int, req: Request,
                      ctx: list[int]) -> torch.Tensor:
        """Chunked prefill: ceil(len(ctx)/chunk) calls, each ingesting a
        whole page-aligned chunk with the block row sliced to the chunk's
        live page extent (power-of-two bucket).  Returns the first sampled
        token as a DEVICE scalar, read at the caller's batched sync."""
        t0 = time.perf_counter()
        logits = None
        for i in range(0, len(ctx), self.chunk):
            width = _width_bucket(-(-(i + self.chunk) // self.page),
                                  self.pages_per_seq)
            self.stats["max_table_width"] = max(
                self.stats["max_table_width"], width)
            row = self.tables.device_view(width)[slot]
            toks = ctx[i:i + self.chunk]
            toks = toks + [0] * (self.chunk - len(toks))
            with self._mesh_cm():
                logits, self.pool.pools = prefill_chunk(
                    self.params, self.cfg, self._i32([toks]), i,
                    self.pool.pools, row)
            req.prefill_calls += 1
            self.stats["prefill_calls"] += 1
        last = (len(ctx) - 1) % self.chunk
        tok = sample_tokens(logits[last][None], generator=self._gen,
                            top_k=self.top_k,
                            temperature=self.temperature)[0]
        self._agree(tok, "the prefill's sampled token")
        self.stats["prefill_tokens"] += len(ctx)
        self.stats["prefill_s"] += time.perf_counter() - t0
        self._ctx_len[slot] = len(ctx)
        self._hist[slot, :len(ctx)] = ctx
        self._hist_dev = None
        return tok

    def _ensure_decode_pages(self, n: int = 1) -> None:
        """Every active slot needs mapped pages for its next ``n`` write
        positions (capped by its budget and max_seq); exhaustion preempts
        the youngest active request until the allocation succeeds."""
        order = sorted((s for s in range(self.slots)
                        if self.active[s] is not None),
                       key=lambda s: self._admit_order[s])
        for slot in order:
            if self.active[slot] is None:   # preempted below
                continue
            for idx in range(*self._write_page_range(slot, n)):
                if self.active[slot] is None:
                    break
                if self.tables.row(slot)[idx] != self.tables.null_page:
                    continue
                while True:
                    got = self.pool.alloc(1)
                    if got is not None:
                        self.tables.assign(slot, idx, got)
                        break
                    victim = self._youngest_active()
                    self._preempt(victim)
                    if victim == slot:
                        break

    def _planned_writes(self, slot: int, n: int) -> int:
        """How many of the next ``n`` ticks this slot can write: capped by
        the remaining token budget and the last writable position."""
        req = self.active[slot]
        ctx = self._ctx_len[slot]
        return max(1, min(n, req.max_new_tokens - len(req.out),
                          (self.max_seq - 1) - ctx))

    def _write_page_range(self, slot: int, n: int) -> tuple[int, int]:
        """Half-open block-table index range the slot writes over the next
        ``n`` ticks: positions [ctx, ctx + _planned_writes)."""
        ctx = self._ctx_len[slot]
        w = self._planned_writes(slot, n)
        return ctx // self.page, (ctx + w - 1) // self.page + 1

    def _use_speculation(self) -> bool:
        """Speculate unless the acceptance rate of the last 32 verify
        windows fell below ``spec_min_accept``; then dispatch the fused
        decode, with a speculative probe every 16th dispatch."""
        if self.draft_len is None:
            return False
        recent = self._spec_recent
        if not self.spec_min_accept or len(recent) < recent.maxlen:
            return True
        rate = sum(recent) / (len(recent) * self.draft_len)
        if rate >= self.spec_min_accept:
            self._spec_skipped = 0
            return True
        self._spec_skipped += 1
        if self._spec_skipped >= 16:   # periodic probe
            self._spec_skipped = 0
            return True
        return False

    def tick(self) -> int:
        """Admit + one decode dispatch (``ticks_per_dispatch`` fused steps,
        draft/verify steps when speculating; one step on the single-tick
        loop); returns #retired."""
        self._admit()
        if all(r is None for r in self.active):
            return 0
        n = self.ticks if self.fused else 1
        # a speculative dispatch maps pages for n x W window positions per
        # slot: every in-plan window write needs a real page even if its
        # draft is rejected (rollback restores contents, not mappings)
        use_spec = self._use_speculation()
        w = self.draft_len + 1 if use_spec else 1
        span = n * w
        self._ensure_decode_pages(span)
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            return 0
        if not self.fused:
            return self._dispatch_legacy(live)
        # clamp the block to the largest per-slot write plan (power-of-two
        # bucket) so a drain tail does not run steps with every lane frozen
        planned = max(self._planned_writes(s, span) for s in live)
        n_eff = min(n, _width_bucket(-(-planned // w), n))
        if use_spec:
            return self._dispatch_spec(live, n_eff)
        return self._dispatch_fused(live, n_eff)

    def _dispatch_arrays(self, live: list[int], span: int):
        """Per-slot device vectors of one dispatch: block tables sliced to
        the span's width bucket, last tokens, context lengths,
        active/budget/eos."""
        width = _width_bucket(
            max(self._write_page_range(s, span)[1] for s in live),
            self.pages_per_seq)
        self.stats["max_table_width"] = max(
            self.stats["max_table_width"], width)
        bt = self.tables.device_view(width)
        toks = self._i32(self._last_tok)
        lens = self._i32(self._ctx_len)
        live_mask = torch.tensor([r is not None for r in self.active],
                                 device=self.device)
        bud = self._i32([r.max_new_tokens - len(r.out) if r else 0
                         for r in self.active])
        eos = self._i32([r.eos_id if r else -1 for r in self.active])
        return bt, toks, lens, live_mask, bud, eos

    def _dispatch_fused(self, live: list[int], n: int) -> int:
        """One fused decode dispatch: n on-device ticks, ONE host sync."""
        if self.draft_len is not None:   # the adaptive fallback
            self.stats["spec_fallback_dispatches"] += 1
            self._hist_dev = None   # this dispatch appends on the host only
        bt, toks, lens, live_mask, bud, eos = self._dispatch_arrays(live, n)
        t0 = time.perf_counter()
        with self._mesh_cm():
            block, self.pool.pools = decode_ticks(
                self.params, self.cfg, toks, self.pool.pools, bt, lens,
                live_mask, bud, eos, n, max_seq=self.max_seq,
                top_k=self.top_k, temperature=self.temperature,
                generator=self._gen, null_page=self.pool.null_page)
        self._agree(block, "the decode token block")
        block = block.cpu().numpy()   # THE one device->host sync per block
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += n
        self.stats["dispatches"] += 1
        self.stats["host_syncs"] += 1
        finished = 0
        for slot in live:
            req = self.active[slot]
            for t in range(n):
                tok = int(block[t, slot])
                self._ctx_len[slot] += 1   # that tick wrote last_tok's KV
                self._last_tok[slot] = tok
                self._hist[slot, self._ctx_len[slot]] = tok
                self.stats["decode_tokens"] += 1
                if self._emit(req, tok):
                    # the device flag retired this slot at the same tick;
                    # later block[t', slot] entries are -1 filler
                    self._retire(slot)
                    finished += 1
                    break
        return finished

    def _dispatch_spec(self, live: list[int], n: int) -> int:
        """One speculative dispatch: n draft -> verify -> accept steps on
        the device, ONE host sync of an (n, slots, draft_len + 1) token
        block; the replay is ``_dispatch_fused``'s with a variable advance
        per step (-1 marks each window's un-emitted tail)."""
        w = self.draft_len + 1
        span = n * w
        bt, toks, lens, live_mask, bud, eos = self._dispatch_arrays(live,
                                                                    span)
        # one past the last position each slot's write plan mapped pages
        # for (window writes beyond it go to the null page)
        limit = self._i32([self._ctx_len[s] + self._planned_writes(s, span)
                           if self.active[s] is not None else 0
                           for s in range(self.slots)])
        hist = (self._hist_dev if self._hist_dev is not None
                else torch.from_numpy(self._hist).to(self.device))
        t0 = time.perf_counter()
        with self._mesh_cm():
            block, accepted, self._hist_dev, self.pool.pools = verify_ticks(
                self.params, self.cfg, toks, self.pool.pools, bt, lens,
                live_mask, bud, eos, hist, limit, n, max_seq=self.max_seq,
                draft_len=self.draft_len, ngram=self.draft_ngram,
                null_page=self.pool.null_page)
        self._agree(block, "the verify token block")
        # the one device->host sync of the dispatch (the accepted counts
        # follow on the synchronized stream)
        block = block.cpu().numpy()
        accepted = accepted.cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += n
        self.stats["dispatches"] += 1
        self.stats["host_syncs"] += 1
        finished = 0
        for slot in live:
            req = self.active[slot]
            retired = False
            for t in range(n):
                row = [int(x) for x in block[t, slot] if x >= 0]
                if not row:
                    break   # the slot went inactive in an earlier step
                self.stats["spec_windows"] += 1
                self.stats["drafted_tokens"] += self.draft_len
                # from the device: a window cut by the retirement flags can
                # end on an accepted draft, so len(row) - 1 would undercount
                acc_w = int(accepted[t, slot])
                self.stats["accepted_tokens"] += acc_w
                self._spec_recent.append(acc_w)
                for tok in row:
                    self._ctx_len[slot] += 1
                    self._last_tok[slot] = tok
                    self._hist[slot, self._ctx_len[slot]] = tok
                    self.stats["decode_tokens"] += 1
                    if self._emit(req, tok):
                        # the device flags stopped this slot at the same
                        # token (verify_ticks mirrors _emit)
                        self._retire(slot)
                        finished += 1
                        retired = True
                        break
                if retired:
                    break
        return finished

    def _dispatch_legacy(self, live: list[int]) -> int:
        """The single-tick loop: one decode step over full-width tables,
        the argmax read by the host."""
        toks = self._i32(self._last_tok)[:, None]
        lens = self._i32(self._ctx_len)
        self.stats["max_table_width"] = self.pages_per_seq
        t0 = time.perf_counter()
        with self._mesh_cm():
            logits, self.pool.pools = decode_step_paged(
                self.params, self.cfg, toks, self.pool.pools,
                self.tables.device_view(self.pages_per_seq), lens)
        nxt = logits.argmax(-1)
        self._agree(nxt, "the single-tick argmax")
        nxt = nxt.cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_steps"] += 1
        self.stats["dispatches"] += 1
        self.stats["host_syncs"] += 1
        finished = 0
        for slot in live:
            req = self.active[slot]
            self._ctx_len[slot] += 1   # last_tok's KV was just written
            tok = int(nxt[slot])
            self._last_tok[slot] = tok
            self._hist[slot, self._ctx_len[slot]] = tok
            self.stats["decode_tokens"] += 1
            if self._emit(req, tok):
                self._retire(slot)
                finished += 1
        return finished

    def run_until_drained(self, max_ticks: int = 10_000) -> list[Request]:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.active):
                break
            self.tick()
        return self.done

    # -- test/debug surface -------------------------------------------------

    def check_page_invariants(self) -> None:
        """Block-table/pool invariants: live rows disjoint, live pages off
        the free list, live + free == pool."""
        live = [s for s in range(self.slots) if self.active[s] is not None]
        self.tables.check_invariants(self.pool, live)
        n_live = sum(len(self.tables.live_pages(s)) for s in live)
        assert n_live + self.pool.free_count() == self.pool.n_pages, \
            (n_live, self.pool.free_count(), self.pool.n_pages)
