"""Hand-written Hopper kernels for attention, and their wrappers.

Dense flash attention (the training path): ``flash_attention`` replaces
the TPU kernel ``repro/kernels/attention/attention.py:
flash_attention_pallas`` with ``csrc/flash_fwd.cu``, and
``flash_attention_bwd`` is its gradient, ``csrc/flash_bwd.cu`` (the JAX
package has no backward kernel: XLA differentiates its jnp attention).
Both take Sq query positions against Sk keys, as the TPU kernel does (a
cross-attention when they differ).  ``FlashAttention``, a
``torch.autograd.Function``, joins the two: the forward saves O and the f32
row log-sum-exp, the backward recomputes the softmax weights from them.
What bounds them on the card: operations, at 989 TFLOP/s bf16.  The
causal forward does 4 B Hq S^2 D / 2 flops (0.139 ms at B 2, Hq 16, S
4096, D 128); the backward does 3.5 times that, since it recomputes two
products to keep dQ free of atomics.  Their design
against that bound: bf16 at D 64, 112 (padded to 128 in shared memory),
128 and 256 runs every product on ``wgmma`` with TMA loads, a producer
warp and a persistent grid (``csrc/flash_wgmma.cuh``; at D 256, gemma2-2b's
width, with tiles of its own, and a backward whose work is divided anew,
``csrc/flash_wgmma256.cuh``); float32 at D 64 and 128 runs every product
as three TF32 products on ``wgmma`` (``csrc/flash_tf32.cuh``, through the
entries ``flash_fwd_tf32x3`` and ``flash_bwd_tf32x3``, which take a
workspace of the operands' TF32 parts that the wrappers allocate: the
backward as Delta, pre-passes and dQ, dV and dK passes); other widths run
on the CUDA cores.  Where a whole-sequence call's (query block, kv head,
batch) items fill few of the card's processors (seamless-m4t-medium's
cross-attention), bf16 at D 64, 112 and 128 takes the split family
instead: one cluster of 2 CTAs an item, its ranks walking shares of the
item's key tiles and merging on chip, the backward in two launches
(``split_ranks``).  Each
K/V tile is shared by the G query heads of its kv head, and only the
tiles the causal and window masks leave are walked (each source's header
says more).  Besides ``launches``, each of the two wrappers counts its
calls by kernel family in ``variants`` (``"wgmma"``, ``"cluster"``,
``"wgmma_tf32x3"`` or ``"cuda_cores"``), as the library reports the
family it takes for the dtype, D and shape.

Sequence-parallel attention (``repro``'s cut of the key sequence, where
the model axis divides neither head count): ``flash_attention_block`` and
``flash_attention_block_bwd`` are kernels 5 and 5b's key-block entries
(``flash_fwd_block``, ``flash_bwd_block``: the keys are one block of a
longer sequence at an offset; O and dQ come out in f32), each counting its
launches and variants, and ``seq_attention`` (the ``SeqAttention``
autograd Function) merges the blocks over a ``KeyBlocks`` reduction: a
list of blocks in one process, then the ranks of a group.

Paged serving: ``paged_flash_decode`` replaces
``paged_flash_decode_pallas``, ``paged_flash_prefill`` replaces
``paged_flash_prefill_pallas``, and the MLA latent pair
``paged_latent_decode`` and ``paged_latent_prefill`` replace
``paged_latent_decode_pallas`` and ``paged_latent_prefill_pallas``
(``csrc/paged_decode.cu``, ``csrc/paged_prefill.cu``,
``csrc/paged_latent_decode.cu`` and ``csrc/paged_latent_prefill.cu``).
``paged_flash_prefill``, ``paged_flash_decode``, ``paged_latent_prefill``
and ``paged_latent_decode`` count their launches by family in
``variants`` too (prefill ``"mma_sync"``: bf16 on tensor cores,
``"cuda_cores"``; decode ``"mma_sync"``, ``"cuda_cores"``; the latent pair
``"wgmma"``, ``"mma_sync"``, ``"cuda_cores"``).

Speculative verify: ``paged_flash_verify`` and ``paged_latent_verify`` are
the W-token windows of all B slots in one launch, each slot's start read
on the device (JAX vmaps ``paged_flash_prefill_pallas`` and
``paged_latent_prefill_pallas`` over the slots).  In bf16 at the models'
widths both run the ``"cluster"`` family: one launch of thread-block
clusters, one per (slot, kv head) or (slot, 64-row block), whose ranks
size their key shares from the slot's length on the device and merge
their states on chip, with no f32 scratch and no second kernel
(``paged_verify_cluster`` of ``csrc/paged_decode.cu``, kernel 1's walk;
``paged_latent_verify`` of ``csrc/paged_latent_prefill.cu``, kernel 3's).
The other shapes run the prefill kernels with the slot as a grid axis and
key splits sized on the host from the table's width (``paged_verify`` of
``csrc/paged_prefill.cu``; ``paged_latent_verify``'s ``"mma_sync"`` and
``"cuda_cores"``).  They count launches and variants as the prefill
wrappers do.

The kernels are CUDA C++ for ``sm_90a``, built by ``kernels.build`` at
first use and called through their plain C interface with ``ctypes``.
Each wrapper takes the model's layout, checks what the kernel accepts
(device, dtype, shape, contiguity) and raises on anything else, allocates
its outputs with ``torch.empty``, launches on the current stream, raises if
``cudaGetLastError`` reports the launch, and adds one to its ``launches``
count.  A CPU tensor takes the plain version in ``ops`` (or ``ref``)
instead; a CUDA tensor launches the kernel or raises.

A fake tensor (``FakeTensorMode``, the dry-run's) takes the kernel's
path without the library: the wrapper makes the shape checks, allocates
its outputs as fake tensors and records the kernel's work
(``kernels.work``'s formula) in the open counters; it never reads a data
pointer, calls into the library or counts a launch.  On a real tensor
the one check ``work.tracing`` before the launch records the same work
when a counter is open.  Where the work depends on the data (the paged
kernels' lengths), a real call counts what its lengths need and a fake
call the most its block tables allow.  The paged kernels' key-split
scratch is sized by the library and is left out of the fake path; the
flash pair's float32 workspace is sized here (``tf32x3_ws_floats``) and
allocated on both paths.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from repro_torch.kernels.build import c_function as _fn
from repro_torch.kernels import work as _work

INT32_MAX = 2 ** 31 - 1
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong


def _limit(lib_name: str, fn_name: str) -> int:
    return _fn(lib_name, fn_name)()


def _window(window: int | None) -> int:
    w = INT32_MAX if window is None else int(window)
    if not 1 <= w <= INT32_MAX:
        raise ValueError(f"window must be in [1, 2**31 - 1], got {window}")
    return w


def _softcap(logit_cap: float | None) -> float:
    if logit_cap is None:
        return 0.0
    if not logit_cap > 0:
        raise ValueError(f"logit_cap must be > 0, got {logit_cap}")
    return float(logit_cap)


def _check(name: str, t: torch.Tensor, device: torch.device,
           dtype: torch.dtype, ndim: int) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _scratch(n_split: int, rows: int, d: int, device: torch.device
             ) -> tuple[torch.Tensor | None, ...]:
    """f32 scratch for the kernel's key splits: (n_split, rows, d)
    partial accumulators and (n_split, rows, 2) running max and sum."""
    if n_split == 1:
        return None, None
    return (torch.empty((n_split, rows, d), dtype=torch.float32,
                        device=device),
            torch.empty((n_split, rows, 2), dtype=torch.float32,
                        device=device))


# paged_prefill's kernel families, numbered as in csrc/paged_prefill.cu
PREFILL_VARIANTS = ("cuda_cores", "mma_sync")
# paged_decode's, as csrc/paged_decode.cu numbers them (both one cluster
# of CTAs per slot and kv head)
DECODE_VARIANTS = ("cuda_cores", "mma_sync")
# The kernel families of the dense flash libraries and of the latent pair,
# by the number their ``<lib>_variant`` returns ("cluster": the flash
# pair's split family, whose clusters split each item's key range;
# "wgmma_tf32x3": the flash pair's float32 family at D 64 and 128, every
# product three TF32 products on wgmma).
FLASH_VARIANTS = ("cuda_cores", "mma_sync", "wgmma", "cluster",
                  "wgmma_tf32x3")
# The verify entries': the split families of the prefill kernels, and the
# one-launch clusters (paged_latent_verify_variant numbers them so)
VERIFY_VARIANTS = ("cuda_cores", "mma_sync", "cluster")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _slot_keys(lengths: torch.Tensor, offset: int, n: int,
               window: int | None, bound: int, fake: bool
               ) -> tuple[int, int]:
    """(keys, pairs) of a paged walk over B slots whose query t < ``n``
    of slot b sees the lengths[b] + offset + t positions before it, the
    window's last ones at most: from the lengths on a real call, and on a
    fake one from ``bound`` positions a slot (all its table holds)."""
    w = _window(window)
    if fake:
        b = lengths.shape[0]
        return b * min(bound, w + n - 1), b * n * min(bound, w)
    with _work.suspended():
        lens = lengths.long() + offset
        steps = torch.arange(n, device=lens.device)
        keys = int(torch.clamp(lens + n - 1, max=w + n - 1).sum())
        pairs = int(torch.clamp(lens[:, None] + steps, max=w).sum())
    return keys, pairs


def _chunk_pairs(start: int, c: int, window: int | None) -> tuple[int, int]:
    """(keys, pairs) of a prefill chunk at positions [start, start + c):
    position p sees min(p + 1, window) keys."""
    w = _window(window)
    lo, hi = start + 1, start + c
    a = min(hi, w)
    pairs = ((a * (a + 1) - (lo - 1) * lo) // 2 if a >= lo else 0) \
        + (hi - max(a, lo - 1)) * w
    return hi - max(0, start + 1 - w), pairs


def _check_pools(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, hq: int, d: int, lib: str
                 ) -> tuple[int, int, int]:
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes "
                        f"{sorted(map(str, _DTYPES))}")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _check(name, t, q.device, q.dtype, 4)
    if k_pages.shape != v_pages.shape:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} != v_pages "
                         f"{tuple(v_pages.shape)}")
    n_pool, page, hkv, dk = k_pages.shape
    if dk != d or hkv < 1 or hq % hkv:
        raise ValueError(f"q heads {hq} x {d} do not group over pages "
                         f"{tuple(k_pages.shape)}")
    if _work.is_fake(q):
        return n_pool, page, hkv
    # the kernels load K/V rows in 16-byte pieces
    if (d * q.element_size()) % 16 or any(t.data_ptr() % 16
                                          for t in (q, k_pages, v_pages)):
        raise ValueError(f"K/V rows of {d} x {q.dtype} are not 16-byte "
                         f"aligned")
    if hq // hkv > _limit(lib, f"{lib}_max_g"):
        raise ValueError(f"{hq // hkv} query heads per kv head exceed the "
                         f"kernel's {_limit(lib, f'{lib}_max_g')}")
    if d > _limit(lib, f"{lib}_max_d"):
        raise ValueError(f"head_dim {d} exceeds the kernel's "
                         f"{_limit(lib, f'{lib}_max_d')}")
    return n_pool, page, hkv


def _check_slots(tables: torch.Tensor, lengths: torch.Tensor, b: int,
                 device: torch.device) -> None:
    _check("block_tables", tables, device, torch.int32, 2)
    _check("lengths", lengths, device, torch.int32, 1)
    if tables.shape[0] != b or lengths.shape[0] != b:
        raise ValueError(f"block_tables {tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match batch {b}")


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *, scale: float,
                       window: int | None = None,
                       logit_cap: float | None = None) -> torch.Tensor:
    """Paged single-token decode (``csrc/paged_decode.cu``).

    q: (B, 1, Hq, D) contiguous, float32 or bfloat16 (read as
    (B, Hkv, G, D)); k_pages/v_pages: (n_pool, page, Hkv, D) one layer's
    pools; block_tables: (B, width) int32; lengths: (B,) int32 valid
    positions.  Returns (B, 1, Hq, D) in q's dtype.  One launch per
    call, a cluster of CTAs per slot and kv head; ``variants`` counts it
    by the family of its per-warp walk: ``"mma_sync"`` (bf16 at D 64, 128
    or 256, on tensor cores) or ``"cuda_cores"`` (the rest).
    """
    if not q.is_cuda and not _work.is_fake(q):
        from repro_torch.kernels.attention import ops
        return ops.paged_decode_attention(
            q, k_pages, v_pages, block_tables, lengths, scale=scale,
            window=window, logit_cap=logit_cap, use_kernel=False)
    b, one, hq, d = q.shape
    if one != 1:
        raise ValueError(f"decode takes one query per slot, got "
                         f"q {tuple(q.shape)}")
    _check("q", q, q.device, q.dtype, 4)
    n_pool, page, hkv = _check_pools(q, k_pages, v_pages, hq, d,
                                     "paged_decode")
    _check_slots(block_tables, lengths, b, q.device)
    width = block_tables.shape[1]
    out = torch.empty_like(q)
    if _work.tracing(q) and _work.record_call("paged_decode", q, lambda fake: (
            _work.paged_work(q.numel(), block_tables.numel(), b,
                             *_slot_keys(lengths, 0, 1, window, width * page,
                                         fake), hq, hkv, d,
                             q.element_size()))):
        return out
    fn = _fn("paged_decode", "paged_decode",
             (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
              _F, _P))
    with torch.cuda.device(q.device):
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
                 v_pages.data_ptr(), block_tables.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), b, hkv, hq // hkv, d,
                 page, width, n_pool, float(scale), _window(window),
                 _softcap(logit_cap),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {err}")
    paged_flash_decode.launches += 1
    paged_flash_decode.variants[DECODE_VARIANTS[_fn(
        "paged_decode", "paged_decode_variant", (_I, _I))(
            _DTYPES[q.dtype], d)]] += 1
    return out


paged_flash_decode.launches = 0
paged_flash_decode.variants = collections.Counter()


def paged_flash_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, block_row: torch.Tensor,
                        start: int, *, scale: float,
                        window: int | None = None,
                        logit_cap: float | None = None) -> torch.Tensor:
    """Paged chunked prefill for ONE slot (``csrc/paged_prefill.cu``).

    q: (1, C, Hq, D) contiguous at global positions [start, start+C);
    k_pages/v_pages: (n_pool, page, Hkv, D); block_row: (width,) int32
    covering the chunk; ``start`` a host int.  Returns (1, C, Hq, D) in
    q's dtype.  Counts its launches by kernel family in ``variants``:
    ``"mma_sync"`` (bf16 at D 16, 32, 64, 128 or 256, on tensor cores) or
    ``"cuda_cores"`` (the rest).
    """
    if not q.is_cuda and not _work.is_fake(q):
        from repro_torch.kernels.attention import ops
        return ops.paged_prefill_attention(
            q, k_pages, v_pages, block_row, start, window=window,
            logit_cap=logit_cap, scale=scale, use_kernel=False)
    one, c, hq, d = q.shape
    if one != 1:
        raise ValueError(f"prefill takes one slot's chunk, got "
                         f"q {tuple(q.shape)}")
    _check("q", q, q.device, q.dtype, 4)
    n_pool, page, hkv = _check_pools(q, k_pages, v_pages, hq, d,
                                     "paged_prefill")
    _check("block_row", block_row, q.device, torch.int32, 1)
    width = block_row.shape[0]
    start = int(start)
    if start < 0 or start + c > width * page:
        raise ValueError(f"chunk [{start}, {start + c}) is not covered by "
                         f"a block row of {width} pages of {page}")
    out = torch.empty_like(q)
    if _work.tracing(q) and _work.record_call(
            "paged_prefill", q, lambda fake: _work.paged_work(
                q.numel(), width, 0, *_chunk_pairs(start, c, window), hq,
                hkv, d, q.element_size())):
        return out
    n_split = _fn("paged_prefill", "paged_prefill_splits",
                  (_I, _I, _I, _I))(width, page, start, c)
    part_acc, part_ml = _scratch(n_split, c * hq, d, q.device)
    fn = _fn("paged_prefill", "paged_prefill",
             (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
              _I, _F, _I, _F, _P))
    with torch.cuda.device(q.device):
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
                 v_pages.data_ptr(), block_row.data_ptr(), out.data_ptr(),
                 _ptr(part_acc), _ptr(part_ml),
                 c, hq, hkv, d, page, width, n_pool, start, float(scale),
                 _window(window), _softcap(logit_cap),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_prefill launch failed: CUDA error {err}")
    paged_flash_prefill.launches += 1
    paged_flash_prefill.variants[PREFILL_VARIANTS[_fn(
        "paged_prefill", "paged_prefill_variant", (_I, _I))(
            _DTYPES[q.dtype], d)]] += 1
    return out


paged_flash_prefill.launches = 0
paged_flash_prefill.variants = collections.Counter()


def paged_flash_verify(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *, scale: float,
                       window: int | None = None,
                       logit_cap: float | None = None) -> torch.Tensor:
    """Speculative verify over all slots in one launch
    (``csrc/paged_prefill.cu``: ``paged_verify``).

    q: (B, W, Hq, D) contiguous, slot b's window at positions
    lengths[b] + t; k_pages/v_pages: (n_pool, page, Hkv, D); block_tables
    (B, width) int32; lengths (B,) int32 on the device.  Returns
    (B, W, Hq, D) in q's dtype.  ``variants`` counts the family:
    ``"cluster"`` (bf16 at D 64, 128 or 256 with W x G <= 16:
    ``csrc/paged_decode.cu``'s ``paged_verify_cluster``, one cluster of
    CTAs per slot and kv head whose ranks split the slot's live keys, sized
    from ``lengths`` on the device, and merge on chip; no scratch),
    ``"mma_sync"`` (other bf16 shapes) or ``"cuda_cores"`` (float32): the
    prefill kernels with key splits sized on the host from the table's
    width and f32 scratch for their merge.
    """
    if not q.is_cuda and not _work.is_fake(q):
        from repro_torch.kernels.attention import ops
        return ops.paged_verify_attention(
            q, k_pages, v_pages, block_tables, lengths, window=window,
            logit_cap=logit_cap, scale=scale, use_kernel=False)
    b, w, hq, d = q.shape
    _check("q", q, q.device, q.dtype, 4)
    n_pool, page, hkv = _check_pools(q, k_pages, v_pages, hq, d,
                                     "paged_prefill")
    _check_slots(block_tables, lengths, b, q.device)
    width = block_tables.shape[1]
    out = torch.empty_like(q)
    if _work.tracing(q) and _work.record_call("paged_verify", q, lambda fake: (
            _work.paged_work(q.numel(), block_tables.numel(), b,
                             *_slot_keys(lengths, 1, w, window, width * page,
                                         fake), hq, hkv, d,
                             q.element_size()))):
        return out
    dtype = _DTYPES[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if _fn("paged_decode", "paged_verify_cluster_takes", (_I,) * 4)(
            dtype, d, hq // hkv, w):
        variant = "cluster"
        fn = _fn("paged_decode", "paged_verify_cluster",
                 (_P,) * 6 + (_I,) * 8 + (_F, _I, _F, _P))
        args = (b, w, hq, hkv, d, page, width, n_pool)
    else:
        variant = VERIFY_VARIANTS[_fn(
            "paged_prefill", "paged_prefill_variant", (_I, _I))(dtype, d)]
        n_split = _fn("paged_prefill", "paged_verify_splits",
                      (_I, _I))(width, page)
        part_acc, part_ml = _scratch(n_split, b * w * hq, d, q.device)
        fn = functools.partial(_fn(
            "paged_prefill", "paged_verify",
            (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _I, _F, _I, _F, _P)), dtype)
        args = (_ptr(part_acc), _ptr(part_ml), b, w, hq, hkv, d, page, width,
                n_pool)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 *args, float(scale), _window(window), _softcap(logit_cap),
                 stream)
    if err:
        raise RuntimeError(f"paged_verify launch failed: CUDA error {err}")
    paged_flash_verify.launches += 1
    paged_flash_verify.variants[variant] += 1
    return out


paged_flash_verify.launches = 0
paged_flash_verify.variants = collections.Counter()


def _check_latent(q_lat: torch.Tensor, q_rope: torch.Tensor,
                  ckv_pages: torch.Tensor, kr_pages: torch.Tensor,
                  lib: str) -> tuple[int, int, int, int]:
    """Checks shared by the latent wrappers; returns (kv_lora, qk_rope,
    n_pool, page)."""
    if q_lat.dtype not in _DTYPES:
        raise TypeError(f"q_lat has dtype {q_lat.dtype}; the kernel takes "
                        f"{sorted(map(str, _DTYPES))}")
    _check("q_lat", q_lat, q_lat.device, q_lat.dtype, 4)
    _check("q_rope", q_rope, q_lat.device, q_lat.dtype, 4)
    _check("ckv_pages", ckv_pages, q_lat.device, q_lat.dtype, 3)
    _check("kr_pages", kr_pages, q_lat.device, q_lat.dtype, 3)
    kv, rope = q_lat.shape[-1], q_rope.shape[-1]
    n_pool, page = ckv_pages.shape[:2]
    if (q_rope.shape[:3] != q_lat.shape[:3] or ckv_pages.shape[2] != kv
            or tuple(kr_pages.shape) != (n_pool, page, rope)):
        raise ValueError(
            f"latent shapes do not agree: q_lat {tuple(q_lat.shape)}, "
            f"q_rope {tuple(q_rope.shape)}, ckv_pages "
            f"{tuple(ckv_pages.shape)}, kr_pages {tuple(kr_pages.shape)}")
    # the kernels load latent rows in 16-byte pieces
    if kv % 8 or rope % 8:
        raise ValueError(f"kv_lora {kv} and qk_rope {rope} must be "
                         f"multiples of 8")
    if _work.is_fake(q_lat):
        return kv, rope, n_pool, page
    if any(t.data_ptr() % 16 for t in (q_lat, q_rope, ckv_pages, kr_pages)):
        raise ValueError("latent tensors must be 16-byte aligned")
    if kv > _limit(lib, f"{lib}_max_kv"):
        raise ValueError(f"kv_lora {kv} exceeds the kernel's "
                         f"{_limit(lib, f'{lib}_max_kv')}")
    if kv + rope > _limit(lib, f"{lib}_max_feat"):
        raise ValueError(f"kv_lora + qk_rope = {kv + rope} exceeds the "
                         f"kernel's {_limit(lib, f'{lib}_max_feat')}")
    return kv, rope, n_pool, page


def paged_latent_decode(q_lat: torch.Tensor, q_rope: torch.Tensor,
                        ckv_pages: torch.Tensor, kr_pages: torch.Tensor,
                        block_tables: torch.Tensor, lengths: torch.Tensor, *,
                        scale: float) -> torch.Tensor:
    """Paged MLA latent decode (``csrc/paged_latent_decode.cu``).

    q_lat (B, 1, H, kv_lora) and q_rope (B, 1, H, qk_rope) contiguous,
    float32 or bfloat16; ckv_pages (n_pool, page, kv_lora) and kr_pages
    (n_pool, page, qk_rope) one layer's latent pools; block_tables
    (B, width) int32; lengths (B,) int32.  Returns (B, 1, H, kv_lora) in
    q's dtype.  Counts its launches by kernel family in ``variants``:
    ``"wgmma"`` (bf16 at kv_lora 512, qk_rope 64 and pages of a multiple
    of 64: one launch of clusters of 4 CTAs), ``"mma_sync"`` (other bf16
    widths the tensor-core tiles divide) or ``"cuda_cores"``.
    """
    if not q_lat.is_cuda and not _work.is_fake(q_lat):
        from repro_torch.kernels.attention import ops
        return ops.paged_latent_decode_attention(
            q_lat, q_rope, ckv_pages, kr_pages, block_tables, lengths,
            scale=scale, use_kernel=False)
    lib = "paged_latent_decode"
    b, one, h, _ = q_lat.shape
    if one != 1:
        raise ValueError(f"decode takes one query per slot, got "
                         f"q_lat {tuple(q_lat.shape)}")
    kv, rope, n_pool, page = _check_latent(q_lat, q_rope, ckv_pages,
                                           kr_pages, lib)
    _check_slots(block_tables, lengths, b, q_lat.device)
    width = block_tables.shape[1]
    out = torch.empty_like(q_lat)
    if _work.tracing(q_lat) and _work.record_call(lib, q_lat, lambda fake: (
            _work.latent_work(q_lat.numel(), q_rope.numel(),
                              block_tables.numel(), b,
                              *_slot_keys(lengths, 0, 1, None, width * page,
                                          fake), h, kv, rope,
                              q_lat.element_size()))):
        return out
    dtype = _DTYPES[q_lat.dtype]
    variant = FLASH_VARIANTS[_fn(lib, f"{lib}_variant", (_I,) * 4)(
        dtype, kv, rope, page)]
    n_split = 1 if variant == "wgmma" else _fn(
        lib, f"{lib}_splits", (_I, _I, _I, _I))(width, page, b, h)
    part_acc, part_ml = _scratch(n_split, b * h, kv, q_lat.device)
    fn = _fn(lib, lib, (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _F, _P))
    with torch.cuda.device(q_lat.device):
        err = fn(dtype, q_lat.data_ptr(), q_rope.data_ptr(),
                 ckv_pages.data_ptr(), kr_pages.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 _ptr(part_acc), _ptr(part_ml), b, h, kv, rope, page, width,
                 n_pool, float(scale),
                 torch.cuda.current_stream(q_lat.device).cuda_stream)
    if err:
        raise RuntimeError(f"{lib} launch failed: CUDA error {err}")
    paged_latent_decode.launches += 1
    paged_latent_decode.variants[variant] += 1
    return out


paged_latent_decode.launches = 0
paged_latent_decode.variants = collections.Counter()


def paged_latent_prefill(q_lat: torch.Tensor, q_rope: torch.Tensor,
                         ckv_pages: torch.Tensor, kr_pages: torch.Tensor,
                         block_row: torch.Tensor, start: int, *,
                         scale: float) -> torch.Tensor:
    """Paged MLA latent chunked prefill for ONE slot
    (``csrc/paged_latent_prefill.cu``).

    q_lat (1, C, H, kv_lora) and q_rope (1, C, H, qk_rope) contiguous at
    global positions [start, start+C); latent pools as for decode;
    block_row (width,) int32 covering the chunk; ``start`` a host int.
    Returns (1, C, H, kv_lora) in q's dtype.  Counts its launches by
    kernel family in ``variants``: ``"wgmma"`` (bf16 at kv_lora 512,
    qk_rope 64 and pages of a multiple of 64), ``"mma_sync"`` (other bf16
    widths the tensor-core tiles divide) or ``"cuda_cores"``.
    """
    if not q_lat.is_cuda and not _work.is_fake(q_lat):
        from repro_torch.kernels.attention import ops
        return ops.paged_latent_prefill_attention(
            q_lat, q_rope, ckv_pages, kr_pages, block_row, start,
            scale=scale, use_kernel=False)
    lib = "paged_latent_prefill"
    one, c, h, _ = q_lat.shape
    if one != 1:
        raise ValueError(f"prefill takes one slot's chunk, got "
                         f"q_lat {tuple(q_lat.shape)}")
    kv, rope, n_pool, page = _check_latent(q_lat, q_rope, ckv_pages,
                                           kr_pages, lib)
    _check("block_row", block_row, q_lat.device, torch.int32, 1)
    width = block_row.shape[0]
    start = int(start)
    if start < 0 or start + c > width * page:
        raise ValueError(f"chunk [{start}, {start + c}) is not covered by "
                         f"a block row of {width} pages of {page}")
    out = torch.empty_like(q_lat)
    if _work.tracing(q_lat) and _work.record_call(lib, q_lat, lambda fake: (
            _work.latent_work(q_lat.numel(), q_rope.numel(), width, 0,
                              *_chunk_pairs(start, c, None), h, kv, rope,
                              q_lat.element_size()))):
        return out
    dtype = _DTYPES[q_lat.dtype]
    n_split = _fn(lib, f"{lib}_splits", (_I,) * 8)(dtype, kv, rope, width,
                                                   page, c, h, start)
    part_acc, part_ml = _scratch(n_split, c * h, kv, q_lat.device)
    fn = _fn(lib, lib, (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _F, _P))
    with torch.cuda.device(q_lat.device):
        err = fn(dtype, q_lat.data_ptr(), q_rope.data_ptr(),
                 ckv_pages.data_ptr(), kr_pages.data_ptr(),
                 block_row.data_ptr(), out.data_ptr(), _ptr(part_acc),
                 _ptr(part_ml), c, h, kv, rope, page, width, n_pool, start,
                 float(scale),
                 torch.cuda.current_stream(q_lat.device).cuda_stream)
    if err:
        raise RuntimeError(f"{lib} launch failed: CUDA error {err}")
    paged_latent_prefill.launches += 1
    paged_latent_prefill.variants[FLASH_VARIANTS[_fn(
        lib, f"{lib}_variant", (_I,) * 4)(dtype, kv, rope, page)]] += 1
    return out


paged_latent_prefill.launches = 0
paged_latent_prefill.variants = collections.Counter()


def paged_latent_verify(q_lat: torch.Tensor, q_rope: torch.Tensor,
                        ckv_pages: torch.Tensor, kr_pages: torch.Tensor,
                        block_tables: torch.Tensor, lengths: torch.Tensor,
                        *, scale: float) -> torch.Tensor:
    """Speculative MLA latent verify over all slots in one launch
    (``csrc/paged_latent_prefill.cu``: ``paged_latent_verify``).

    q_lat (B, W, H, kv_lora) and q_rope (B, W, H, qk_rope) contiguous,
    slot b's window at positions lengths[b] + t; latent pools as for
    decode; block_tables (B, width) int32; lengths (B,) int32 on the
    device.  Returns (B, W, H, kv_lora) in q's dtype.  ``variants`` counts
    the family: ``"cluster"`` (bf16 at kv_lora 512, qk_rope 64 and pages of
    a multiple of 64: one cluster of CTAs per slot and 64-row block on the
    latent prefill's wgmma walk, whose ranks split the block's live keys,
    sized from ``lengths`` on the device, and merge on chip; no scratch),
    ``"mma_sync"`` or ``"cuda_cores"`` (the other shapes: the latent
    prefill's 16-row families with key splits sized on the host from the
    table's width and f32 scratch for their merge).
    """
    if not q_lat.is_cuda and not _work.is_fake(q_lat):
        from repro_torch.kernels.attention import ops
        return ops.paged_latent_verify_attention(
            q_lat, q_rope, ckv_pages, kr_pages, block_tables, lengths,
            scale=scale, use_kernel=False)
    lib = "paged_latent_prefill"
    b, w, h, _ = q_lat.shape
    kv, rope, n_pool, page = _check_latent(q_lat, q_rope, ckv_pages,
                                           kr_pages, lib)
    _check_slots(block_tables, lengths, b, q_lat.device)
    width = block_tables.shape[1]
    out = torch.empty_like(q_lat)
    if _work.tracing(q_lat) and _work.record_call("paged_latent_verify", q_lat,
                                        lambda fake: _work.latent_work(
            q_lat.numel(), q_rope.numel(), block_tables.numel(), b,
            *_slot_keys(lengths, 1, w, None, width * page, fake), h, kv, rope,
            q_lat.element_size())):
        return out
    dtype = _DTYPES[q_lat.dtype]
    variant = VERIFY_VARIANTS[_fn(lib, "paged_latent_verify_variant",
                                  (_I,) * 4)(dtype, kv, rope, page)]
    part_acc = part_ml = None
    if variant != "cluster":
        n_split = _fn(lib, "paged_latent_verify_splits", (_I,) * 8)(
            dtype, kv, rope, width, page, b, w, h)
        part_acc, part_ml = _scratch(n_split, b * w * h, kv, q_lat.device)
    fn = _fn(lib, "paged_latent_verify",
             (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
              _I, _I, _I, _F, _P))
    with torch.cuda.device(q_lat.device):
        err = fn(dtype, q_lat.data_ptr(), q_rope.data_ptr(),
                 ckv_pages.data_ptr(), kr_pages.data_ptr(),
                 block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 _ptr(part_acc), _ptr(part_ml), b, w, h, kv, rope, page,
                 width, n_pool, float(scale),
                 torch.cuda.current_stream(q_lat.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_latent_verify launch failed: CUDA error "
                           f"{err}")
    paged_latent_verify.launches += 1
    paged_latent_verify.variants[variant] += 1
    return out


paged_latent_verify.launches = 0
paged_latent_verify.variants = collections.Counter()


# ---------------------------------------------------------------------------
# Dense flash attention (training path)
# ---------------------------------------------------------------------------



def _flash_variant(lib: str, dtype: torch.dtype, d: int,
                   ranks: int = 1) -> str:
    """The family a flash call at this dtype, D and rank count launches
    (``ranks`` from ``_flash_ranks``; 1 for the key-block entries)."""
    return FLASH_VARIANTS[_fn(lib, f"{lib}_variant", (_I, _I, _I))(
        _DTYPES[dtype], d, ranks)]


def _flash_ranks(lib: str, dtype: torch.dtype, b: int, sq: int, sk: int,
                 hq: int, hkv: int, d: int, causal: bool, window: int) -> int:
    """The rank count the library splits a whole-sequence call's key
    ranges over on this card (``<lib>_ranks``; ``split_ranks`` mirrors
    it): 1 unless bf16 at D 64, 112 or 128 whose items fill few of the
    card's processors."""
    return _fn(lib, f"{lib}_ranks", (_I,) * 9)(
        _DTYPES[dtype], d, b, sq, sk, hq, hkv, int(bool(causal)), window)


# The head_dims of the flash pair's float32 family (csrc/flash_tf32.cuh's
# ``takes``)
TF32X3_WIDTHS = (64, 128)


def _tf32x3(dtype: torch.dtype, d: int) -> bool:
    """Whether a flash call at this dtype and D runs the float32 family
    (``"wgmma_tf32x3"``, as ``<lib>_variant`` numbers it), which takes a
    workspace through the entries ``<lib>_tf32x3``; decided here, with no
    library loaded, so that a fake call takes the same path."""
    return dtype == torch.float32 and d in TF32X3_WIDTHS


def tf32x3_ws_floats(lib: str, b: int, sq: int, sk: int, hq: int, hkv: int,
                     d: int) -> int:
    """The float32 family's workspace in floats, as
    ``<lib>_tf32x3_ws_floats`` counts it (``csrc/flash_tf32.cuh``): the
    TF32 lo parts of the score products' B operands, whose hi parts are
    the tensors themselves (K forward; K, V, Q and dO backward), and the hi
    and lo parts of the transposed operands, positions rounded up to 8
    (V^T forward; K^T, Q^T and dO^T backward)."""
    nk = b * sk * hkv * d
    tk = 2 * b * hkv * d * (-(-sk // 8) * 8)
    if lib == "flash_fwd":
        return nk + tk
    return 2 * nk + tk + 2 * b * sq * hq * d + 4 * b * hq * d * (
        -(-sq // 8) * 8)


def _tf32x3_ws(lib: str, q: torch.Tensor, k: torch.Tensor
               ) -> torch.Tensor | None:
    """The float32 family's workspace for a call of ``lib`` on q and k,
    allocated before the call's work is recorded, so that a fake call's
    memory counts it as a real one does; None for the other families."""
    b, sq, hq, d = q.shape
    if not _tf32x3(q.dtype, d):
        return None
    return torch.empty(tf32x3_ws_floats(lib, b, sq, k.shape[1], hq,
                                        k.shape[2], d),
                       dtype=torch.float32, device=q.device)


_FWD_TF32X3 = (_I, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _F,
               _I, _I, _F, _I, _P)
_BWD_TF32X3 = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _P, _P, _P, _I, _I,
               _I, _I, _I, _I, _F, _I, _I, _F, _I, _P)


def _fwd_tf32x3(q, k, v, out, lse, ws, kb: int, causal: bool, window: int,
                softcap: float, k_off: int, fn=None) -> int:
    """``flash_fwd_tf32x3`` (kb 0 the whole sequence, 1 the key block at
    k_off) with workspace ``ws`` on the current stream, or ``fn`` (the
    entry of another build of the library, bound to ``_FWD_TF32X3``);
    returns its CUDA error."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    fn = fn or _fn("flash_fwd", "flash_fwd_tf32x3", _FWD_TF32X3)
    return fn(kb, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              lse.data_ptr(), ws.data_ptr(), ws.numel(), b, sq, sk, hq, hkv,
              d, 1.0 / math.sqrt(d), int(bool(causal)), window, softcap,
              k_off, torch.cuda.current_stream(q.device).cuda_stream)


def _bwd_tf32x3(q, k, v, o, lse, d_o, delta, dq, dk, dv, ws, kb: int,
                causal: bool, window: int, softcap: float, k_off: int,
                fn=None) -> int:
    """``flash_bwd_tf32x3`` (kb, ws and fn as ``_fwd_tf32x3``'s, fn bound
    to ``_BWD_TF32X3``); returns its CUDA error."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    fn = fn or _fn("flash_bwd", "flash_bwd_tf32x3", _BWD_TF32X3)
    return fn(kb, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              d_o.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              ws.data_ptr(), ws.numel(), dq.data_ptr(), dk.data_ptr(),
              dv.data_ptr(), b, sq, sk, hq, hkv, d, 1.0 / math.sqrt(d),
              int(bool(causal)), window, softcap, k_off,
              torch.cuda.current_stream(q.device).cuda_stream)


# The cluster sizes of the split family (csrc/flash_wgmma.cuh's
# fwd_split*_kernel and dq_split*_kernel, up to its kMaxRanks), largest
# first
SPLIT_RANKS = (2,)
# keys a tile of the forward and of the dQ pass at D 64, 112 and 128
SPLIT_TILE_KEYS = {"flash_fwd": 128, "flash_bwd": 64}


def split_ranks(lib: str, b: int, sq: int, sk: int, hq: int, hkv: int,
                d: int, dtype: torch.dtype, *, causal: bool,
                window: int | None = None, sms: int = 132) -> int:
    """The rank count ``csrc/flash_wgmma.cuh``'s ``split_ranks`` gives a
    whole-sequence call of ``lib`` ("flash_fwd", or "flash_bwd" for its dQ
    pass) on a card of ``sms`` processors, computed as it computes it: 1
    unless bf16 at D 64, 112 or 128 with fewer (query block, kv head,
    batch) items than processors; then the largest of SPLIT_RANKS with
    items x ranks <= sms whose ranks keep at least two of the longest
    item's key tiles each (``key_range``'s count of ``SPLIT_TILE_KEYS``-key
    tiles), else 1."""
    if dtype != torch.bfloat16 or d not in (64, 112, 128):
        return 1
    w = _window(window)
    bq = 128 // (hq // hkv)
    n_blk = -(-sq // bq)
    items = n_blk * hkv * b
    if items >= sms:
        return 1
    tk = SPLIT_TILE_KEYS[lib]
    k_lim = max(0, min(sq, sk)) if causal else sk
    tiles = 0
    for blk in range(n_blk):
        c0 = blk * bq
        lo = max(0, c0 - w + 1)
        hi = min(c0 + bq, k_lim) if causal else k_lim
        tiles = max(tiles, -(-(hi - lo) // tk))
    for r in SPLIT_RANKS:
        if items * r <= sms and tiles >= 2 * r:
            return r
    return 1


def _check_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lib: str) -> tuple[int, int, int, int, int, int]:
    """Checks shared by the dense wrappers; returns (B, Sq, Sk, Hq, Hkv,
    D): q (B, Sq, Hq, D) against k and v (B, Sk, Hkv, D)."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"q has dtype {q.dtype}; the kernel takes "
                        f"{sorted(map(str, _DTYPES))}")
    _check("q", q, q.device, q.dtype, 4)
    _check("k", k, q.device, q.dtype, 4)
    _check("v", v, q.device, q.dtype, 4)
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d \
            or sq < 1 or sk < 1:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not form (B, Sq, Hq, D) "
                         f"against (B, Sk, Hkv, D)")
    hkv = k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv}")
    if _work.is_fake(q):
        if d % 8:
            raise ValueError(f"head_dim {d} must be a multiple of 8")
        return b, sq, sk, hq, hkv, d
    if hq // hkv > _limit(lib, f"{lib}_max_g"):
        raise ValueError(f"{hq // hkv} query heads per kv head exceed the "
                         f"kernel's {_limit(lib, f'{lib}_max_g')}")
    if d % 8 or d > _limit(lib, f"{lib}_max_d"):
        raise ValueError(f"head_dim {d} must be a multiple of 8 and at most "
                         f"{_limit(lib, f'{lib}_max_d')}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    return b, sq, sk, hq, hkv, d


def _check_window(window: int | None, sq: int, sk: int) -> int:
    """The kernels' window argument; refuses one that leaves the last query
    row no key (Sq - window >= Sk), where a row would have nothing to
    weigh."""
    w = _window(window)
    if sq - w >= sk:
        raise ValueError(f"a window of {w} leaves query rows past "
                         f"{sk + w - 1} no key of {sk}")
    return w


def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, window: int | None, logit_cap: float | None,
               ranks: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel (``csrc/flash_fwd.cu``): q (B, Sq, Hq, D)
    against k, v (B, Sk, Hkv, D), positions from 0 on both sides ->
    (O (B, Sq, Hq, D) in q's dtype, row log-sum-exp (B, Hq, Sq) f32).
    Refuses a window that leaves the last query row no key (Sq - window
    >= Sk), where the kernel's rows would have nothing to weigh.  The
    library splits the key ranges over the ranks ``_flash_ranks`` names
    (variant ``"cluster"`` where they are more than 1); ``ranks`` fixes
    the count instead (1 the unsplit family, 2 the split one, which
    takes bf16 at D 64, 112 and 128; ``flash_fwd_split``), for checks
    and benches.  Counts on ``flash_attention.launches``."""
    lib = "flash_fwd"
    b, sq, sk, hq, hkv, d = _check_dense(q, k, v, lib)
    w = _check_window(window, sq, sk)
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    ws = _tf32x3_ws(lib, q, k)
    if _work.tracing(q) and _work.record_call(
            lib, q, lambda fake: _work.flash_fwd_work(
                b, sq, sk, hq, hkv, d, q.element_size(), causal=causal,
                window=window)):
        return out, lse
    args = (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _F,
            _P)
    if ws is not None:
        if ranks not in (None, 1):
            raise ValueError(f"the float32 family takes no key split, got "
                             f"ranks={ranks}")
        r = 1
        with torch.cuda.device(q.device):
            err = _fwd_tf32x3(q, k, v, out, lse, ws, 0, causal, w,
                              _softcap(logit_cap), 0)
    else:
        if ranks is None:
            fn = _fn(lib, lib, args)
            r = _flash_ranks(lib, q.dtype, b, sq, sk, hq, hkv, d, causal, w)
        else:
            fn = functools.partial(_fn(lib, f"{lib}_split", (_I, *args)),
                                   ranks)
            r = ranks
        with torch.cuda.device(q.device):
            err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, sk,
                     hq, hkv, d, 1.0 / math.sqrt(d), int(bool(causal)), w,
                     _softcap(logit_cap),
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{lib} launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.variants[_flash_variant(lib, q.dtype, d, r)] += 1
    if sq != sk:
        flash_attention.cross_launches += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        d_o: torch.Tensor, *, causal: bool = True,
                        window: int | None = None,
                        logit_cap: float | None = None,
                        ranks: int | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradient of dense flash attention (``csrc/flash_bwd.cu``).

    q, o, d_o (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D) contiguous, positions
    from 0 on both sides as in the forward; lse (B, Hq, Sq) f32 from the
    forward kernel.  Returns (dq, dk, dv) in q's dtype and layouts; a key
    that no query sees gets zero dk and dv.  Refuses what ``_flash_fwd``
    refuses.  The library splits the dQ pass over the ranks
    ``_flash_ranks`` names (variant ``"cluster"``: two launches, Delta
    formed in the dQ pass; else three); ``ranks`` fixes the count, as in
    ``_flash_fwd`` (``flash_bwd_split``).  Either way the one scratch is
    the (B, Hq, Sq) f32 Delta.  Counts its calls in ``launches``, by kernel
    family in ``variants``, and those with Sq != Sk in ``cross_launches``.
    On the CPU it takes the plain gradient (``ref.attention_ref_grad``),
    which needs neither o nor lse."""
    if not q.is_cuda and not _work.is_fake(q):
        from repro_torch.kernels.attention import ref
        grads = ref.attention_ref_grad(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            d_o.transpose(1, 2), causal=causal, window=window,
            logit_cap=logit_cap)
        return tuple(g.transpose(1, 2) for g in grads)
    lib = "flash_bwd"
    b, sq, sk, hq, hkv, d = _check_dense(q, k, v, lib)
    w = _check_window(window, sq, sk)
    _check("o", o, q.device, q.dtype, 4)
    _check("d_o", d_o, q.device, q.dtype, 4)
    _check("lse", lse, q.device, torch.float32, 3)
    if o.shape != q.shape or d_o.shape != q.shape \
            or tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"o {tuple(o.shape)}, d_o {tuple(d_o.shape)} and "
                         f"lse {tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not _work.is_fake(q) and any(t.data_ptr() % 16 for t in (o, d_o,
                                                                lse)):
        raise ValueError("o, d_o and lse must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    ws = _tf32x3_ws(lib, q, k)
    if _work.tracing(q) and _work.record_call(
            lib, q, lambda fake: _work.flash_bwd_work(
                b, sq, sk, hq, hkv, d, q.element_size(), causal=causal,
                window=window)):
        return dq, dk, dv
    args = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
            _I, _F, _I, _I, _F, _P)
    if ws is not None:
        if ranks not in (None, 1):
            raise ValueError(f"the float32 family takes no key split, got "
                             f"ranks={ranks}")
        r = 1
        with torch.cuda.device(q.device):
            err = _bwd_tf32x3(q, k, v, o, lse, d_o, delta, dq, dk, dv, ws, 0,
                              causal, w, _softcap(logit_cap), 0)
    else:
        if ranks is None:
            fn = _fn(lib, lib, args)
            r = _flash_ranks(lib, q.dtype, b, sq, sk, hq, hkv, d, causal, w)
        else:
            fn = functools.partial(_fn(lib, f"{lib}_split", (_I, *args)),
                                   ranks)
            r = ranks
        with torch.cuda.device(q.device):
            err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), d_o.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv, d,
                     1.0 / math.sqrt(d), int(bool(causal)), w,
                     _softcap(logit_cap),
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{lib} launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.variants[_flash_variant(lib, q.dtype, d, r)] += 1
    if sq != sk:
        flash_attention_bwd.cross_launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.variants = collections.Counter()
flash_attention_bwd.cross_launches = 0   # those of them with Sq != Sk


class FlashAttention(torch.autograd.Function):
    """The two dense kernels as one differentiable function of (q, k, v),
    at any Sq and Sk: the forward kernel saves O and the row log-sum-exp,
    the backward kernel turns the output cotangent into (dq, dk, dv)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_cap):
        o, lse = _flash_fwd(q, k, v, causal=causal, window=window,
                            logit_cap=logit_cap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, window, logit_cap)
        return o

    @staticmethod
    def backward(ctx, d_o):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, logit_cap = ctx.opts
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, d_o.contiguous(),
                                         causal=causal, window=window,
                                         logit_cap=logit_cap)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    logit_cap: float | None = None) -> torch.Tensor:
    """Dense flash attention (``csrc/flash_fwd.cu``, differentiable
    through ``csrc/flash_bwd.cu``).

    q (B, Sq, Hq, D), k and v (B, Sk, Hkv, D) contiguous, float32 or
    bfloat16, positions 0..Sq-1 and 0..Sk-1; scale 1/sqrt(D); optional
    causal mask (q_pos >= k_pos), sliding ``window`` (q_pos - k_pos <
    window) and tanh ``logit_cap``.  Returns (B, Sq, Hq, D) in q's dtype.
    A cross-attention (Sq != Sk) without grad mode runs the forward kernel
    alone.  ``launches`` counts forward kernel launches (a remat recompute
    launches again), ``cross_launches`` those with Sq != Sk."""
    if not q.is_cuda and not _work.is_fake(q):
        from repro_torch.kernels.attention import ops
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap, use_kernel=False)
    if q.shape[1] != k.shape[1] and not torch.is_grad_enabled():
        return _flash_fwd(q, k, v, causal=causal, window=window,
                          logit_cap=logit_cap)[0]
    return FlashAttention.apply(q, k, v, causal, window, logit_cap)


flash_attention.launches = 0
flash_attention.variants = collections.Counter()
flash_attention.cross_launches = 0   # those of them with Sq != Sk


# ---------------------------------------------------------------------------
# Sequence-parallel attention: the key-block entries and their merge
# ---------------------------------------------------------------------------

def _check_k_off(k_off: int) -> int:
    k_off = int(k_off)
    if not 0 <= k_off <= INT32_MAX:
        raise ValueError(f"k_off must be in [0, 2**31 - 1], got {k_off}")
    return k_off


def flash_attention_block(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, k_off: int,
                          causal: bool = True, window: int | None = None,
                          logit_cap: float | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel 5's key-block entry (``csrc/flash_fwd.cu``:
    ``flash_fwd_block``): q (B, Sq, Hq, D) at positions 0 .. Sq - 1
    against k, v (B, Sk, Hkv, D), one block of a longer key sequence at
    positions k_off .. k_off + Sk - 1 -> (O (B, Sq, Hq, D) f32, the
    block's normalized partial; row log-sum-exp (B, Hq, Sq) f32).  A row
    that sees no key of the block gets O = 0 and -inf; no window is
    refused.  Counts its launches in ``launches`` and by kernel family in
    ``variants`` (those of ``flash_attention``).  On the CPU it takes the
    plain version, ``ref.attention_block_ref``."""
    k_off = _check_k_off(k_off)
    if not q.is_cuda and not _work.is_fake(q):
        from repro_torch.kernels.attention import ref
        return ref.attention_block_ref(q, k, v, k_off=k_off, causal=causal,
                                       window=window, logit_cap=logit_cap)
    lib = "flash_fwd"
    b, sq, sk, hq, hkv, d = _check_dense(q, k, v, lib)
    w = _window(window)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    ws = _tf32x3_ws(lib, q, k)
    if _work.tracing(q) and _work.record_call(
            "flash_fwd_block", q, lambda fake: _work.flash_fwd_work(
                b, sq, sk, hq, hkv, d, q.element_size(), causal=causal,
                window=window, k_off=k_off)):
        return out, lse
    with torch.cuda.device(q.device):
        if ws is not None:
            err = _fwd_tf32x3(q, k, v, out, lse, ws, 1, causal, w,
                              _softcap(logit_cap), k_off)
        else:
            fn = _fn(lib, "flash_fwd_block", (_I, _P, _P, _P, _P, _P, _I, _I,
                                              _I, _I, _I, _I, _F, _I, _I, _F,
                                              _I, _P))
            err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, sk,
                     hq, hkv, d, 1.0 / math.sqrt(d), int(bool(causal)), w,
                     _softcap(logit_cap), k_off,
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_fwd_block launch failed: CUDA error {err}")
    flash_attention_block.launches += 1
    flash_attention_block.variants[_flash_variant(lib, q.dtype, d)] += 1
    return out, lse


flash_attention_block.launches = 0
flash_attention_block.variants = collections.Counter()


def flash_attention_block_bwd(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, d_o: torch.Tensor, *,
                              k_off: int, causal: bool = True,
                              window: int | None = None,
                              logit_cap: float | None = None
                              ) -> tuple[torch.Tensor, ...]:
    """Kernel 5b's key-block entry (``csrc/flash_bwd.cu``:
    ``flash_bwd_block``): q, o, d_o (B, Sq, Hq, D) and k, v (B, Sk, Hkv,
    D) contiguous, the keys at positions k_off .. as in
    ``flash_attention_block``; o (in q's dtype) and lse (B, Hq, Sq) f32 are
    the MERGED forward's over every block.  Returns (dq (B, Sq, Hq, D)
    f32, this block's partial; dk, dv in k's dtype, the block's own).
    Counts its launches in ``launches`` and ``variants`` (those of
    ``flash_attention_bwd``).  On the CPU it takes the plain version,
    ``ref.attention_block_ref_grad``."""
    k_off = _check_k_off(k_off)
    if not q.is_cuda and not _work.is_fake(q):
        from repro_torch.kernels.attention import ref
        return ref.attention_block_ref_grad(
            q, k, v, o, lse, d_o, k_off=k_off, causal=causal, window=window,
            logit_cap=logit_cap)
    lib = "flash_bwd"
    b, sq, sk, hq, hkv, d = _check_dense(q, k, v, lib)
    w = _window(window)
    _check("o", o, q.device, q.dtype, 4)
    _check("d_o", d_o, q.device, q.dtype, 4)
    _check("lse", lse, q.device, torch.float32, 3)
    if o.shape != q.shape or d_o.shape != q.shape \
            or tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"o {tuple(o.shape)}, d_o {tuple(d_o.shape)} and "
                         f"lse {tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if not _work.is_fake(q) and any(t.data_ptr() % 16 for t in (o, d_o,
                                                                lse)):
        raise ValueError("o, d_o and lse must be 16-byte aligned")
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    ws = _tf32x3_ws(lib, q, k)
    if _work.tracing(q) and _work.record_call(
            "flash_bwd_block", q, lambda fake: _work.flash_bwd_work(
                b, sq, sk, hq, hkv, d, q.element_size(), causal=causal,
                window=window, k_off=k_off)):
        return dq, dk, dv
    with torch.cuda.device(q.device):
        if ws is not None:
            err = _bwd_tf32x3(q, k, v, o, lse, d_o, delta, dq, dk, dv, ws, 1,
                              causal, w, _softcap(logit_cap), k_off)
        else:
            fn = _fn(lib, "flash_bwd_block", (_I, _P, _P, _P, _P, _P, _P, _P,
                                              _P, _P, _P, _I, _I, _I, _I, _I,
                                              _I, _F, _I, _I, _F, _I, _P))
            err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), d_o.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                     dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv, d,
                     1.0 / math.sqrt(d), int(bool(causal)), w,
                     _softcap(logit_cap), k_off,
                     torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_bwd_block launch failed: CUDA error {err}")
    flash_attention_block_bwd.launches += 1
    flash_attention_block_bwd.variants[_flash_variant(lib, q.dtype, d)] += 1
    return dq, dk, dv


flash_attention_block_bwd.launches = 0
flash_attention_block_bwd.variants = collections.Counter()


class KeyBlocks:
    """Where the key blocks' partials meet: the blocks this process holds
    (a list; one per rank under a mesh) are reduced here, then, with a
    ``group``, across its ranks by all-reduce.  One H100 drives the merge
    over a list of blocks, a mesh over its model axis's group."""

    def __init__(self, group=None):
        self.group = group

    def _reduce(self, xs: list, local, op: str) -> torch.Tensor:
        y = local(torch.stack(xs), 0) if len(xs) > 1 else xs[0]
        if self.group is not None:
            # a functional collective: a new tensor (no input is reduced in
            # place), and the step counters see the group's mesh axis
            from torch.distributed import _functional_collectives as funcol
            y = funcol.all_reduce(y, op, self.group)
            if isinstance(y, funcol.AsyncCollectiveTensor):
                y = y.wait()
        return y

    def max(self, xs: list) -> torch.Tensor:
        return self._reduce(xs, torch.amax, "max")

    def sum(self, xs: list) -> torch.Tensor:
        return self._reduce(xs, torch.sum, "sum")


class SeqAttention(torch.autograd.Function):
    """Sequence-parallel attention as one differentiable function of q and
    the key blocks (``seq_attention``).  Forward: each block's entry, then
    the merge (all-reduced max M of the blocks' log-sum-exps, sums of
    exp(lse - M) O and of exp(lse - M)), O rounded once to q's dtype.
    Backward: each block's gradient entry against the merged O and
    log-sum-exp, dQ's partials summed the same way; dK and dV stay with
    their blocks.  q's gradient is then whole on every rank, as DTensor
    expects of a replicated input."""

    @staticmethod
    def forward(ctx, q, blocks, offsets, opts, fwd, bwd, *kv):
        causal, window, logit_cap = opts
        q, kv = q.contiguous(), [t.contiguous() for t in kv]
        parts = [fwd(q, kv[2 * i], kv[2 * i + 1], k_off=off, causal=causal,
                     window=window, logit_cap=logit_cap)
                 for i, off in enumerate(offsets)]
        m = blocks.max([lse for _, lse in parts])
        w = [torch.exp(lse - m) for _, lse in parts]            # (B, Hq, Sq)
        den = blocks.sum(w)
        num = blocks.sum([o * wi.transpose(1, 2)[..., None]
                          for (o, _), wi in zip(parts, w)])
        out = (num / den.transpose(1, 2)[..., None]).to(q.dtype)
        ctx.save_for_backward(q, out, m + torch.log(den), *kv)
        ctx.meta = (blocks, offsets, opts, bwd)
        return out

    @staticmethod
    def backward(ctx, d_o):
        q, out, lse, *kv = ctx.saved_tensors
        blocks, offsets, (causal, window, logit_cap), bwd = ctx.meta
        d_o = d_o.contiguous()
        dqs, dkv = [], []
        for i, off in enumerate(offsets):
            dq, dk, dv = bwd(q, kv[2 * i], kv[2 * i + 1], out, lse, d_o,
                             k_off=off, causal=causal, window=window,
                             logit_cap=logit_cap)
            dqs.append(dq)
            dkv += [dk, dv]
        return (blocks.sum(dqs).to(q.dtype), None, None, None, None, None,
                *dkv)


def seq_attention(q: torch.Tensor, ks: list, vs: list, offsets: list, *,
                  blocks: KeyBlocks, causal: bool = True,
                  window: int | None = None, logit_cap: float | None = None,
                  q_chunk: int = 1024, scale: float | None = None,
                  use_kernel: bool | None = None) -> torch.Tensor:
    """Sequence-parallel attention (``repro.models.layers.attention``'s
    key-sequence cut): q (B, Sq, Hq, D) at positions 0 .. Sq - 1 against
    the key blocks ks[i], vs[i] (B, Sk_i, Hkv, D) at positions offsets[i]
    .., merged over this process's blocks and ``blocks.group``'s ranks ->
    (B, Sq, Hq, D) in q's dtype, whole on every rank.  Together the blocks
    must leave every row a key (the merge divides by the row's weight).
    ``use_kernel=None`` takes the key-block entries of kernels 5 and 5b
    exactly when q is on CUDA (or fake), at the kernels' scale 1/sqrt(D),
    else their plain versions (``ref.attention_block_ref``, over
    ``q_chunk`` query rows at a time, and ``attention_block_ref_grad``)
    at ``scale``."""
    from repro_torch.kernels.attention import ref

    if use_kernel is None:
        use_kernel = _work.on_card(q)
    if use_kernel:
        d = q.shape[-1]
        if scale is not None and scale != 1.0 / math.sqrt(d):
            raise ValueError(f"the flash kernels use scale 1/sqrt({d}), "
                             f"got {scale}")
        fwd, bwd = flash_attention_block, flash_attention_block_bwd
    else:
        fwd = functools.partial(ref.attention_block_ref, q_chunk=q_chunk,
                                scale=scale)
        bwd = functools.partial(ref.attention_block_ref_grad, scale=scale)
    kv = [t for pair in zip(ks, vs) for t in pair]
    return SeqAttention.apply(q, blocks, tuple(int(o) for o in offsets),
                              (causal, window, logit_cap), fwd, bwd, *kv)
