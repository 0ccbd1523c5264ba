"""The hand-written kernels' work, and the hooks by which a wrapper
records it (the kernels' side of ``launch.cost``'s counters).

Each ``*_work`` formula returns one call's (operations, bytes): bytes are
each input read once and each output written once, operations the
products' multiply-adds counted as two.  ``launch.cost`` counts them into
a step's totals, ``chip_smoke.py`` takes its bound column from them.

A wrapper calls ``tracing(t)`` once before its launch: true when ``t`` is
a fake tensor (shape, dtype and device, no storage: the kernel must not
launch) or a counter is open (its work must be recorded).  Then
``record_call`` hands the call's work to every open counter and says
whether the call ends there, on a fake tensor, with its outputs
allocated and no data pointer read.
"""
from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensor

INT32_MAX = 2 ** 31 - 1

# ---------------------------------------------------------------------------
# The kernels' work
# ---------------------------------------------------------------------------


def visible_pairs(sq: int, sk: int, causal: bool = True,
                  window: int | None = None, k_off: int = 0) -> int:
    """(query, key) pairs the dense mask leaves: queries at positions
    0 .. Sq - 1, keys at k_off .. k_off + Sk - 1 (k_off > 0 for one block
    of a longer sequence, the key-block entries).  Query i sees key j when
    j <= i (causal) and i - j < w (window w); a row may see no key of a
    block.  Counted in closed form as the pairs with i - j <= w - 1 less
    those with i - j <= -1 (causal)."""
    def upto(x: int) -> int:
        # sum of clip(y, 0, Sq) over the integers y < x
        if x <= 0:
            return 0
        if x <= sq + 1:
            return x * (x - 1) // 2
        return sq * (sq + 1) // 2 + (x - 1 - sq) * sq

    def below(t: int) -> int:
        # pairs with i - j <= t: for key j, the queries i < j + t + 1
        return upto(k_off + sk + t + 1) - upto(k_off + t + 1)

    pairs = sq * sk if window is None else below(int(window) - 1)
    return max(0, pairs - (below(-1) if causal else 0))


def flash_fwd_work(b: int, sq: int, sk: int, hq: int, hkv: int, d: int,
                   esize: int, *, causal: bool = True,
                   window: int | None = None, k_off: int | None = None
                   ) -> tuple[float, int]:
    """Kernel 5 (``csrc/flash_fwd.cu``): 4 D flops a visible pair and
    query head (QK^T and PV); reads q, k, v, writes o and the f32 row
    log-sum-exp.  With ``k_off`` its key-block entry (``flash_fwd_block``:
    the Sk keys at positions k_off ..), whose o is f32."""
    pairs = visible_pairs(sq, sk, causal, window, k_off or 0)
    flops = 4 * b * hq * pairs * d
    q, k = b * sq * hq * d, b * sk * hkv * d
    o_size = esize if k_off is None else 4
    return flops, esize * (q + 2 * k) + o_size * q + 4 * b * hq * sq


def flash_bwd_work(b: int, sq: int, sk: int, hq: int, hkv: int, d: int,
                   esize: int, *, causal: bool = True,
                   window: int | None = None, k_off: int | None = None
                   ) -> tuple[float, int]:
    """Kernel 5b (``csrc/flash_bwd.cu``): 2.5 times the forward's flops
    (five products a pair where the forward has two); reads q, o, dO, k,
    v and the log-sum-exp, writes dq, dk, dv.  With ``k_off`` its
    key-block entry (``flash_bwd_block``), whose dq is f32."""
    flops, _ = flash_fwd_work(b, sq, sk, hq, hkv, d, esize, causal=causal,
                              window=window, k_off=k_off)
    q, k = b * sq * hq * d, b * sk * hkv * d
    dq_size = esize if k_off is None else 4
    return (2.5 * flops,
            esize * (3 * q + 2 * k) + 4 * b * hq * sq + dq_size * q
            + esize * 2 * k)


def paged_work(q_numel: int, table_numel: int, lengths_numel: int,
               keys: int, pairs: int, hq: int, hkv: int, d: int,
               esize: int) -> tuple[float, int]:
    """Kernels 1, 2 and 2v (paged GQA decode, prefill, verify): 4 D flops
    a visible pair and query head; reads q, the block table, the lengths
    and each visible position's K and V once, writes o."""
    return (4 * pairs * hq * d,
            2 * q_numel * esize + 4 * (table_numel + lengths_numel)
            + 2 * keys * hkv * d * esize)


def latent_work(q_lat_numel: int, q_rope_numel: int, table_numel: int,
                lengths_numel: int, keys: int, pairs: int, h: int, kv: int,
                rope: int, esize: int) -> tuple[float, int]:
    """Kernels 3, 4 and 4v (paged MLA latent decode, prefill, verify):
    2 (kv_lora + qk_rope) flops for the scores and 2 kv_lora for the
    values a visible pair and head; reads q_lat, q_rope, the table, the
    lengths and each visible position's latent row once, writes o_lat."""
    return (pairs * h * (2 * (kv + rope) + 2 * kv),
            esize * (2 * q_lat_numel + q_rope_numel)
            + 4 * (table_numel + lengths_numel) + keys * (kv + rope) * esize)


def matmul_work(n: int, m: int, k: int, esize: int) -> tuple[float, int]:
    """Kernels 6 (``matmul``, ``matmul_plan``): 2 n m k flops; reads A and
    B, writes C."""
    return 2.0 * n * m * k, esize * (n * k + k * m + n * m)


# The card's f32-accurate product: three TF32 products on the tensor cores,
# A_lo B_hi + A_hi B_lo + A_hi B_hi (at ``card.PEAK_TF32_FLOPS``), for
# kernels 5, 5b and 6 in float32 (variant ``wgmma_tf32x3``) and the bound
# of every float32 product.  The formulas here stay the products' own
# flops, which the launch counters record.
TF32_PASSES = 3


LCS_OPS_PER_CELL = 4   # compare, add, max and running max per DP cell


def lcs_work(m: int, n: int) -> tuple[float, int]:
    """Kernel 7 (``csrc/lcs_tile.cu``): LCS_OPS_PER_CELL int32 operations
    a cell of the m x n table; reads s and t, writes the bottom row and the
    right column (int32)."""
    return LCS_OPS_PER_CELL * m * n, 4 * 2 * (m + n)


# ---------------------------------------------------------------------------
# Fake tensors and the open counters
# ---------------------------------------------------------------------------

# The open counters: each has ``add_kernel(name, flops, nbytes)``
_OPEN: list = []


@contextlib.contextmanager
def counting(counter):
    """``counter`` receives every kernel call's work inside the block."""
    _OPEN.append(counter)
    try:
        yield counter
    finally:
        _OPEN.remove(counter)


def is_fake(t: torch.Tensor) -> bool:
    """True for a ``FakeTensor`` (shape, dtype and device, no storage)."""
    return isinstance(t, FakeTensor)


def on_card(t: torch.Tensor) -> bool:
    """The attention entry points' default lowering: the kernels for a
    CUDA tensor, and for a fake tensor of any device (the dry-run counts
    what the card runs); the plain version for a real CPU tensor."""
    return t.is_cuda or is_fake(t)


def tracing(t: torch.Tensor) -> bool:
    """A kernel wrapper's one check before its launch: ``t`` is fake (so
    the kernel must not launch) or a counter is open (so its work must be
    recorded)."""
    return bool(_OPEN) or is_fake(t)


def record_call(name: str, t: torch.Tensor, work) -> bool:
    """A wrapper's record of one call of kernel ``name``, its (flops,
    bytes) from ``work(fake)``; True when ``t`` is fake, and the call ends
    there with its outputs allocated (no data pointer read, no launch)."""
    fake = is_fake(t)
    flops, nbytes = work(fake)
    for c in _OPEN:
        c.add_kernel(name, flops, nbytes)
    return fake


def suspended():
    """A block whose ops no counter sees (a wrapper reading its own data
    to size its record)."""
    from torch.utils._python_dispatch import _disable_current_modes
    return _disable_current_modes()
