"""The port's dense flash attention against ``repro`` on the CPU: the plain
versions (``ref.attention_ref``, ``ops.flash_attention`` and the plain
gradient) against ``repro``'s oracle, its Pallas kernel in interpret mode
and ``jax.grad`` of its chunked model attention; and CPU emulations of the
CUDA kernels' tile walks (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``,
the wgmma kernels of ``csrc/flash_wgmma.cuh`` and, for the backward at
D 256, of ``csrc/flash_wgmma256.cuh``: their persistent item order, the
shared memory layout their TMA loads write and their descriptors read, D 112
padded to 128, the D-256 kernels' tiles, the dK/dV pass split between two
warpgroups with P handed over through shared memory, and the epilogues'
stores, direct or staged through shared memory) against the plain
versions, at Sq == Sk and at Sq != Sk (a cross-attention, forward and
backward).

Inputs are numpy draws from a seed.  Tolerances:
- plain forward vs ``repro`` in float32: atol 2e-5 (as
  ``tests/test_kernels.py``); bf16 with a softcap: atol 3e-2, as there;
- plain gradient vs ``jax.grad`` in float32: atol 1e-5;
- tile-walk emulations vs the plain version: float32 (the CUDA-core walk)
  atol 1e-5 on O and the log-sum-exp, 2e-5 on gradients, which sum over
  more terms; the tensor-core walk, which rounds the softmax weights and
  dS to bf16 before its products and O, dQ, dK, dV on the way out, within
  2e-2 of max(1, max |plain|), the bound ``chip_smoke.py`` holds the
  kernels to on the card.
"""
import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import attention_ref as jattention_ref
from repro.kernels.attention import flash_attention_pallas
from repro.models import layers as JL
from repro_torch.kernels.attention import attention as K
from repro_torch.kernels.attention import ops, ref
from repro_torch.models import layers as TL
from tf32_parts import (tf32_round, tf32_split, tf32_split_fast,
                        tf32_split_raw)

torch.set_num_threads(1)
NEG = -1e30


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bhsd(rng, b, hq, hkv, s, d):
    return (_rand(rng, b, hq, s, d), _rand(rng, b, hkv, s, d),
            _rand(rng, b, hkv, s, d))


# ---------------------------------------------------------------------------
# plain versions against repro
# ---------------------------------------------------------------------------

FWD_CASES = ([dict(hq=hq, hkv=hkv, s=64, d=32, causal=c, bq=32, bk=16)
              for hq, hkv in [(4, 4), (4, 2), (8, 1)] for c in (True, False)]
             + [dict(hq=2, hkv=2, s=128, d=16, causal=True, window=w, bq=32,
                     bk=32) for w in (8, 32)]
             + [dict(hq=2, hkv=2, s=64, d=32, causal=True, logit_cap=50.0,
                     bq=32, bk=32)])


@pytest.mark.parametrize("case", FWD_CASES)
def test_plain_forward_matches_jax(case):
    """``test_kernels.py:57-111``'s GQA, window and softcap cases: the
    port's ``attention_ref`` against ``repro``'s, and the CPU lowering of
    ``ops.flash_attention`` (model layout) against
    ``flash_attention_pallas(interpret=True)``."""
    case = dict(case)
    bq, bk = case.pop("bq"), case.pop("bk")
    hq, hkv, s, d = (case.pop(k) for k in ("hq", "hkv", "s", "d"))
    b = 2 if s == 64 else 1
    q, k, v = _bhsd(np.random.default_rng(hq * 10 + s), b, hq, hkv, s, d)
    want = jattention_ref(q, k, v, **case)
    got = ref.attention_ref(*map(torch.from_numpy, (q, k, v)), **case)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    pallas = flash_attention_pallas(q, k, v, bq=bq, bk=bk, interpret=True,
                                    **case)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2).contiguous()
                  for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, **case)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                               np.asarray(pallas), atol=2e-5, rtol=0)


def test_plain_forward_softcap_bf16_matches_jax():
    rng = np.random.default_rng(6)
    q, k, v = (jnp.asarray(x, jnp.bfloat16)
               for x in _bhsd(rng, 1, 2, 2, 64, 32))
    want = flash_attention_pallas(q, k, v, causal=True, logit_cap=50.0,
                                  bq=32, bk=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32))
                  .to(torch.bfloat16).transpose(1, 2).contiguous()
                  for x in (q, k, v))
    got = K.flash_attention(tq, tk, tv, causal=True, logit_cap=50.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.transpose(1, 2).float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)


GRAD_CASES = [dict(causal=True), dict(causal=False),
              dict(causal=True, window=5), dict(causal=True, logit_cap=4.0),
              dict(causal=False, window=7, logit_cap=9.0)]
# (Sq, Sk): a cross-attention both ways; Sq < Sk causal leaves the keys past
# Sq unseen, Sq > Sk with a window of 20 leaves every row a key
GRAD_CASES += [dict(causal=True, sq=24, sk=40), dict(causal=False, sq=40,
                                                     sk=24),
               dict(causal=True, window=20, sq=40, sk=24),
               dict(causal=False, logit_cap=9.0, sq=24, sk=40)]


@pytest.mark.parametrize("kw", GRAD_CASES)
def test_plain_gradient_matches_jax_grad(kw):
    """dq, dk and dv of the port's plain gradient (``attention_ref_grad``,
    the CPU ``flash_attention_bwd``, and autograd through the CPU
    ``flash_attention``) against ``jax.grad`` of ``repro``'s chunked
    ``layers.attention`` (two query chunks), at Sq == Sk and at Sq != Sk
    (``k_positions`` of length Sk)."""
    kw = dict(kw)
    cross = "sq" in kw
    sq, sk = kw.pop("sq", 24), kw.pop("sk", 24)
    rng = np.random.default_rng(len(kw) * 7 + int(kw["causal"])
                                + (sq + 2 * sk if cross else 0))
    b, hq, hkv, d = 2, 4, 2, 16
    q = _rand(rng, b, sq, hq, d)
    k, v = (_rand(rng, b, sk, hkv, d) for _ in range(2))
    d_o = _rand(rng, b, sq, hq, d)

    def f(q, k, v):
        return JL.attention(q, k, v, q_positions=jnp.arange(sq),
                            k_positions=jnp.arange(sk), q_chunk=16, **kw)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(d_o))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, d_o))
    got_ref = [g.transpose(1, 2) for g in ref.attention_ref_grad(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
        tdo.transpose(1, 2), **kw)]
    got_wrapper = K.flash_attention_bwd(tq, tk, tv, None, None, tdo, **kw)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o = K.flash_attention(*leaves, **kw)
    got_autograd = torch.autograd.grad(o, leaves, tdo)
    for got in (got_ref, got_wrapper, got_autograd):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=0)


def test_model_attention_lowerings_agree_and_reject_other_positions():
    """``layers.attention``: the chunked plain version and the kernel
    lowering (plain on the CPU) agree; the kernel lowering takes only
    positions arange(S) on both sides and the default scale."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(_rand(rng, 2, 40, h, 16)) for h in (4, 2, 2))
    pos = torch.arange(40)
    chunked = TL.attention(q, k, v, q_positions=pos, k_positions=pos,
                           window=9, logit_cap=5.0, q_chunk=16,
                           use_kernel=False)
    lowered = TL.attention(q, k, v, q_positions=pos, k_positions=pos,
                           window=9, logit_cap=5.0, use_kernel=True)
    np.testing.assert_allclose(chunked.numpy(), lowered.numpy(), atol=2e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="arange"):
        TL.attention(q, k, v, q_positions=pos + 3, k_positions=pos + 3,
                     use_kernel=True)
    with pytest.raises(ValueError, match="scale"):
        TL.attention(q, k, v, q_positions=pos, k_positions=pos, scale=0.5,
                     use_kernel=True)


# ---------------------------------------------------------------------------
# CPU emulations of the kernels' tile walks
# ---------------------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class Walk:
    """Tile sizes and order of one kernel family: the CUDA-core kernels (32
    rows or keys per CTA, 32-key / 32-query tiles, f32 weights), the
    wgmma kernels at D 64, 112 and 128 (128 rows or keys, 128-key tiles
    forward, 64-key tiles in the dQ pass, 64-query tiles in the dK/dV pass,
    bf16 weights) and those at D 256 (128 rows, 64-key tiles forward,
    32-key tiles in the dQ pass, 64 keys a CTA over 64-query tiles, the
    dK/dV pass split between two warpgroups, the epilogues of O and dQ
    staged through shared memory).  Rows of a query block are head-major
    (row r: head r // bq at position c0 + r % bq) or, for the wgmma
    kernels, position-major as their TMA box brings them (head r % G at
    position c0 + r // G).  ``sms`` set: a persistent grid of that many
    CTAs (``_cta_items``).  ``box`` set: the width is padded to whole boxes
    of that many columns, zero past the true D (TMA's fill), and only the
    true columns are stored.  ``split``: warpgroup 0 forms P^T and hands
    P^T times the softcap's slope to warpgroup 1 through the shared tile
    (``_p_handover``).  ``staged``: O and dQ leave through the epilogue's
    swizzled pieces (``_staged_rows``).  ``fast_tanh``: the softcap's tanh
    from one exp2 and one division (``_fast_tanh``).  ``ranks`` above 1:
    the split family (one cluster an item, no persistent grid), whose
    ranks walk contiguous shares of each item's key tiles in the forward
    and the dQ pass and merge in rank order (``_rank_tiles``), the dQ
    pass forming Delta from its item's rows.  ``tf32x3``: the float32
    family (``csrc/flash_tf32.cuh``): every product three TF32 products
    (``_tf32x3``), each tile's output product from zero into an f32 total
    through the pre-passed operand's permuted positions
    (``_out_product``), and column tiles starting on a multiple of 8."""

    def __init__(self, rows, tk, keys, tq, mma, position_major=False,
                 tk_dq=None, sms=None, box=None, split=False, staged=False,
                 fast_tanh=False, ranks=1, tf32x3=False):
        self.rows, self.tk, self.keys, self.tq, self.mma = (rows, tk, keys,
                                                            tq, mma)
        self.position_major = position_major
        self.tk_dq = tk_dq or tk
        self.sms = sms
        self.box = box
        self.split = split
        self.staged = staged
        self.fast_tanh = fast_tanh
        self.ranks = ranks
        self.tf32x3 = tf32x3
        self.passes = 3   # TF32 products a product (1: the single pass)

    def round(self, x):
        return _bf16(x) if self.mma else x

    def scores(self, a, b):
        """a (R, D) times b (N, D) transposed: S = Q K^T and its kin."""
        if self.tf32x3:   # B as stored: its hi part the raw f32
            return _tf32x3(a, b.T, self.passes, tf32_split_raw)
        return a @ b.T

    def out(self, w, c):
        """One tile's output product, w (R, n) c (n, D): P V and its kin,
        from zero (the caller adds it into its total)."""
        if self.tf32x3:
            return _out_product(w, c, self.passes)
        return self.round(w) @ c

    def first(self, lo, hi):
        """The first column tile's start over [lo, hi): the float32
        family rounds it down to a multiple of 8 (an empty range stays
        empty)."""
        return lo - lo % 8 if self.tf32x3 and hi > lo else lo

    def pad(self, *ts):
        """The inputs as the kernel's shared memory holds them: D padded
        with zero columns to whole boxes."""
        d = ts[0].shape[-1]
        extra = -d % self.box if self.box else 0
        return [torch.nn.functional.pad(t, (0, extra)) for t in ts]


CUDA_CORES = Walk(rows=32, tk=32, keys=32, tq=32, mma=False)
# 3 CTAs, so each walks several items at these sizes
WGMMA = Walk(rows=128, tk=128, keys=128, tq=64, mma=True,
             position_major=True, tk_dq=64, sms=3, box=64)
# the D-256 kernels' walk (``fwd_kernel`` at ``FwdTraits<256>`` and
# ``csrc/flash_wgmma256.cuh``); at a smaller D the width pads to whole
# 64-column boxes, as TMA's zero fill would
WGMMA256 = Walk(rows=128, tk=64, keys=64, tq=64, mma=True,
                position_major=True, tk_dq=32, sms=3, box=64, split=True,
                staged=True, fast_tanh=True)
# the split family (``fwd_split*_kernel``, ``dq_split*_kernel``): the
# wgmma tiles, one cluster of 2 ranks an item (of 4 in
# ``launch.flash_bench``'s copy built with FLASH_MAX_RANKS 4)
SPLIT2, SPLIT4 = (Walk(rows=128, tk=128, keys=128, tq=64, mma=True,
                       position_major=True, tk_dq=64, box=64, ranks=r)
                  for r in (2, 4))
# the float32 family (``csrc/flash_tf32.cuh``): 128 rows or keys, 32-key
# and 32-query tiles (D 128's; D 64 takes 64), a persistent grid of 3 CTAs
TF32X3, TF32X3_D64 = (Walk(rows=128, tk=t, keys=128, tq=t, mma=False,
                           position_major=True, sms=3, tf32x3=True)
                      for t in (32, 64))
WALKS = [CUDA_CORES, WGMMA256, WGMMA, SPLIT2, SPLIT4, TF32X3, TF32X3_D64]
WALK_IDS = ["cuda_cores", "wgmma_d256", "wgmma", "split2", "split4",
            "tf32x3", "tf32x3_d64"]


def _tf32x3(a, b, passes=3, split_b=tf32_split):
    """a @ b as three TF32 products, A_lo B_hi + A_hi B_lo + A_hi B_hi
    (``csrc/tf32_wgmma.cuh``): A split in registers without conversions
    (``tf32_split_fast``), B by ``split_b``: the pre-pass's rounded split
    (``tf32_split``) of a transposed copy, or ``tf32_split_raw`` of an
    operand loaded as stored (its hi the raw f32); ``passes`` 1: A_hi B_hi
    alone."""
    ah, al = tf32_split_fast(a.contiguous())
    bh, bl = split_b(b.contiguous())
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _perm8(n):
    """Slot c of each 8 of the output product's reduction index: the
    accumulator column ``out_product`` puts in TF32 fragment slot c
    (column 2 t4 + j in slot t4 + 4 j), which is also the position the
    pre-pass (``split_t_kernel``) stores at column c of the transposed
    operand: 8 (c // 8) + 2 (c % 4) + (c % 8) // 4."""
    c = torch.arange(n)
    return (c // 8) * 8 + 2 * (c % 4) + (c % 8) // 4


def _out_product(w, c, passes=3):
    """w (R, n) c (n, D) as the float32 family's output product takes
    it: n padded with zeros to whole groups of 8 (masked columns weigh 0,
    positions past the sequence are 0 in the pre-passed operand), w's
    columns in fragment-slot order against c's positions in the pre-pass's
    permuted order, three TF32 products summed from zero."""
    pad = -w.shape[1] % 8
    w = torch.nn.functional.pad(w, (0, pad))
    c = torch.nn.functional.pad(c, (0, 0, 0, pad))
    perm = _perm8(w.shape[1])
    return _tf32x3(w[:, perm], c[perm], passes)


def _rank_tiles(lo, hi, tk, ranks):
    """The key tiles [lo, hi) in tk-key steps as the split family's
    ranks share them (``rank_share``): rank r takes a contiguous
    ceil(n / ranks) of the n from tile r ceil(n / ranks) on, none past
    the last; one rank takes them all."""
    tiles = list(range(lo, hi, tk))
    share = -(-len(tiles) // ranks)
    return [tiles[r * share:(r + 1) * share] for r in range(ranks)]


def _fragment(rows, cols):
    """Where a warpgroup's m64nN accumulator keeps (row, column) of its
    64 x cols tile: (thread 0-127, register).  Warp w holds rows 16 w ..
    16 w + 15; lane 4 g + t4 rows g and g + 8, columns 8 nt + 2 t4 and the
    next, in registers 4 nt + 2 (row >= g + 8) + (column odd)."""
    r = torch.arange(rows)[:, None]
    c = torch.arange(cols)[None, :]
    tid = (r // 16) * 32 + (r % 8) * 4 + (c % 8) // 2
    reg = 4 * (c // 8) + 2 * ((r % 16) // 8) + c % 2
    return tid.expand(rows, cols), reg.expand(rows, cols)


def _p_handover(pc):
    """Warpgroup 0's P^T times the softcap's slope (64 keys x 64 queries)
    through the shared tile to warpgroup 1, as ``dkv256_kernel`` hands it
    over: thread t writes float4 i (registers 4 i .. 4 i + 3) at 16 bytes x
    (128 i + t), and thread t of warpgroup 1, whose dP^T sits in the same
    registers, reads it back from there.  Returns what warpgroup 1 reads,
    in (key, query) order; every float of the 16 KB tile is written once."""
    tid, reg = _fragment(*pc.shape)
    word = ((reg // 4) * 128 + tid) * 4 + reg % 4
    assert sorted(word.flatten().tolist()) == list(range(pc.numel()))
    tile = torch.full((pc.numel(),), math.nan)
    tile[word.flatten()] = pc.flatten()
    return tile[word]


def _piece_units(rows, elem):
    """The staged epilogue's piece (``stage_piece`` / ``copy_piece``): 64
    rows x 128 bytes, 16-byte unit u of row r at unit u ^ (r % 8).  The
    byte offset of each (row, column) of a piece of ``elem``-byte values."""
    cols = 128 // elem
    r = torch.arange(rows)[:, None]
    byte = torch.arange(cols)[None, :] * elem
    return r * 128 + ((byte // 16) ^ (r % 8)) * 16 + byte % 16


def _staged_rows(acc, elem):
    """A warpgroup's 64 x D accumulator out through the staged epilogue:
    pieces of 128 / elem columns, each written at the fragment's (row,
    column) into its swizzled piece and copied out row by row in 16-byte
    units (thread t: unit t % 8 of rows t / 8 + 16 i).  Returns the rows
    as stored; each element passes through its piece once."""
    rows, d = acc.shape
    cols, per = 128 // elem, 16 // elem
    offs = (_piece_units(rows, elem) // elem).flatten()
    assert len(set(offs.tolist())) == rows * cols
    t = torch.arange(128)
    r = (t // 8)[:, None] + 16 * torch.arange(rows // 16)[None, :]
    u = (t % 8)[:, None].expand_as(r)
    unit = r * (128 // elem) + (u ^ (r % 8)) * per       # (thread, i)
    out = torch.full_like(acc, math.nan)
    for p in range(d // cols):
        piece = torch.full((rows * cols,), math.nan)
        piece[offs] = acc[:, p * cols:(p + 1) * cols].flatten()
        for k in range(per):
            out[r, p * cols + u * per + k] = piece[unit + k]
    return out


def _through_epilogue(acc, live, walk, elem):
    """The live rows acc (in block order) of a query block as the kernel
    stores them: through ``_staged_rows`` for each warpgroup's 64 rows
    when the walk stages its epilogue, else as they are."""
    if not walk.staged:
        return acc
    full = torch.zeros(walk.rows, acc.shape[1])
    full[:len(live)][live] = acc
    out = torch.cat([_staged_rows(full[w:w + 64], elem)
                     for w in range(0, walk.rows, 64)])
    return out[:len(live)][live]


def _fast_tanh(y):
    """tanh as the D-256 kernels take it (``score_log2_fast``): 1 - 2 / (1
    + e^(2y)), from one exp2 and one division."""
    return 1 - 2 / (1 + torch.exp2(y * (2 / math.log(2))))


def _scores(raw, scale, cap, walk=None):
    x = raw * scale
    cg = torch.ones_like(x)
    if cap:
        t = (_fast_tanh if walk is not None and walk.fast_tanh
             else torch.tanh)(x / cap)
        x, cg = t * cap, 1 - t * t
    return x, cg


def _visible(qp, kp, causal, window):
    ok = (qp[:, None] - kp[None, :]) < window
    if causal:
        ok &= kp[None, :] <= qp[:, None]
    return ok


def _cta_items(n, sms):
    """The item indices each CTA of a persistent grid of ``sms`` CTAs takes,
    in order, as ``item_index`` in ``csrc/flash_wgmma.cuh``: rounds of sms
    items, CTA c taking the c-th of an even round and the c-th from the
    end of an odd one."""
    return [[r * sms + (c if r % 2 == 0 else sms - 1 - c)
             for r in range(-(-n // sms))
             if r * sms + (c if r % 2 == 0 else sms - 1 - c) < n]
            for c in range(sms)]


def _item(it, n_blk, hkv, b, descending):
    """Item it of n_blk x Hkv x B as ``item_at``: (block, kv head, batch),
    blocks counted from the last when ``descending``."""
    slot, rest = divmod(it, hkv * b)
    return (n_blk - 1 - slot if descending else slot), rest % hkv, rest // hkv


def _items(n_blk, hkv, b, walk, descending):
    """(block, kv head, batch) items in the order the kernels take them; a
    persistent grid of ``walk.sms`` CTAs walks CTA 0's items first, then
    CTA 1's (the order of the sums within an item does not depend on it)."""
    n = n_blk * hkv * b
    order = (range(n) if walk.sms is None else
             [it for mine in _cta_items(n, walk.sms) for it in mine])
    for it in order:
        yield _item(it, n_blk, hkv, b, descending)


def _live(c0, s, g, walk):
    """Which of a query block's G heads x rows // G positions lie before s,
    in block order."""
    rows = torch.arange(g * (walk.rows // g))
    pos = c0 + (rows // g if walk.position_major else rows % (walk.rows // g))
    return pos < s


def _q_rows(c0, s, g, walk):
    """A query block's bq = rows // G positions x G heads: (head index
    within the kv head's G, position) of its live rows."""
    bq = walk.rows // g
    rows = torch.arange(g * bq)
    if walk.position_major:
        head, pos = rows % g, c0 + rows // g
    else:
        head, pos = rows // bq, c0 + rows % bq
    live = pos < s
    return head[live], pos[live]


def _key_range(c0, q_hi, sk, causal, window):
    """Keys [lo, hi) some row of the query block at c0 may see: from the
    window's start for its first row to its last row's position under the
    causal mask, never past the sk keys (``key_range``)."""
    return max(0, c0 - window + 1), (min(q_hi + 1, sk) if causal else sk)


def emulate_fwd(q, k, v, *, causal, window, cap, walk, visited=None,
                k_off=None):
    """q (B, Sq, Hq, D) against k, v (B, Sk, Hkv, D), f32 -> (O (B, Sq, Hq,
    D), lse (B, Hq, Sq)), by the forward kernel's walk: per (query block,
    kv head, batch) item over the Sq positions, key tiles over the block's
    range ending at Sk, online softmax with masked keys (the ragged last
    tile's past Sk among them) weighing 0.  Each item taken is appended to
    ``visited``.  ``k_off`` set: the key-block entry (the keys at
    positions k_off ..): the masks and the key range see the rows'
    positions less k_off, an item whose range holds no key walks no tile,
    and O stays f32, with O = 0 and lse = -inf on a row that saw no key."""
    shift = k_off or 0
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1 / math.sqrt(d)        # the true D's, as the host passes it
    q, k, v = walk.pad(q, k, v)
    out = torch.full((b, sq, hq, d), math.nan)   # torch.empty's garbage
    lse = torch.full((b, hq, sq), math.nan)
    bq = walk.rows // g
    for blk, h, bi in _items(-(-sq // bq), hkv, b, walk, descending=causal):
        if visited is not None:
            visited.append(("fwd", blk, h, bi))
        c0 = blk * bq
        head, pos = _q_rows(c0, sq, g, walk)
        qr = q[bi, pos, h * g + head]                         # (R, D)
        lo, hi = _key_range(c0 - shift, int(pos.max()) - shift, sk, causal,
                            window)
        parts = []   # each rank's (m, l, acc) over its share of the tiles
        for tiles in _rank_tiles(walk.first(lo, hi), hi, walk.tk,
                                 walk.ranks):
            m = torch.full((len(pos),), NEG)
            l = torch.zeros(len(pos))
            acc = torch.zeros(len(pos), q.shape[-1])
            for t0 in tiles:
                kp = torch.arange(t0, min(t0 + walk.tk, hi))
                x, _ = _scores(walk.scores(qr, k[bi, kp, h]), scale, cap,
                               walk)
                ok = _visible(pos - shift, kp, causal, window)
                x = torch.where(ok, x, NEG)
                m_new = torch.maximum(m, x.max(1).values)
                p = torch.where(ok, torch.exp(x - m_new[:, None]), 0.0)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(1)
                acc = acc * alpha[:, None] + walk.out(p, v[bi, kp, h])
                m = m_new
            parts.append((m, l, acc))
        # the ranks' merge, in rank order, each weighed by exp(m_r - max m)
        m = torch.stack([pm for pm, _, _ in parts]).max(0).values
        l = torch.zeros(len(pos))
        acc = torch.zeros(len(pos), q.shape[-1])
        for pm, pl, pa in parts:
            wr = torch.exp(pm - m)
            l = l + pl * wr
            acc = acc + pa * wr[:, None]
        acc = acc / l.clamp(min=1e-30)[:, None]
        assert not acc[:, d:].any()     # the zero columns add nothing
        acc = _through_epilogue(acc, _live(c0, sq, g, walk), walk,
                                4 if k_off is not None else 2)
        out[bi, pos, h * g + head] = acc[:, :d]   # the true columns only
        row_lse = m + torch.log(l.clamp(min=1e-30))
        if k_off is not None:
            row_lse = torch.where(l == 0, -math.inf, row_lse)
        lse[bi, h * g + head, pos] = row_lse
    return (out if k_off is not None else walk.round(out)), lse


def emulate_bwd(q, k, v, o, lse, d_o, *, causal, window, cap, walk,
                visited=None, k_off=None):
    """(dq, dk, dv) by the backward kernel's three launches, q, o, d_o
    (B, Sq, Hq, D) against k, v (B, Sk, Hkv, D): Delta over the Sq rows,
    the dQ pass over the forward's query blocks (``walk.tk_dq``-key tiles
    over the block's key range ending at Sk), and the dK/dV pass per (key
    block over the Sk, kv head, batch) item over the G heads and their
    query tiles (ending at Sq; none for a block no query sees, whose rows
    are stored as zeros).  The split family (``walk.ranks`` > 1) takes two:
    its dQ pass forms each item's Delta from the item's O and dO rows
    (NaN until then, so a row the pass misses shows in dK and dV) and
    adds its ranks' partial dQ in rank order.  Outputs start as NaN
    (``torch.empty``'s garbage), so a row the walk does not store shows.
    Items taken are appended to ``visited``.  ``k_off`` set: the key-block
    entry, o and lse the merged forward's; the dQ pass compares the rows'
    positions less k_off, the dK/dV pass the keys' plus k_off, and dQ
    stays f32."""
    shift = k_off or 0
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1 / math.sqrt(d)
    delta = (d_o * o).sum(-1).transpose(1, 2)                 # (B, Hq, Sq)
    if walk.ranks > 1:
        delta = torch.full_like(delta, math.nan)
    dq, dk, dv = (torch.full_like(t, math.nan) for t in (q, k, v))
    q, k, v, d_o = walk.pad(q, k, v, d_o)
    bq = walk.rows // g
    for blk, h, bi in _items(-(-sq // bq), hkv, b, walk, descending=causal):
        if visited is not None:
            visited.append(("dq", blk, h, bi))
        c0 = blk * bq
        head, pos = _q_rows(c0, sq, g, walk)
        hh = h * g + head
        qr, gr = q[bi, pos, hh], d_o[bi, pos, hh]
        if walk.ranks > 1:   # Delta from the item's own O and dO rows
            delta[bi, hh, pos] = (gr[:, :d] * o[bi, pos, hh]).sum(-1)
        lo, hi = _key_range(c0 - shift, int(pos.max()) - shift, sk, causal,
                            window)
        acc = torch.zeros(len(pos), q.shape[-1])
        for tiles in _rank_tiles(walk.first(lo, hi), hi, walk.tk_dq,
                                 walk.ranks):
            part = torch.zeros(len(pos), q.shape[-1])   # this rank's dQ
            for t0 in tiles:
                kp = torch.arange(t0, min(t0 + walk.tk_dq, hi))
                x, cg = _scores(walk.scores(qr, k[bi, kp, h]), scale, cap,
                                walk)
                ok = _visible(pos - shift, kp, causal, window)
                p = torch.where(ok, torch.exp(x - lse[bi, hh, pos][:, None]),
                                0.0)
                dp = walk.scores(gr, v[bi, kp, h])
                ds = p * (dp - delta[bi, hh, pos][:, None]) * cg
                part += walk.out(ds, k[bi, kp, h])
            acc = acc + part     # the ranks' merge, in rank order
        assert not acc[:, d:].any()
        acc = _through_epilogue(acc * scale, _live(c0, sq, g, walk), walk,
                                4 if k_off is not None else 2)
        dq[bi, pos, hh] = acc[:, :d]
    # causal: the first key blocks see the most queries
    for blk, h, bi in _items(-(-sk // walk.keys), hkv, b, walk,
                             descending=not causal):
        if visited is not None:
            visited.append(("dkv", blk, h, bi))
        k0 = blk * walk.keys
        kp = torch.arange(k0, min(k0 + walk.keys, sk))
        kb, vb = k[bi, kp, h], v[bi, kp, h]
        dk_acc = torch.zeros(len(kp), k.shape[-1])
        dv_acc = torch.zeros(len(kp), k.shape[-1])
        q_lo = k0 + shift if causal else 0
        q_hi = min(sq, int(kp[-1]) + shift + window)
        for gi, t0 in ((gi, t0) for gi in range(g) for t0 in range(
                walk.first(q_lo, q_hi), q_hi, walk.tq)):
            hh = h * g + gi
            qp = torch.arange(t0, min(t0 + walk.tq, q_hi))
            x, cg = _scores(walk.scores(kb, q[bi, qp, hh]), scale, cap,
                            walk)
            ok = _visible(qp, kp + shift, causal, window).T  # (keys, q)
            p = torch.where(ok, torch.exp(x - lse[bi, hh, qp]), 0.0)
            dpt = walk.scores(vb, d_o[bi, qp, hh])
            if walk.split:   # P^T cg from warpgroup 0's registers
                pc = torch.zeros(walk.keys, walk.tq)
                pc[:len(kp), :len(qp)] = p * cg
                pc = _p_handover(pc)[:len(kp), :len(qp)]
                ds = pc * (dpt - delta[bi, hh, qp])
            else:
                ds = p * (dpt - delta[bi, hh, qp]) * cg
            dv_acc += walk.out(p, d_o[bi, qp, hh])
            dk_acc += walk.out(ds, q[bi, qp, hh])
        assert not dk_acc[:, d:].any() and not dv_acc[:, d:].any()
        dk[bi, kp, h] = dk_acc[:, :d] * scale
        dv[bi, kp, h] = dv_acc[:, :d]
    return ((dq if k_off is not None else walk.round(dq)), walk.round(dk),
            walk.round(dv))


EMU_CASES = [dict(causal=True), dict(causal=False),
             dict(causal=True, window=9), dict(causal=True, logit_cap=5.0),
             dict(causal=False, window=20, logit_cap=30.0)]


@pytest.mark.parametrize("walk", WALKS, ids=WALK_IDS)
@pytest.mark.parametrize("g,s", [(1, 77), (2, 128), (3, 77), (8, 70)])
@pytest.mark.parametrize("kw", EMU_CASES)
def test_kernel_tile_walks_match_plain(walk, g, s, kw):
    """The kernels' walks: query blocks of G heads x rows/G positions
    (G = 3 leaves rows unused; head-major or, for wgmma, position-major),
    the ragged last tile (S = 77, 70), the causal, window and softcap
    masks, only the tiles the masks leave, the row log-sum-exp, dK/dV
    summed over the G heads of a kv head, and every item of each launch
    taken once (for wgmma by a persistent grid of 3 CTAs)."""
    rng = np.random.default_rng(g * 100 + s)
    b, hkv, d = 2, 2, 16
    q, k, v, d_o = (torch.from_numpy(_rand(rng, b, s, h, d))
                    for h in (hkv * g, hkv, hkv, hkv * g))
    if walk.mma:     # the tensor-core kernels take bf16 inputs
        q, k, v, d_o = map(_bf16, (q, k, v, d_o))
    window = kw.get("window", 2 ** 31 - 1)
    cap = kw.get("logit_cap")
    visited = []
    o, lse = emulate_fwd(q, k, v, causal=kw["causal"], window=window,
                         cap=cap, walk=walk, visited=visited)
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    want_o = ref.attention_ref(*tr[:3], **kw).transpose(1, 2)
    grads = emulate_bwd(q, k, v, o, lse, d_o, causal=kw["causal"],
                        window=window, cap=cap, walk=walk, visited=visited)
    n_q = -(-s // (walk.rows // g)) * hkv * b
    n_k = -(-s // walk.keys) * hkv * b
    assert len(set(visited)) == len(visited) == 2 * n_q + n_k
    want_g = [t.transpose(1, 2) for t in ref.attention_ref_grad(*tr, **kw)]
    # the row log-sum-exp of the plain version's masked, capped scores
    qe, ke = tr[0], tr[1].repeat_interleave(g, 1)
    x = qe @ ke.transpose(-1, -2) / math.sqrt(d)
    if cap:
        x = torch.tanh(x / cap) * cap
    pos = torch.arange(s)
    x = torch.where(_visible(pos, pos, kw["causal"], window), x, NEG)
    want_lse = torch.logsumexp(x, -1)
    if walk.mma:
        tol = lambda w: 2e-2 * max(1.0, float(w.abs().max()))  # noqa: E731
        assert float((lse - want_lse).abs().max()) <= 1e-4
    else:
        tol = lambda w: 1e-5 if w is want_o else 2e-5  # noqa: E731
        assert float((lse - want_lse).abs().max()) <= 1e-5
    assert float((o - want_o).abs().max()) <= tol(want_o)
    for got, want in zip(grads, want_g):
        assert float((got - want).abs().max()) <= tol(want)


@pytest.mark.parametrize("walk", WALKS, ids=WALK_IDS)
@pytest.mark.parametrize("sq,sk", [(77, 200), (200, 77), (128, 300),
                                   (256, 64), (300, 1000)])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=40),
                                dict(causal=False, window=150,
                                     logit_cap=30.0)])
def test_forward_walks_at_their_own_key_length(walk, sq, sk, g, kw):
    """The forward walks with Sq != Sk, as a cross-attention calls them:
    query blocks over the Sq positions, key ranges ending at Sk (the
    ragged last key tile masked there), a causal mask with Sq < Sk (keys
    past the last query never walked) and with Sq > Sk (rows past Sk see
    every key), windows that leave every row a key (widened by Sq - Sk
    where Sq > Sk, as ``_flash_fwd`` requires); O and the row
    log-sum-exp against ``ref.attention_ref`` and every item taken once."""
    rng = np.random.default_rng(sq * 1000 + sk + g)
    b, hkv, d = 2, 2, 16
    q = torch.from_numpy(_rand(rng, b, sq, hkv * g, d))
    k, v = (torch.from_numpy(_rand(rng, b, sk, hkv, d)) for _ in range(2))
    if walk.mma:
        q, k, v = map(_bf16, (q, k, v))
    if "window" in kw:     # widened past Sq - Sk, as the wrapper requires
        kw = dict(kw, window=kw["window"] + max(0, sq - sk))
    window = kw.get("window", 2 ** 31 - 1)
    cap = kw.get("logit_cap")
    assert sq - window < sk
    visited = []
    o, lse = emulate_fwd(q, k, v, causal=kw["causal"], window=window,
                         cap=cap, walk=walk, visited=visited)
    assert len(set(visited)) == len(visited) == \
        -(-sq // (walk.rows // g)) * hkv * b
    tr = [t.transpose(1, 2) for t in (q, k, v)]
    want_o = ref.attention_ref(*tr, **kw).transpose(1, 2)
    x = tr[0] @ tr[1].repeat_interleave(g, 1).transpose(-1, -2) / math.sqrt(d)
    if cap:
        x = torch.tanh(x / cap) * cap
    x = torch.where(_visible(torch.arange(sq), torch.arange(sk),
                             kw["causal"], window), x, NEG)
    want_lse = torch.logsumexp(x, -1)
    tol = (2e-2 * max(1.0, float(want_o.abs().max())) if walk.mma
           else 1e-5)
    assert float((o - want_o).abs().max()) <= tol
    assert float((lse - want_lse).abs().max()) <= (1e-4 if walk.mma
                                                   else 1e-5)


@pytest.mark.parametrize("walk", WALKS, ids=WALK_IDS)
@pytest.mark.parametrize("sq,sk", [(77, 200), (200, 77), (128, 300),
                                   (256, 64), (300, 1000)])
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=40),
                                dict(causal=False, window=150,
                                     logit_cap=30.0)])
def test_backward_walks_at_their_own_key_length(walk, sq, sk, g, kw):
    """The backward walks with Sq != Sk, at the forward test's shapes and
    masks: Delta over the Sq rows, the dQ pass's query blocks over Sq with
    key ranges ending at Sk, the dK/dV pass's key blocks over Sk with query
    ranges ending at Sq.  Under the causal mask with Sq < Sk, and under a
    window, whole key blocks are seen by no query: their items walk no
    tile and store zeros (the outputs start as NaN, so an unstored row
    fails), exactly the plain gradient's zeros.  dq, dk and dv against
    ``ref.attention_ref_grad``, every item of each launch taken once."""
    rng = np.random.default_rng(sq * 1000 + sk + g + 7)
    b, hkv, d = 2, 2, 16
    q, d_o = (torch.from_numpy(_rand(rng, b, sq, hkv * g, d))
              for _ in range(2))
    k, v = (torch.from_numpy(_rand(rng, b, sk, hkv, d)) for _ in range(2))
    if walk.mma:
        q, k, v, d_o = map(_bf16, (q, k, v, d_o))
    if "window" in kw:
        kw = dict(kw, window=kw["window"] + max(0, sq - sk))
    window = kw.get("window", 2 ** 31 - 1)
    cap = kw.get("logit_cap")
    o, lse = emulate_fwd(q, k, v, causal=kw["causal"], window=window,
                         cap=cap, walk=walk)
    visited = []
    grads = emulate_bwd(q, k, v, o, lse, d_o, causal=kw["causal"],
                        window=window, cap=cap, walk=walk, visited=visited)
    n_q = -(-sq // (walk.rows // g)) * hkv * b
    n_k = -(-sk // walk.keys) * hkv * b
    assert len(set(visited)) == len(visited) == n_q + n_k
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    want = [t.transpose(1, 2) for t in ref.attention_ref_grad(*tr, **kw)]
    # keys no query sees: exactly zero in both
    seen = _visible(torch.arange(sq), torch.arange(sk), kw["causal"],
                    window).any(0)
    if kw["causal"] and sq < sk:
        assert not seen[sq:].any()
    for got, w in zip(grads[1:], want[1:]):
        assert torch.equal(got[:, ~seen], torch.zeros_like(got[:, ~seen]))
        assert torch.equal(w[:, ~seen], torch.zeros_like(w[:, ~seen]))
    for got, w in zip(grads, want):
        tol = (2e-2 * max(1.0, float(w.abs().max())) if walk.mma
               else 2e-5)
        assert float((got - w).abs().max()) <= tol


def test_cross_attention_gradient_through_the_autograd_function(
        monkeypatch):
    """``FlashAttention`` at Sq != Sk (Sq < Sk causal, so the last keys are
    seen by no query, and Sq > Sk): the forward kernel's emulation saves O
    and the log-sum-exp of Sq rows, the backward wrapper gets q, o, d_o of
    Sq rows and k, v of Sk, and its walk's (dq, dk, dv) are the plain
    gradient, whichever inputs require one; the public ``flash_attention``
    on the CPU gives the same through autograd of the plain version.
    Nothing refuses a gradient at Sq != Sk."""
    rng = np.random.default_rng(9)
    calls = []

    def fwd(q, k, v, *, causal, window, logit_cap):
        return emulate_fwd(q, k, v, causal=causal, window=window or 2 ** 31,
                           cap=logit_cap, walk=CUDA_CORES)

    def bwd(q, k, v, o, lse, d_o, *, causal, window, logit_cap):
        calls.append((q.shape[1], k.shape[1], tuple(lse.shape)))
        return emulate_bwd(q, k, v, o, lse, d_o, causal=causal,
                           window=window or 2 ** 31, cap=logit_cap,
                           walk=CUDA_CORES)

    monkeypatch.setattr(K, "_flash_fwd", fwd)
    monkeypatch.setattr(K, "flash_attention_bwd", bwd)
    for sq, sk, causal in ((40, 72, True), (72, 40, False)):
        q, d_o = (torch.from_numpy(_rand(rng, 2, sq, 4, 16))
                  for _ in range(2))
        k, v = (torch.from_numpy(_rand(rng, 2, sk, 2, 16)) for _ in range(2))
        tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
        want = [t.transpose(1, 2) for t in ref.attention_ref_grad(
            *tr, causal=causal)]
        for needs in ((True, True, True), (True, False, False),
                      (False, True, True)):
            leaves = [t.clone().requires_grad_(n) for t, n in
                      zip((q, k, v), needs)]
            o = K.FlashAttention.apply(*leaves, causal, None, None)
            o.backward(d_o)
            for leaf, n, w in zip(leaves, needs, want):
                assert (leaf.grad is not None) == n
                if n:
                    assert float((leaf.grad - w).abs().max()) <= 2e-5
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            o = K.flash_attention(*leaves, causal=causal)
            for g_, w in zip(torch.autograd.grad(o, leaves, d_o), want):
                assert float((g_ - w).abs().max()) <= 1e-5
        if causal:
            assert torch.equal(want[1][:, sq:], torch.zeros_like(
                want[1][:, sq:]))
    assert calls == [(40, 72, (2, 4, 40))] * 3 + [(72, 40, (2, 4, 72))] * 3


@pytest.mark.parametrize("s,g,causal,window", [
    (4096, 2, True, 2 ** 31 - 1), (77, 3, True, 9), (300, 6, False, 40),
    (1000, 8, False, 2 ** 31 - 1)])
def test_persistent_walk_takes_the_longest_items_first(s, g, causal, window):
    """The wgmma kernels' persistent grid (132 CTAs, the H100's SMs, at
    B 2 x Hkv 8): each item of the forward (and dQ) pass and of the dK/dV
    pass is taken once, every CTA meets its items longest first, by the
    keys a query block sees or the queries a key block sees, and the CTAs'
    totals spread no wider than under a plain stride of gridDim.x."""
    walk = Walk(rows=128, tk=128, keys=128, tq=64, mma=True,
                position_major=True, tk_dq=64, sms=132)
    b, hkv = 2, 8
    bq = walk.rows // g
    n_q, n_k = -(-s // bq), -(-s // walk.keys)

    def key_len(blk):
        c0 = blk * bq
        lo, hi = _key_range(c0, min(c0 + bq, s) - 1, s, causal, window)
        return hi - lo

    def query_len(blk):
        k0 = blk * walk.keys
        k_last = min(k0 + walk.keys, s) - 1
        return min(s, k_last + window) - (k0 if causal else 0)

    for n_blk, length, descending in ((n_q, key_len, causal),
                                      (n_k, query_len, not causal)):
        items = list(_items(n_blk, hkv, b, walk, descending))
        assert sorted(items) == sorted(
            (blk, h, bi) for blk in range(n_blk) for h in range(hkv)
            for bi in range(b))
        def spread(per_cta):
            totals = [sum(length(_item(it, n_blk, hkv, b, descending)[0])
                          for it in mine) for mine in per_cta]
            return max(totals) - min(totals)

        for mine in _cta_items(len(items), walk.sms):
            lens = [length(_item(it, n_blk, hkv, b, descending)[0])
                    for it in mine]
            assert lens == sorted(lens, reverse=True)
        # the snake order balances the CTAs at least as well as a stride
        stride = [list(range(c, len(items), walk.sms))
                  for c in range(walk.sms)]
        assert spread(_cta_items(len(items), walk.sms)) <= spread(stride)


# (name, (B, Hq, Hkv, Sq, Sk, D, causal, window), dtype, the forward's
# ranks, the dQ pass's): the rows' shapes and the training shape keep one
# rank; seamless-m4t-medium's cross-attention (64 items against 1024 keys)
# splits both passes, its decoder self-attention (64 items at S 256:
# query blocks of one or two 128-key tiles) only the dQ pass's 64-key
# tiles, and the teacher-forced forward's cross-attention at 32 target
# tokens (32 items) into 4
SPLIT_CHOICES = [
    ("row 5, training", (2, 16, 8, 4096, 4096, 128, True, None),
     torch.bfloat16, 1, 1),
    ("row 5@112", (1, 32, 32, 2048, 2048, 112, True, None),
     torch.bfloat16, 1, 1),
    ("row 5@256", (2, 8, 4, 4096, 4096, 256, True, None),
     torch.bfloat16, 1, 1),
    ("seamless encoder", (2, 16, 16, 1024, 1024, 64, False, None),
     torch.bfloat16, 1, 1),
    ("seamless cross", (2, 16, 16, 256, 1024, 64, False, None),
     torch.bfloat16, 2, 2),
    ("seamless decoder self", (2, 16, 16, 256, 256, 64, True, None),
     torch.bfloat16, 1, 2),
    ("seamless cross, 32 tokens", (2, 16, 16, 32, 1024, 64, False, None),
     torch.bfloat16, 2, 2),
    ("seamless cross, f32", (2, 16, 16, 256, 1024, 64, False, None),
     torch.float32, 1, 1),
    ("cross at D 16", (2, 16, 16, 256, 1024, 16, False, None),
     torch.bfloat16, 1, 1),
    ("window", (1, 8, 8, 512, 2048, 128, False, 256), torch.bfloat16, 2, 2),
    ("causal window", (1, 8, 8, 1024, 1024, 128, True, 200),
     torch.bfloat16, 1, 2),
]


@pytest.mark.parametrize("name,shape,dtype,want_fwd,want_bwd",
                         SPLIT_CHOICES, ids=[c[0] for c in SPLIT_CHOICES])
def test_split_ranks_choose_from_the_items_and_their_tiles(
        name, shape, dtype, want_fwd, want_bwd):
    """``attention.split_ranks``, the mirror of ``csrc/flash_wgmma.cuh``'s
    chooser, on the H100's 132 processors: one rank where the items fill
    the card or the family has no split; else the largest count that keeps
    items x ranks within the processors and at least two of the longest
    item's key tiles a rank (counted by ``_key_range`` here)."""
    b, hq, hkv, sq, sk, d, causal, window = shape
    w = window or 2 ** 31 - 1
    for lib, want in (("flash_fwd", want_fwd), ("flash_bwd", want_bwd)):
        got = K.split_ranks(lib, b, sq, sk, hq, hkv, d, dtype,
                            causal=causal, window=window)
        assert got == want, (name, lib, got)
        bq = 128 // (hq // hkv)
        items = -(-sq // bq) * hkv * b
        tk = 128 if lib == "flash_fwd" else 64
        tiles = max(-(-(hi - lo) // tk) for lo, hi in (
            _key_range(c0, min(c0 + bq, sq) - 1, sk, causal, w)
            for c0 in range(0, sq, bq)))
        if got > 1:
            assert items * got <= 132 and tiles >= 2 * got
        elif dtype == torch.bfloat16 and d in (64, 112, 128):
            assert items >= 132 or tiles < 4 or items * 2 > 132


def test_split_ranks_never_leave_a_rank_under_two_tiles():
    """Over a sweep of small grids (B 1-2, Hkv 1-16, G 1-4, Sq and Sk 16
    to 4096, causal or not, windows): a split is chosen only below 132
    items, never over-fills the processors, and never gives the longest
    item's ranks fewer than two key tiles each."""
    rng = np.random.default_rng(5)
    seen = collections.Counter()
    for _ in range(400):
        b, hkv, g = int(rng.integers(1, 3)), int(rng.integers(1, 17)), \
            int(rng.choice([1, 2, 4]))
        sq, sk = (int(x) for x in rng.integers(16, 4097, size=2))
        causal = bool(rng.integers(2))
        window = None if rng.integers(2) else int(rng.integers(
            max(1, sq - sk + 1), 4097))
        w = window or 2 ** 31 - 1
        bq = 128 // g
        items = -(-sq // bq) * hkv * b
        for lib, tk in (("flash_fwd", 128), ("flash_bwd", 64)):
            r = K.split_ranks(lib, b, sq, sk, hkv * g, hkv, 64,
                              torch.bfloat16, causal=causal, window=window)
            seen[r] += 1
            tiles = max(-(-(hi - lo) // tk) for lo, hi in (
                _key_range(c0, min(c0 + bq, sq) - 1, sk, causal, w)
                for c0 in range(0, sq, bq)))
            assert r in (1, *K.SPLIT_RANKS)
            if r > 1:
                assert items < 132 and items * r <= 132
                assert tiles // r >= 2 and -(-tiles // r) >= 2
    assert seen[2] and seen[1]


# ---------------------------------------------------------------------------
# the wgmma kernels' shared-memory layout (csrc/flash_wgmma.cuh)
# ---------------------------------------------------------------------------

def _sw128(addr):
    """The 128-byte swizzle of a byte offset from a 1024-byte aligned base,
    as TMA writes it and wgmma reads it: the 16-byte unit within each
    128-byte row XOR the row's index within its 8-row atom."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma_tile(rows, d):
    """A rows x d bf16 tile as the kernels' TMA loads lay it out: ceil(D /
    64) column blocks of rows x 128 bytes (one 64-column box each),
    swizzled; {byte offset: (row, column)}, or 0 for a column past D, which
    TMA zero-fills (D 112: columns 112-127 of the second box)."""
    return {_sw128(c * rows * 128 + r * 128 + 2 * j):
            ((r, 64 * c + j) if 64 * c + j < d else 0)
            for c in range(-(-d // 64)) for r in range(rows)
            for j in range(64)}


def _col(row, col, d):
    """What a descriptor should read at (row, column) of a D-wide tile
    padded to whole boxes: the element, or the zero fill past D."""
    return (row, col) if col < d else 0


def _desc_k(rows, row0, ks):
    """``desc_k``: (start, sbo) of k-step ks of a K-major operand whose 64
    (or N) rows start at row0 of a rows-row tile."""
    return (ks >> 2) * rows * 128 + row0 * 128 + (ks & 3) * 32, 1024


def _desc_mn(rows, ks):
    """``desc_mn``: (start, lbo, sbo) of k-step ks of an MN-major operand
    over the 16 rows 16 ks .. 16 ks + 15 of a rows-row tile."""
    return ks * 16 * 128, rows * 128, 1024


def _read_k_major(mem, start, sbo, m):
    """The m x 16 operand a K-major, 128-byte swizzled descriptor points
    at: 8-row atoms sbo apart, each row 128 bytes, 16 columns of 2 bytes."""
    return [[mem[_sw128(start + (i // 8) * sbo + (i % 8) * 128 + 2 * kk)]
             for kk in range(16)] for i in range(m)]


def _read_mn_major(mem, start, lbo, sbo, n):
    """The 16 x n operand an MN-major, 128-byte swizzled descriptor points
    at: N along the rows, 64 per column block lbo apart; the 16 reduction
    rows in atoms of 8 rows of 128 bytes, sbo apart."""
    return [[mem[_sw128(start + (nn // 64) * lbo + 2 * (nn % 64)
                        + (kk // 8) * sbo + (kk % 8) * 128)]
             for nn in range(n)] for kk in range(16)]


@pytest.mark.parametrize("rows,d", [(64, 64), (64, 128), (128, 64),
                                    (128, 128), (64, 112), (128, 112),
                                    (128, 256), (64, 256), (32, 256)])
def test_wgmma_descriptors_read_what_tma_wrote(rows, d):
    """Every descriptor the kernels build reads the intended operand from a
    tile laid out by TMA with the 128-byte swizzle: the A operand (64 rows
    from row0 = 0 or 64, k-step ks over the padded D / 16) and a K-major B
    (all rows: K or a Q tile in S = Q K^T, K Q^T), and the MN-major B of
    P V, dS K, P^T dO and dS^T Q (16 rows per k-step, the padded D columns
    across the column blocks).  At D 112 the kernels run the D-128 layout:
    the last k-step of a K-major operand and the last 16 columns of an
    MN-major one read TMA's zero fill.  At D 256 (four boxes a row) the
    tiles are Q's 128 rows, the forward's 64-key and the dQ pass's 32-key
    K and V tiles, and the dK/dV pass's 64-row K, V, Q and dO tiles; a
    32-row tile is only ever a B operand."""
    dp = -(-d // 64) * 64
    mem = _tma_tile(rows, d)
    for ks in range(dp // 16):
        for row0 in range(0, rows - 63, 64):
            start, sbo = _desc_k(rows, row0, ks)
            assert _read_k_major(mem, start, sbo, 64) == [
                [_col(row0 + i, 16 * ks + kk, d) for kk in range(16)]
                for i in range(64)]
        start, sbo = _desc_k(rows, 0, ks)
        assert _read_k_major(mem, start, sbo, rows) == [
            [_col(i, 16 * ks + kk, d) for kk in range(16)]
            for i in range(rows)]
    for ks in range(rows // 16):
        start, lbo, sbo = _desc_mn(rows, ks)
        assert _read_mn_major(mem, start, lbo, sbo, dp) == [
            [_col(16 * ks + kk, nn, d) for nn in range(dp)]
            for kk in range(16)]


@pytest.mark.parametrize("dt", [64, 112, 128])
def test_wgmma_epilogues_store_the_true_columns(dt):
    """The wgmma kernels' stores of O, dQ, dK and dV: a warp's 32 threads
    write rows g and g + 8 (g = lane / 4) from the accumulator of the
    padded width, columns nt * 8 + 2 (lane % 4) and the next for nt < D / 8
    of the true D, at a row stride of the true D: every element of the
    warp's 16 rows once, none past D (at D 112 the accumulator's columns
    112-127 stay unstored), no address outside the rows."""
    dp = -(-dt // 64) * 64
    written = collections.Counter()
    for lane in range(32):
        g, t4 = lane >> 2, lane & 3
        for hh in range(2):
            row = g + 8 * hh
            for nt in range(dt // 8):
                for e in range(2):
                    acc = 4 * nt + 2 * hh + e
                    col = nt * 8 + 2 * t4 + e
                    assert acc < dp // 2
                    written[row * dt + col] += 1
    assert written == collections.Counter(range(16 * dt))


@pytest.mark.parametrize("g,s,kw", [
    (1, 200, dict(causal=True)), (2, 77, dict(causal=False, window=30)),
    (1, 130, dict(causal=True, logit_cap=20.0))])
def test_wgmma_walk_at_d112_pads_to_128(g, s, kw):
    """zamba2's head_dim 112 on the wgmma walk: Q, K, V and dO padded with
    zero columns to 128 (TMA's fill of the second 64-column box), the
    products over the padded width, the scale 1 / sqrt(112), and only the
    112 true columns stored (the emulation asserts the padded columns of
    every accumulator stay zero); O, the log-sum-exp, dq, dk and dv
    against the plain versions at D 112."""
    rng = np.random.default_rng(112 + g + s)
    b, hkv, d = 1, 2, 112
    q, d_o = (_bf16(torch.from_numpy(_rand(rng, b, s, hkv * g, d)))
              for _ in range(2))
    k, v = (_bf16(torch.from_numpy(_rand(rng, b, s, hkv, d)))
            for _ in range(2))
    window = kw.get("window", 2 ** 31 - 1)
    o, lse = emulate_fwd(q, k, v, causal=kw["causal"], window=window,
                         cap=kw.get("logit_cap"), walk=WGMMA)
    grads = emulate_bwd(q, k, v, o, lse, d_o, causal=kw["causal"],
                        window=window, cap=kw.get("logit_cap"), walk=WGMMA)
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    want_o = ref.attention_ref(*tr[:3], **kw).transpose(1, 2)
    want_g = [t.transpose(1, 2) for t in ref.attention_ref_grad(*tr, **kw)]
    for got, want in zip((o, *grads), (want_o, *want_g)):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 2e-2 * max(
            1.0, float(want.abs().max()))


def test_fast_tanh_of_the_d256_kernels_is_tanh():
    """``score_log2_fast``'s tanh, 1 - 2 / (1 + e^(2y)), in float32 over
    the capped scores' whole range: within 1e-6 of tanh (to the rounding
    of 1 - 1 near 0), and its slope 1 - t^2 within 1e-6 too."""
    y = torch.linspace(-30, 30, 600001, dtype=torch.float32)
    t = _fast_tanh(y)
    want = torch.tanh(y.double())
    assert float((t.double() - want).abs().max()) <= 1e-6
    assert float(((1 - t * t).double() - (1 - want * want)).abs().max()) \
        <= 1e-6


@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
def test_wgmma256_staged_epilogue_stores_each_element_once(elem):
    """The D-256 kernels' staged epilogue (``stage_piece`` and
    ``copy_piece`` of ``csrc/flash_wgmma.cuh``) for an f32 O or dQ (32
    columns a piece) and a bf16 one (64): every element of a warpgroup's
    64 x 256 accumulator leaves exactly where it was, each warp's fragment
    stores (one n-tile and row half per instruction: 32 lanes x 2 values)
    and row copies (32 lanes x 16 bytes) touch each of the 32 banks no
    more often than their bytes require, and every 8 threads write 128
    contiguous bytes of one output row."""
    acc = torch.arange(64 * 256, dtype=torch.float32).reshape(64, 256)
    assert torch.equal(_staged_rows(acc, elem), acc)
    offs = _piece_units(64, elem)
    cols = 128 // elem
    for warp in range(4):
        for j in range(cols // 8):
            for hh in range(2):
                words = collections.Counter()
                for lane in range(32):
                    g, t4 = lane >> 2, lane & 3
                    r, c = warp * 16 + g + 8 * hh, j * 8 + 2 * t4
                    for e in range(2):
                        words[int(offs[r, c + e]) // 4] += 1
                per_bank = collections.Counter(w % 32 for w in words)
                assert max(per_bank.values()) == len(words) // 32
    for warp in range(4):
        for i in range(4):
            banks = collections.Counter()
            for lane in range(32):
                t = 32 * warp + lane
                r, u = t // 8 + 16 * i, t % 8
                start = r * 128 + (u ^ (r % 8)) * 16
                for w in range(4):
                    banks[(start // 4 + w) % 32] += 1
            assert max(banks.values()) == 4   # 512 bytes: 4 wavefronts


def test_wgmma256_p_tile_mirrors_the_registers():
    """``dkv256_kernel``'s hand-over of P^T cg from warpgroup 0 to 1: the
    two groups' m64n64 accumulators (S^T and dP^T) share one layout, so
    the 16 KB tile mirrors the registers: warpgroup 1 reads each (key,
    query) back at its own thread and register, every float once, and a
    warp's float4 stores cover 512 contiguous bytes (no bank conflict)."""
    pc = torch.randn(64, 64)
    assert torch.equal(_p_handover(pc), pc)
    tid, reg = _fragment(64, 64)
    for t in range(128):
        assert (tid == t).sum() == 32
        assert sorted(reg[tid == t].tolist()) == list(range(32))
    for warp in range(4):
        for i4 in range(8):
            start = [((i4 * 128 + 32 * warp + lane) * 16)
                     for lane in range(32)]
            assert start == list(range(start[0], start[0] + 512, 16))


@pytest.mark.parametrize("g,s,kw,k_off", [
    (1, 200, dict(causal=True), None),
    (2, 77, dict(causal=False, window=30), None),
    (8, 70, dict(causal=True, logit_cap=50.0), None),
    (2, 150, dict(causal=True, logit_cap=50.0), None),   # gemma2-2b's G, cap
    (2, 130, dict(causal=True, logit_cap=50.0), 60),
    (1, 96, dict(causal=True, window=40), 33)])
def test_wgmma_walk_at_d256(g, s, kw, k_off):
    """gemma2-2b's head_dim 256 on the D-256 kernels' walk at its true
    width: four 64-column boxes a row, 64-key forward tiles, the dQ pass's
    32-key tiles, 64-key dK/dV blocks whose two warpgroups split the
    products (P^T cg through the shared tile), O and dQ through the staged
    epilogue, the persistent order of 3 CTAs; O, the log-sum-exp, dq, dk
    and dv against the plain versions, and with ``k_off`` one key block
    (the keys from k_off on) against ``ref.attention_block_ref`` and its
    gradient at the whole sequence's O and log-sum-exp."""
    rng = np.random.default_rng(256 + g + s)
    b, hkv, d = 1, 2, 256
    q, d_o = (_bf16(torch.from_numpy(_rand(rng, b, s, hkv * g, d)))
              for _ in range(2))
    k, v = (_bf16(torch.from_numpy(_rand(rng, b, s, hkv, d)))
            for _ in range(2))
    window = kw.get("window", 2 ** 31 - 1)
    cap = kw.get("logit_cap")
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    if k_off is None:
        visited = []
        o, lse = emulate_fwd(q, k, v, causal=kw["causal"], window=window,
                             cap=cap, walk=WGMMA256, visited=visited)
        grads = emulate_bwd(q, k, v, o, lse, d_o, causal=kw["causal"],
                            window=window, cap=cap, walk=WGMMA256,
                            visited=visited)
        assert len(set(visited)) == len(visited) == (
            2 * -(-s // (128 // g)) + -(-s // 64)) * hkv * b
        want = [ref.attention_ref(*tr[:3], **kw).transpose(1, 2)]
        want += [t.transpose(1, 2) for t in ref.attention_ref_grad(*tr,
                                                                   **kw)]
    else:
        o_all, lse_all = emulate_fwd(q, k, v, causal=kw["causal"],
                                     window=window, cap=cap, walk=WGMMA256)
        kb, vb = k[:, k_off:], v[:, k_off:]
        o, lse = emulate_fwd(q, kb, vb, causal=kw["causal"], window=window,
                             cap=cap, walk=WGMMA256, k_off=k_off)
        w_o, w_lse = ref.attention_block_ref(q, kb, vb, k_off=k_off, **kw)
        assert torch.equal(torch.isinf(lse), torch.isinf(w_lse))
        live = torch.isfinite(w_lse)
        assert float((lse[live] - w_lse[live]).abs().max()) <= 1e-4
        grads = emulate_bwd(q, kb, vb, o_all, lse_all, d_o,
                            causal=kw["causal"], window=window, cap=cap,
                            walk=WGMMA256, k_off=k_off)
        want = [w_o] + list(ref.attention_block_ref_grad(
            q, kb, vb, o_all, lse_all, d_o, k_off=k_off, **kw))
    for got, w in zip((o, *grads), want):
        assert got.shape == w.shape
        assert float((got - w).abs().max()) <= 2e-2 * max(
            1.0, float(w.abs().max()))


@pytest.mark.parametrize("s,g,causal", [(4096, 2, True), (300, 8, False),
                                        (1000, 1, True)])
def test_persistent_walk_at_d256_takes_the_longest_items_first(s, g,
                                                                causal):
    """The D-256 kernels' persistent grid (132 CTAs; gemma2-2b's Hkv 4 at
    B 2): the forward and dQ pass over query blocks of 128 / G positions,
    the dK/dV pass over 64-key blocks (twice D 128's count); each item
    taken once and every CTA's items longest first, by the keys a query
    block sees or the queries a key block sees."""
    walk = Walk(rows=128, tk=64, keys=64, tq=64, mma=True,
                position_major=True, tk_dq=32, sms=132, box=64, split=True,
                staged=True)
    b, hkv = 2, 4
    bq = walk.rows // g
    window = 2 ** 31 - 1

    def key_len(blk):
        c0 = blk * bq
        lo, hi = _key_range(c0, min(c0 + bq, s) - 1, s, causal, window)
        return hi - lo

    def query_len(blk):
        k0 = blk * walk.keys
        return s - (k0 if causal else 0)

    for n_blk, length, descending in ((-(-s // bq), key_len, causal),
                                      (-(-s // walk.keys), query_len,
                                       not causal)):
        items = list(_items(n_blk, hkv, b, walk, descending))
        assert sorted(items) == sorted(
            (blk, h, bi) for blk in range(n_blk) for h in range(hkv)
            for bi in range(b))
        for mine in _cta_items(len(items), walk.sms):
            lens = [length(_item(it, n_blk, hkv, b, descending)[0])
                    for it in mine]
            assert lens == sorted(lens, reverse=True)


def test_flash_bench_ablations_still_apply():
    """``launch.flash_bench --ablate`` builds the flash libraries with one
    of ``csrc/flash_wgmma.cuh``'s ablation macros defined, or of
    ``csrc/flash_tf32.cuh``'s (the float32 family): each macro is still
    tested by its header (a renamed one would build an unablated copy),
    and no macro of either header's is left untimed."""
    import re

    from repro_torch.kernels import build
    from repro_torch.launch import flash_bench

    for name, ablations in (("flash_wgmma.cuh", flash_bench.ABLATIONS),
                            ("flash_tf32.cuh", flash_bench.TF32_ABLATIONS)):
        header = (build.CSRC / name).read_text()
        tested = set(re.findall(r"^#ifn?def (FLASH_ABLATE_\w+)", header,
                                re.M))
        assert tested == set(ablations.values()), name


def test_flash_bench_reports_balance_and_needs_a_card(monkeypatch, capsys):
    """``launch.flash_bench`` prints the persistent grid's balance (no card
    needed): its CTA loads agree with ``_cta_items``, the snake order is
    within 0.5% of even at the training shape where a stride of the grid
    leaves a CTA 12.5% or more above the mean; without a card it exits 2
    before building anything."""
    from repro_torch.launch import flash_bench

    lengths = [7, 7, 6, 5, 5, 3, 2, 2, 1]
    loads = flash_bench.cta_loads(lengths, 4, snake=True)
    assert loads == [sum(lengths[i] for i in mine)
                     for mine in _cta_items(len(lengths), 4)]
    ratios = flash_bench.balance()
    for name in ("fwd", "dq", "dkv"):
        assert ratios[name]["snake"] <= 1.005
        assert ratios[name]["stride"] >= 1.125
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert flash_bench.main([]) == 2
    assert capsys.readouterr().out.count("[balance]") == 3


def test_autograd_function_joins_the_two_wrappers(monkeypatch):
    """``FlashAttention`` on the CPU, with the forward kernel replaced by
    its emulation: the forward saves what the backward wrapper needs, and
    the gradient reaches q, k and v in their layouts."""
    rng = np.random.default_rng(5)
    q, k, v, d_o = (torch.from_numpy(_rand(rng, 2, 40, h, 16))
                    for h in (4, 2, 2, 4))
    calls = []

    def fwd(q, k, v, *, causal, window, logit_cap):
        calls.append((causal, window, logit_cap))
        return emulate_fwd(q, k, v, causal=causal, window=window or 2 ** 31,
                           cap=logit_cap, walk=CUDA_CORES)

    monkeypatch.setattr(K, "_flash_fwd", fwd)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = K.FlashAttention.apply(*leaves, True, 9, 5.0)
    got = torch.autograd.grad(o, leaves, d_o)
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    want = [t.transpose(1, 2) for t in ref.attention_ref_grad(
        *tr, causal=True, window=9, logit_cap=5.0)]
    assert calls == [(True, 9, 5.0)]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 2e-5


# ---------------------------------------------------------------------------
# the float32 family (csrc/flash_tf32.cuh): three TF32 products on wgmma
# ---------------------------------------------------------------------------

FLASH_TOL_F32 = 1e-4   # chip_smoke.FLASH_TOL[torch.float32]


def _split_t(x, s_pad):
    """``split_t_kernel``'s layout without the split: x (B, S, H, D) ->
    (B, H, D, s_pad), column c of each 8 holding position 8 (c // 8) +
    2 (c % 4) + (c % 8) // 4, zero past S."""
    b, s, h, d = x.shape
    xt = torch.zeros(b, h, d, s_pad, dtype=x.dtype)
    xt[..., :s] = x.permute(0, 2, 3, 1)
    return xt[..., _perm8(s_pad)]


@pytest.mark.parametrize("d,tk", [(128, 32), (64, 64)])
def test_tf32x3_output_operand_meets_the_accumulator(d, tk):
    """The output product's operands as the card holds them: W, a 64 x TK
    f32 accumulator in its fragment registers (``_fragment``), taken as
    ``out_product`` takes it (registers 4 ks + 0, 2, 1, 3 into TF32 A
    slots a0 (g, t4), a1 (g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4)
    of its warp's 16 rows), against C^T as the pre-pass writes it (the
    positions permuted within each 8, zero past S = 70) and TMA lays a
    32-position box of it into shared memory (D rows x 128 bytes,
    swizzled), read as wgmma reads a K-major TF32 B operand through
    ``desc_k(tile, D, 0, ks)``: the sum over the slots is W C for the
    tile at t0 = 40, exactly (float64)."""
    rng = np.random.default_rng(d + tk)
    s, t0 = 70, 40
    c_all = torch.from_numpy(rng.standard_normal((1, s, 1, d)))
    w = torch.from_numpy(rng.standard_normal((64, tk)))
    w[:, s - t0:] = 0.0     # columns past S are masked: weight 0
    ct = _split_t(c_all, -(-s // 8) * 8)[0, 0]              # (D, S_pad)
    # TMA: boxes of 32 positions x D rows, 128-byte swizzle (4-byte units)
    mem = {}
    for j2 in range(tk // 32):
        for n in range(d):
            for j in range(32):
                pos = t0 + 32 * j2 + j
                mem[_sw128(j2 * d * 128 + n * 128 + 4 * j)] = (
                    ct[n, pos] if pos < ct.shape[1] else 0.0)   # TMA fill
    tid, reg = _fragment(64, tk)
    regs = torch.zeros(128, tk // 2, dtype=torch.float64)
    regs[tid.flatten(), reg.flatten()] = w.flatten()
    got = torch.zeros(64, d, dtype=torch.float64)
    for ks in range(tk // 8):
        start, sbo = _desc_k(d, 0, ks)
        b = [[mem[_sw128(start + (n // 8) * sbo + (n % 8) * 128 + 4 * kk)]
              for n in range(d)] for kk in range(8)]              # (k8, N)
        for t in range(128):
            wp, g, t4 = t // 32, (t % 32) // 4, t % 4
            a = [regs[t, 4 * ks + i] for i in (0, 2, 1, 3)]
            for (row, kk), x in zip(((g, t4), (g + 8, t4), (g, t4 + 4),
                                     (g + 8, t4 + 4)), a):
                got[16 * wp + row] += x * torch.tensor(b[kk],
                                                       dtype=torch.float64)
    tile = torch.zeros(tk, d, dtype=torch.float64)
    tile[:s - t0] = c_all[0, t0:, 0]
    assert torch.allclose(got, w @ tile, rtol=0, atol=1e-12)


def test_tf32_fast_split_rounds_hi_and_keeps_x():
    """``split_tf32_fast`` (the float32 family's A fragments, split with
    no conversion instruction): hi is ``cvt.rna``'s TF32 (``tf32_round``),
    lo = x - hi with the low 13 bits wgmma ignores dropped, and hi + lo is
    x within 2^-21 |x| over normal floats of every exponent."""
    rng = np.random.default_rng(3)
    v = (rng.standard_normal(1 << 18)
         * 2.0 ** rng.integers(-60, 60, 1 << 18)).astype(np.float32)
    x = torch.from_numpy(v)
    hi, lo = tf32_split_fast(x)
    assert torch.equal(hi, tf32_round(x))
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())


def test_tf32_raw_split_truncates_hi_and_keeps_x():
    """``lo_of_raw`` (the score products' B operands, whose hi part is
    the f32 tensor itself): hi is x with the low 13 bits that wgmma
    ignores cleared, lo the rest rounded to TF32, and hi + lo is x within
    2^-21 |x| over normal floats of every exponent."""
    rng = np.random.default_rng(4)
    v = (rng.standard_normal(1 << 18)
         * 2.0 ** rng.integers(-60, 60, 1 << 18)).astype(np.float32)
    x = torch.from_numpy(v)
    hi, lo = tf32_split_raw(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert bool((hi.abs() <= x.abs()).all())
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())


def test_one_tf32_pass_fails_flash_tol_and_three_pass():
    """At B 1, Hq 2, Hkv 1, S 512, D 128, causal, on normal operands,
    against the plain versions: the float32 walk with one TF32 product a
    product (A_hi B_hi alone) errs past FLASH_TOL[float32] in O (over
    max(1, max |plain|)) and in each of dQ, dK, dV (over its own max);
    with three (``TF32X3``) every error stays within it by a factor of 10
    (the card: ``chip_smoke.py``'s rows 5f and 5bf)."""
    rng = np.random.default_rng(5)
    b, hq, hkv, s, d = 1, 2, 1, 512, 128
    q, d_o = (torch.from_numpy(_rand(rng, b, s, hq, d)) for _ in range(2))
    k, v = (torch.from_numpy(_rand(rng, b, s, hkv, d)) for _ in range(2))
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    want_o = ref.attention_ref(*tr[:3], causal=True).transpose(1, 2)
    want_g = [t.transpose(1, 2)
              for t in ref.attention_ref_grad(*tr, causal=True)]
    errs = {}
    for passes in (1, 3):
        walk = Walk(rows=128, tk=32, keys=128, tq=32, mma=False,
                    position_major=True, sms=3, tf32x3=True)
        walk.passes = passes
        o, lse = emulate_fwd(q, k, v, causal=True, window=2 ** 31 - 1,
                             cap=None, walk=walk)
        grads = emulate_bwd(q, k, v, o, lse, d_o, causal=True,
                            window=2 ** 31 - 1, cap=None, walk=walk)
        errs[passes] = [float((o - want_o).abs().max())
                        / max(1.0, float(want_o.abs().max()))] + [
            float((g - w).abs().max()) / float(w.abs().max())
            for g, w in zip(grads, want_g)]
    assert min(errs[1]) > FLASH_TOL_F32 > 10 * max(errs[3]), errs


def test_tf32x3_walk_matches_pallas_and_jax_grad():
    """The float32 family's walk (``TF32X3``, three TF32 products) at a
    small GQA shape with the causal mask, a window and a softcap: O
    against ``repro``'s ``flash_attention_pallas(interpret=True)`` within
    2e-5 (as the plain version is held there), dq, dk and dv against
    ``jax.vjp`` of ``repro``'s chunked ``layers.attention`` within 2e-5
    (the walk's products drop A_lo B_lo, 2^-22 of each term)."""
    rng = np.random.default_rng(17)
    b, hq, hkv, s, d = 1, 4, 2, 96, 32
    kw = dict(causal=True, window=40, logit_cap=20.0)
    q, d_o = (_rand(rng, b, s, hq, d) for _ in range(2))
    k, v = (_rand(rng, b, s, hkv, d) for _ in range(2))
    o, lse = emulate_fwd(*map(torch.from_numpy, (q, k, v)),
                         causal=True, window=40, cap=20.0, walk=TF32X3)
    pallas = flash_attention_pallas(*(x.transpose(0, 2, 1, 3)
                                      for x in (q, k, v)),
                                    bq=32, bk=32, interpret=True, **kw)
    np.testing.assert_allclose(o.numpy(),
                               np.asarray(pallas).transpose(0, 2, 1, 3),
                               atol=2e-5, rtol=0)
    grads = emulate_bwd(*map(torch.from_numpy, (q, k, v)), o, lse,
                        torch.from_numpy(d_o), causal=True, window=40,
                        cap=20.0, walk=TF32X3)

    def f(q, k, v):
        return JL.attention(q, k, v, q_positions=jnp.arange(s),
                            k_positions=jnp.arange(s), q_chunk=32, **kw)

    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    for got, want in zip(grads, vjp(jnp.asarray(d_o))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=0)
