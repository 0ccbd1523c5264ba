"""The port's paged attention against ``repro``'s, on the same inputs.

On the CPU the port's ops take their plain version: it is held against
``repro``'s jnp gather path, its Pallas kernel in interpret mode and the
dense ``ref`` oracles, on the geometries of ``tests/test_serve.py``
(prime pools, windows, softcaps, multi-page chunks, start > 0, stale
pages).  A Python emulation of the CUDA kernels' walk (key splits, warp
batches and tiles, finite -1e30 masking, online softmax, merges) is held
against the
plain version, so the kernels' algorithm is tested here too.  The CUDA
kernels themselves run only on a card (``test_torch_cuda.py``).

The MLA latent pair (``paged_latent_decode_attention`` and
``paged_latent_prefill_attention``) gets the same treatment: plain version
against ``repro``'s jnp path, Pallas interpret and dense oracles, and an
emulation of the CUDA kernels' shared walk (``csrc/
paged_latent_common.cuh``: 16-row blocks, key splits, 32-key tiles, weight
0 for masked keys, merge) against the plain version.

Tolerance: float32 atol 1e-5 (different summation orders).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import (paged_attention_ref,
                                     paged_decode_attention,
                                     paged_latent_decode_pallas,
                                     paged_latent_attention_ref,
                                     paged_latent_decode_attention,
                                     paged_latent_prefill_attention,
                                     paged_latent_prefill_pallas,
                                     paged_latent_prefill_ref,
                                     paged_prefill_attention,
                                     paged_prefill_ref)
from repro_torch.kernels.attention import attention as K
from repro_torch.kernels.attention import ops, ref

# Small tensors: one intra-op thread each, so these tests do not crowd the
# other workers of a parallel run.
torch.set_num_threads(1)
ATOL = 1e-5
INT32_MAX = 2 ** 31 - 1
DECODE_KW = [{}, {"window": 6}, {"logit_cap": 20.0},
             {"window": 3, "logit_cap": 5.0}]
PREFILL_KW = [{}, {"window": 5}, {"logit_cap": 20.0},
              {"window": 3, "logit_cap": 5.0}]
PRIME_GEOMETRIES = [(3, 3, 11, 3, 3), (5, 2, 7, 5, 5), (2, 4, 13, 6, 0)]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


def _decode_case(seed=0):
    rng = np.random.default_rng(seed)
    b, hq, hkv, d, page, n_pages = 3, 4, 2, 16, 4, 13
    q = _rand(rng, b, 1, hq, d)
    kp = _rand(rng, n_pages, page, hkv, d)
    vp = _rand(rng, n_pages, page, hkv, d)
    bt = np.array([[0, 3, 5, 7], [1, 2, 4, 6], [8, 9, 10, 11]], np.int32)
    lens = np.array([5, 16, 1], np.int32)
    return q, kp, vp, bt, lens


def _prefill_case(page=4, pps=4, n_pages=13, c=8, start=8, hq=4, hkv=2,
                  d=16, seed=1):
    rng = np.random.default_rng(seed)
    row = rng.choice(n_pages, size=pps, replace=False).astype(np.int32)
    return (_rand(rng, 1, c, hq, d), _rand(rng, n_pages, page, hkv, d),
            _rand(rng, n_pages, page, hkv, d), row, start)


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("kw", DECODE_KW)
def test_plain_decode_matches_jax(kw):
    q, kp, vp, bt, lens = _decode_case()
    got = ops.paged_decode_attention(*_t(q, kp, vp, bt, lens), **kw)
    jq = [jnp.asarray(x) for x in (q, kp, vp, bt, lens)]
    _close(got, paged_decode_attention(*jq, **kw))
    _close(got, paged_decode_attention(*jq, use_kernel=True,
                                       interpret=True, **kw))
    _close(got, paged_attention_ref(*jq, **kw))
    _close(ref.paged_attention_ref(*_t(q, kp, vp, bt, lens), **kw),
           paged_attention_ref(*jq, **kw))


@pytest.mark.parametrize("kw", PREFILL_KW)
def test_plain_prefill_matches_jax(kw):
    """A chunk at start 8: past context in earlier pages, stale data in
    later ones, masked by the global causal rule."""
    q, kp, vp, _, _ = _prefill_case()
    row = np.array([2, 5, 7, 11], np.int32)
    got = ops.paged_prefill_attention(*_t(q, kp, vp, row), 8, **kw)
    jq = [jnp.asarray(x) for x in (q, kp, vp, row)]
    st = jnp.asarray(8, jnp.int32)
    _close(got, paged_prefill_attention(*jq, st, **kw))
    _close(got, paged_prefill_attention(*jq, st, use_kernel=True,
                                        interpret=True, **kw))
    _close(got, paged_prefill_ref(*jq, st, **kw))
    _close(ref.paged_prefill_ref(*_t(q, kp, vp, row), 8, **kw),
           paged_prefill_ref(*jq, st, **kw))


@pytest.mark.parametrize("page,pps,n_pages,c,start", PRIME_GEOMETRIES)
def test_plain_prefill_prime_geometries_match_jax(page, pps, n_pages, c,
                                                  start):
    """Prime pages and pools, single- and multi-page chunks, first and
    last chunk positions."""
    q, kp, vp, row, start = _prefill_case(page, pps, n_pages, c, start,
                                          d=8, seed=page)
    got = ops.paged_prefill_attention(*_t(q, kp, vp, row), start)
    jq = [jnp.asarray(x) for x in (q, kp, vp, row)]
    st = jnp.asarray(start, jnp.int32)
    _close(got, paged_prefill_attention(*jq, st))
    _close(got, paged_prefill_attention(*jq, st, use_kernel=True,
                                        interpret=True))
    _close(got, paged_prefill_ref(*jq, st))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    K.paged_flash_decode.launches = 0
    K.paged_flash_prefill.launches = 0
    q, kp, vp, bt, lens = _t(*_decode_case())
    scale = 1 / math.sqrt(q.shape[-1])
    want = ops.paged_decode_attention(q, kp, vp, bt, lens, use_kernel=False)
    for got in (ops.paged_decode_attention(q, kp, vp, bt, lens),
                ops.paged_decode_attention(q, kp, vp, bt, lens,
                                           use_kernel=True),
                K.paged_flash_decode(q, kp, vp, bt, lens, scale=scale)):
        assert torch.equal(got, want)
    q, kp, vp, row, start = _prefill_case()
    q, kp, vp, row = _t(q, kp, vp, row)
    want = ops.paged_prefill_attention(q, kp, vp, row, start,
                                       use_kernel=False)
    for got in (ops.paged_prefill_attention(q, kp, vp, row, start),
                K.paged_flash_prefill(q, kp, vp, row, start, scale=scale)):
        assert torch.equal(got, want)
    assert K.paged_flash_decode.launches == 0
    assert K.paged_flash_prefill.launches == 0


# ---------------------------------------------------------------------------
# the CUDA kernels' walk, emulated (csrc/paged_decode.cu, paged_prefill.cu)
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def _online(states, sc, v, p_bf16=False):
    """One tile of the online softmax: states (m, l, acc) per row; with
    ``p_bf16`` the weights are rounded to bf16 for the value product (the
    sums stay f32)."""
    m, l, acc = states
    m_new = torch.maximum(m, sc.max(-1).values)
    p = torch.exp(sc - m_new[:, None])
    alpha = torch.exp(m - m_new)
    pv = (p.bfloat16().float() if p_bf16 else p) @ v
    return m_new, l * alpha + p.sum(-1), acc * alpha[:, None] + pv


def _combine(parts):
    """Online-softmax states (m, l, acc) merged in the order given, still
    unnormalized."""
    m = torch.stack([p[0] for p in parts]).max(0).values
    w = [torch.exp(p[0] - m) for p in parts]
    l = sum(p[1] * wi for p, wi in zip(parts, w))
    acc = sum(p[2] * wi[:, None] for p, wi in zip(parts, w))
    return m, l, acc


def _merge(parts):
    _, l, acc = _combine(parts)
    return acc / torch.clamp(l, min=1e-30)[:, None]


def _softcap(sc, cap):
    return sc if cap is None else torch.tanh(sc / cap) * cap


def emulate_decode(q, kp, vp, bt, lens, *, window=None, logit_cap=None,
                   ranks=8, warps=4, stage_bytes=48 * (256 + 16)):
    """csrc/paged_decode.cu: one cluster of ``ranks`` CTAs per (slot, kv
    head).  Rank r takes keys [lo + r * share, lo + (r + 1) * share) of the
    slot's n live keys [lo, hi), share = ceil(n / ranks), so a rank past
    the range holds none; its keys pass through shared memory in stages of
    ``stage_bytes`` of K (rows padded by 16 bytes; on tensor cores a
    multiple of 16 keys), warp w taking steps w, w + warps, ... of each
    stage (16 keys on tensor cores: bf16 at D 64, 128 or 256, weights
    rounded to bf16 for the value product; else 8 keys, weights f32) with
    its own online softmax; the warps' states merge in warp order, then
    rank 0 merges the ranks that hold keys in rank order.  A slot with no
    valid key (length 0, or a window wholly past its table) walks its whole
    row with every score 0: the uniform mean of its values."""
    b, _, hq, d = q.shape
    _, page, hkv, _ = kp.shape
    g, width = hq // hkv, bt.shape[1]
    window = INT32_MAX if window is None else window
    scale = 1 / math.sqrt(d)
    mma = q.dtype == torch.bfloat16 and d in (64, 128, 256)
    batch = 16 if mma else 8
    stage_keys = stage_bytes // (d * q.element_size() + 16)
    if mma:
        stage_keys -= stage_keys % 16
    qf, kf, vf = q.float(), kp.float(), vp.float()
    out = torch.zeros(q.shape)
    for bi in range(b):
        length = int(lens[bi])
        lo, hi = max(0, length - window), min(length, width * page)
        uniform = hi <= lo
        if uniform:
            lo, hi = 0, width * page
        n = hi - lo
        share = -(-n // ranks)
        live = -(-n // share) if share else 1
        for h in range(hkv):
            qh = qf[bi, 0, h * g:(h + 1) * g]
            rank_states = []
            for r in range(live):
                r_lo = lo + r * share
                r_hi = min(hi, r_lo + share)
                warp_states = []
                for w in range(warps):
                    st = (torch.full((g,), NEG_INF), torch.zeros(g),
                          torch.zeros(g, d))
                    for s0 in range(r_lo, r_hi, stage_keys):
                        nk = min(stage_keys, r_hi - s0)
                        for j0 in range(w * batch, nk, warps * batch):
                            pos = torch.arange(s0 + j0,
                                               s0 + min(j0 + batch, nk))
                            phys = bt[bi, pos // page].long()
                            kt = kf[phys, pos % page, h]
                            vt = vf[phys, pos % page, h]
                            sc = _softcap(qh @ kt.T * scale, logit_cap)
                            if uniform:
                                sc = torch.zeros_like(sc)
                            st = _online(st, sc, vt, mma)
                    warp_states.append(st)
                rank_states.append(_combine(warp_states))
            out[bi, 0, h * g:(h + 1) * g] = _merge(rank_states)
    return out.to(q.dtype)


def emulate_prefill(q, kp, vp, row, start, *, window=None, logit_cap=None,
                    rows_per_cta=32, tile=32, split=128):
    _, c, hq, d = q.shape
    _, page, hkv, _ = kp.shape
    g, width = hq // hkv, row.shape[0]
    window = INT32_MAX if window is None else window
    scale = 1 / math.sqrt(d)
    bq = rows_per_cta // g
    out = torch.zeros_like(q)
    for c0 in range(0, c, bq):
        ci = torch.arange(c0, min(c0 + bq, c))
        q_pos = start + ci
        k_lo0 = max(0, int(q_pos[0]) - window + 1)
        k_hi0 = min(int(q_pos[-1]) + 1, width * page)
        for h in range(hkv):
            qr = q[0, ci][:, h * g:(h + 1) * g].transpose(0, 1)  # (G, n, D)
            qr = qr.reshape(-1, d)
            qp = q_pos.repeat(g)
            parts = []
            for s in range(-(-width * page // split)):
                n_rows = qr.shape[0]
                st = (torch.full((n_rows,), NEG_INF), torch.zeros(n_rows),
                      torch.zeros(n_rows, d))
                k_lo, k_hi = max(k_lo0, s * split), min(k_hi0,
                                                        (s + 1) * split)
                for t0 in range(k_lo, k_hi, tile):
                    pos = torch.arange(t0, min(t0 + tile, k_hi))
                    phys = row[pos // page].long()
                    kt, vt = kp[phys, pos % page, h], vp[phys, pos % page, h]
                    sc = _softcap(qr @ kt.T * scale, logit_cap)
                    valid = ((pos[None, :] <= qp[:, None])
                             & (qp[:, None] - pos[None, :] < window))
                    st = _online(st, torch.where(valid, sc, NEG_INF), vt)
                parts.append(st)
            o = _merge(parts).reshape(g, len(ci), d).transpose(0, 1)
            out[0, ci, h * g:(h + 1) * g] = o
    return out


def _decode_walk_case(geom):
    """(q, k pool, v pool, tables, lengths) as numpy: the serving tests'
    prime pool (G 2, D 16); 64-position pages whose 512-position tables
    spread a slot over all eight ranks (one slot past its table); G 1 at
    D 64 and G 8 at D 256 (gemma2's decode) with a zero-length slot."""
    if geom == "prime":
        return _decode_case()
    rng = np.random.default_rng(7)
    b, hq, hkv, d, page, n_pages, lens = {
        "ranks": (3, 4, 2, 16, 64, 25, [300, 511, 515]),
        "g1_d64": (3, 2, 2, 64, 16, 29, [0, 77, 128]),
        "g8_d256": (3, 16, 2, 256, 16, 29, [0, 77, 128])}[geom]
    width = 8
    bt = rng.permutation(n_pages - 1)[:b * width].reshape(b, width)
    return (_rand(rng, b, 1, hq, d), _rand(rng, n_pages, page, hkv, d),
            _rand(rng, n_pages, page, hkv, d), bt.astype(np.int32),
            np.array(lens, np.int32))


@pytest.mark.parametrize("kw", DECODE_KW + [{"window": 100}])
@pytest.mark.parametrize("geom", ["prime", "ranks", "g1_d64", "g8_d256"])
def test_decode_kernel_walk_matches_plain(kw, geom):
    """The one-launch cluster walk (length-sized rank shares, empty ranks,
    shared-memory stages, warp batches, the warp and rank-order merges)
    against the plain version, on windows and softcaps (f32 atol 1e-5), and
    against repro's Pallas kernel in interpret mode without a window or
    softcap and with both.  A slot with no valid key (length 0, or a
    window wholly past its table) gets the uniform mean of its row's
    values, as the plain version and the Pallas kernel give it."""
    case = _decode_walk_case(geom)
    q, kp, vp, bt, lens = _t(*case)
    got = emulate_decode(q, kp, vp, bt, lens, **kw)
    window = kw.get("window", INT32_MAX)
    page, width = kp.shape[1], bt.shape[1]
    live = (torch.clamp(lens, max=width * page)
            - torch.clamp(lens - window, min=0)) > 0
    if geom.startswith("g"):   # the zero-length slot
        assert not live[0]
    _close(got, ops.paged_decode_attention(q, kp, vp, bt, lens, **kw))
    if kw in (DECODE_KW[0], DECODE_KW[3]):
        jq = [jnp.asarray(x) for x in case]
        want = paged_decode_attention(*jq, use_kernel=True, interpret=True,
                                      **kw)
        _close(got, want)


def test_decode_walk_in_bf16_stages_twice_the_keys():
    """bf16 rows are half as wide, so a stage holds twice the keys, and at
    D 256 the tensor-core walk takes 16-key steps: the walk on bf16 inputs
    against the plain version (bf16 tolerance 2e-2: the walk rounds the
    unnormalized weights to bf16, the plain version the normalized ones)."""
    q, kp, vp, bt, lens = (torch.from_numpy(x) for x in
                           _decode_walk_case("g8_d256"))
    q, kp, vp = (x.bfloat16() for x in (q, kp, vp))
    got = emulate_decode(q, kp, vp, bt, lens, logit_cap=30.0)
    want = ops.paged_decode_attention(q, kp, vp, bt, lens, logit_cap=30.0)
    assert int(lens[0]) == 0   # the zero-length slot: its row's mean
    _close(got.float(), want.float(), 2e-2)


@pytest.mark.parametrize("kw", PREFILL_KW)
@pytest.mark.parametrize("hq,hkv", [(4, 2), (6, 2), (3, 3)])
def test_prefill_kernel_walk_matches_plain(kw, hq, hkv):
    """A late chunk over two key splits; G = 2, 3 and 1; windows whose
    first tile is wholly masked for some rows (the finite -1e30 wipe)."""
    q, kp, vp, row, start = _prefill_case(page=16, pps=16, n_pages=20, c=24,
                                          start=200, hq=hq, hkv=hkv, seed=3)
    q, kp, vp, row = _t(q, kp, vp, row)
    _close(emulate_prefill(q, kp, vp, row, start, **kw),
           ops.paged_prefill_attention(q, kp, vp, row, start, **kw))


LN2, LOG2E = math.log(2.0), 1.0 / math.log(2.0)


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def emulate_prefill_tc(q, kp, vp, row, start, *, window=None, logit_cap=None,
                       rows_per_cta=128, warp_rows=16, tile=64, split=128,
                       n_split=None):
    """csrc/paged_prefill.cu's tensor-core body (bf16): per (q block, kv
    head, key split) CTA, 128 rows position-major (row r: head r % G at
    chunk position c0 + r / G), eight warps of 16 rows in fragment order;
    per 64-key tile S = Q K^T in f32 from bf16 operands, the softmax in the
    log2 domain (a tile whose pairs the warp's position range shows all
    visible skips the mask; a masked key weighs 0), row sums of the f32
    weights, P V from the weights rounded to bf16; splits only up to the
    chunk's end (or ``n_split`` of them, the later ones empty), merged by
    their natural-log maxima."""
    _, c, hq, d = q.shape
    _, page, hkv, _ = kp.shape
    g, width = hq // hkv, row.shape[0]
    window = INT32_MAX if window is None else window
    scale = 1 / math.sqrt(d)
    bq = rows_per_cta // g
    keys = min(start + c, width * page)
    n_split = n_split or -(-keys // split)
    out = torch.zeros(1, c, hq, d)
    qf, kf, vf = q.float(), kp.float(), vp.float()
    for c0 in range(0, c, bq):
        for h in range(hkv):
            r = torch.arange(g * bq)
            ci, head = c0 + r // g, h * g + r % g
            live = ci < c
            qr = qf[0, ci.clamp(max=c - 1), head] * live[:, None]
            pos = start + ci                       # global, per row
            q_hi = start + min(c0 + bq, c) - 1
            k_lo0 = max(0, start + c0 - window + 1)
            k_hi0 = min(q_hi + 1, width * page)
            parts = []
            for s in range(n_split):
                k_lo, k_hi = max(k_lo0, s * split), min(k_hi0,
                                                        (s + 1) * split)
                m = torch.full((len(r),), NEG_INF)
                l = torch.zeros(len(r))
                acc = torch.zeros(len(r), d)
                for t0 in range(k_lo, k_hi, tile):
                    kpos = torch.arange(t0, t0 + tile)
                    ok = kpos < k_hi
                    phys = row[(kpos.clamp(max=k_hi - 1)) // page].long()
                    kt = kf[phys, kpos % page, h] * ok[:, None]
                    vt = vf[phys, kpos % page, h] * ok[:, None]
                    x = qr @ kt.T * scale
                    if logit_cap is not None:
                        x = torch.tanh(x / logit_cap) * logit_cap
                    x = x * LOG2E
                    vis = (ok[None, :] & (kpos[None, :] <= pos[:, None])
                           & (pos[:, None] - kpos[None, :] < window))
                    for w0 in range(0, len(r), warp_rows):
                        wr = slice(w0, w0 + warp_rows)
                        p_min, p_max = int(pos[wr].min()), int(pos[wr].max())
                        whole = (bool(ok.all()) and t0 + tile - 1 <= p_min
                                 and p_max - t0 < window)
                        if not whole:
                            x[wr] = torch.where(vis[wr], x[wr], NEG_INF)
                    m_new = torch.maximum(m, x.max(-1).values)
                    p = torch.exp2(x - m_new[:, None])
                    p = torch.where(x <= NEG_INF, 0.0, p)
                    alpha = torch.exp2(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + _bf(p) @ vt
                    m = m_new
                parts.append((m * LN2, l, acc))
            o = (parts[0][2] / parts[0][1].clamp(min=1e-30)[:, None]
                 if n_split == 1 else _merge(parts))
            out[0, ci[live], head[live]] = o[live]
    return out.to(q.dtype)


TC_CASES = [  # (page, pps, n_pages, c, start, hq, hkv, d)
    (16, 16, 20, 24, 200, 4, 2, 16),     # two key splits, G 2
    (16, 16, 20, 64, 180, 16, 8, 32),    # qwen3's chunk shape, narrow
    (5, 7, 11, 9, 17, 6, 2, 16),         # prime page, G 3
    (3, 11, 13, 7, 0, 3, 3, 16),         # first chunk, G 1
    (64, 4, 9, 64, 130, 2, 1, 64),       # G 2 x C 64 = 128 rows, one CTA
    (8, 40, 41, 40, 260, 8, 1, 16)]      # G 8: 16 positions a block, 3 splits


@pytest.mark.parametrize("kw", PREFILL_KW)
@pytest.mark.parametrize("case", range(len(TC_CASES)))
def test_prefill_tensor_core_walk_matches_plain_and_pallas(kw, case):
    """The tensor-core walk on bf16 inputs against the port's plain
    version and (without a window or softcap, and with both) repro's Pallas
    kernel in interpret mode (bf16 tolerance 2e-2: the walk rounds the
    unnormalized weights to bf16, the others the normalized ones), on
    windows, softcaps, prime geometries, G 1 to 8 and chunks over several
    key splits."""
    page, pps, n_pages, c, start, hq, hkv, d = TC_CASES[case]
    q, kp, vp, row, _ = _prefill_case(page, pps, n_pages, c, start, hq, hkv,
                                      d, seed=20 + case)
    q, kp, vp = (torch.from_numpy(x).bfloat16() for x in (q, kp, vp))
    row_t = torch.from_numpy(row)
    got = emulate_prefill_tc(q, kp, vp, row_t, start, **kw)
    want = ops.paged_prefill_attention(q, kp, vp, row_t, start, **kw)
    _close(got.float(), want.float(), 2e-2)
    if kw not in (PREFILL_KW[0], PREFILL_KW[3]):
        return
    jq = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, kp, vp)]
    jwant = paged_prefill_attention(*jq, jnp.asarray(row),
                                    jnp.asarray(start, jnp.int32),
                                    use_kernel=True, interpret=True, **kw)
    _close(got.float(), np.asarray(jwant, np.float32), 2e-2)


def test_prefill_wrapper_counts_launches_by_variant_only_on_the_card():
    """On the CPU the wrapper takes the plain version and counts nothing;
    on the card it names the family the library takes."""
    q, kp, vp, row, start = _t(*_prefill_case()[:4]) + [8]
    before = (K.paged_flash_prefill.launches,
              dict(K.paged_flash_prefill.variants))
    K.paged_flash_prefill(q.bfloat16(), kp.bfloat16(), vp.bfloat16(), row,
                          start, scale=0.25)
    assert (K.paged_flash_prefill.launches,
            dict(K.paged_flash_prefill.variants)) == before
    assert K.PREFILL_VARIANTS == ("cuda_cores", "mma_sync")


# ---------------------------------------------------------------------------
# MLA latent attention (paged_latent_decode_pallas, paged_latent_prefill_
# pallas) and its CUDA kernels' walk (csrc/paged_latent_common.cuh)
# ---------------------------------------------------------------------------

def _latent_pools(rng, n_pages, page, kv=16, rope=8):
    return _rand(rng, n_pages, page, kv), _rand(rng, n_pages, page, rope)


def _latent_decode_case(h=4, seed=10):
    """repro's test_serve geometry: a prime pool, lengths 5, 16 and 1."""
    rng = np.random.default_rng(seed)
    ql, qr = _rand(rng, 3, 1, h, 16), _rand(rng, 3, 1, h, 8)
    ck, kr = _latent_pools(rng, 13, 4)
    bt = np.array([[0, 3, 5, 7], [1, 2, 4, 6], [8, 9, 10, 11]], np.int32)
    lens = np.array([5, 16, 1], np.int32)
    return ql, qr, ck, kr, bt, lens


def _latent_prefill_case(h=4, page=4, n_pages=13, pps=4, c=8, seed=11):
    rng = np.random.default_rng(seed)
    ql, qr = _rand(rng, 1, c, h, 16), _rand(rng, 1, c, h, 8)
    ck, kr = _latent_pools(rng, n_pages, page)
    row = rng.choice(n_pages, size=pps, replace=False).astype(np.int32)
    return ql, qr, ck, kr, row


SCALE = 1 / math.sqrt(16 + 8)


@pytest.mark.parametrize("h", [4, 3, 5])
def test_plain_latent_decode_matches_jax(h):
    ql, qr, ck, kr, bt, lens = _latent_decode_case(h)
    got = ops.paged_latent_decode_attention(*_t(ql, qr, ck, kr, bt, lens),
                                            scale=SCALE)
    jq = [jnp.asarray(x) for x in (ql, qr, ck, kr, bt, lens)]
    _close(got, paged_latent_decode_attention(*jq, scale=SCALE))
    _close(got, paged_latent_decode_attention(*jq, scale=SCALE,
                                              use_kernel=True,
                                              interpret=True))
    _close(got, paged_latent_attention_ref(*jq, scale=SCALE))
    _close(ref.paged_latent_attention_ref(*_t(ql, qr, ck, kr, bt, lens),
                                          scale=SCALE),
           paged_latent_attention_ref(*jq, scale=SCALE))


@pytest.mark.parametrize("h,page,n_pages,pps,c,start", [
    (4, 4, 13, 4, 8, 0), (4, 4, 13, 4, 8, 8), (3, 3, 11, 3, 3, 3),
    (5, 5, 7, 2, 5, 5), (4, 2, 13, 4, 6, 0)])
def test_plain_latent_prefill_matches_jax(h, page, n_pages, pps, c, start):
    """repro's chunk at starts 0 and 8 over a prime pool (past and stale
    pages masked by the global causal rule), prime pages, odd heads."""
    ql, qr, ck, kr, row = _latent_prefill_case(h, page, n_pages, pps, c,
                                               seed=page + start)
    got = ops.paged_latent_prefill_attention(*_t(ql, qr, ck, kr, row),
                                             start, scale=SCALE)
    jq = [jnp.asarray(x) for x in (ql, qr, ck, kr, row)]
    st = jnp.asarray(start, jnp.int32)
    _close(got, paged_latent_prefill_attention(*jq, st, scale=SCALE))
    _close(got, paged_latent_prefill_attention(*jq, st, scale=SCALE,
                                               use_kernel=True,
                                               interpret=True))
    _close(got, paged_latent_prefill_ref(*jq, st, scale=SCALE))
    _close(ref.paged_latent_prefill_ref(*_t(ql, qr, ck, kr, row), start,
                                        scale=SCALE),
           paged_latent_prefill_ref(*jq, st, scale=SCALE))


def test_latent_cpu_tensors_take_the_plain_version_and_launch_nothing():
    K.paged_latent_decode.launches = 0
    K.paged_latent_prefill.launches = 0
    args = _t(*_latent_decode_case())
    want = ops.paged_latent_decode_attention(*args, scale=SCALE,
                                             use_kernel=False)
    for got in (ops.paged_latent_decode_attention(*args, scale=SCALE),
                ops.paged_latent_decode_attention(*args, scale=SCALE,
                                                  use_kernel=True),
                K.paged_latent_decode(*args, scale=SCALE)):
        assert torch.equal(got, want)
    args = _t(*_latent_prefill_case())
    want = ops.paged_latent_prefill_attention(*args, 8, scale=SCALE,
                                              use_kernel=False)
    for got in (ops.paged_latent_prefill_attention(*args, 8, scale=SCALE),
                K.paged_latent_prefill(*args, 8, scale=SCALE)):
        assert torch.equal(got, want)
    assert K.paged_latent_decode.launches == 0
    assert K.paged_latent_prefill.launches == 0


def emulate_latent(q_lat, q_rope, ckv, kr, tables, limit, *, scale,
                   p_dtype=torch.float32, rows_per_cta=16, tile=32,
                   split=128, sms=132, uniform=()):
    """csrc/paged_latent_common.cuh over q rows (B, NR, .): per (row
    block, element, key split) CTA, 32-key tiles with an online softmax in
    which a masked key weighs 0; splits (only when the blocks do not fill
    the card twice) merge.  ``limit(b, r)`` is row r's key limit; the
    elements in ``uniform`` (decode slots of length 0) walk the whole table
    with every score 0.  The tensor-core kernel rounds the softmax weights
    to bf16 for the value product (``p_dtype``); its sums run in f32, as
    here."""
    q_lat, q_rope, ckv, kr = (x.float() for x in (q_lat, q_rope, ckv, kr))
    bsz, n_rows, kv = q_lat.shape
    page, width = ckv.shape[1], tables.shape[1]
    n_blocks = -(-n_rows // rows_per_cta)
    n_split = (1 if n_blocks * bsz >= 2 * sms
               else -(-width * page // split))
    split_keys = width * page if n_split == 1 else split
    out = torch.zeros_like(q_lat)
    for b in range(bsz):
        for r0 in range(0, n_rows, rows_per_cta):
            rows = torch.arange(r0, min(r0 + rows_per_cta, n_rows))
            lim = torch.tensor([width * page if b in uniform
                                else limit(b, int(r)) for r in rows])
            q = torch.cat([q_lat[b, rows], q_rope[b, rows]], -1)
            parts = []
            for s in range(n_split):
                lo = s * split_keys
                hi = min(int(lim.max()), width * page, lo + split_keys)
                st = (torch.full((len(rows),), NEG_INF),
                      torch.zeros(len(rows)), torch.zeros(len(rows), kv))
                for t0 in range(lo, hi, tile):
                    pos = torch.arange(t0, min(t0 + tile, hi))
                    phys = tables[b, pos // page].long()
                    key = torch.cat([ckv[phys, pos % page],
                                     kr[phys, pos % page]], -1)
                    valid = pos[None, :] < lim[:, None]
                    sc = q @ key.T * scale
                    if b in uniform:
                        sc = torch.zeros_like(sc)
                    sc = torch.where(valid, sc, NEG_INF)
                    m, l, acc = st
                    m_new = torch.maximum(m, sc.max(-1).values)
                    p = torch.where(valid, torch.exp(sc - m_new[:, None]),
                                    0.0)
                    alpha = torch.exp(m - m_new)
                    pv = p.to(p_dtype).float() @ ckv[phys, pos % page]
                    st = (m_new, l * alpha + p.sum(-1), acc * alpha[:, None]
                          + pv)
                parts.append(st)
            out[b, rows] = _merge(parts)
    return out


@pytest.mark.parametrize("h", [4, 3, 5])
@pytest.mark.parametrize("geom", ["prime", "splits"])
def test_latent_decode_kernel_walk_matches_plain(h, geom):
    """A prime pool, and 64-position pages whose 512-position tables span
    four key splits (one slot whose length runs past its table)."""
    if geom == "prime":
        ql, qr, ck, kr, bt, lens = _t(*_latent_decode_case(h))
    else:
        rng = np.random.default_rng(12)
        ql, qr = _t(_rand(rng, 3, 1, h, 16), _rand(rng, 3, 1, h, 8))
        ck, kr = _t(*_latent_pools(rng, 25, 64))
        bt = torch.from_numpy(rng.permutation(24).reshape(3, 8)
                              .astype(np.int32))
        lens = torch.tensor([300, 511, 515], dtype=torch.int32)
    got = emulate_latent(ql[:, 0], qr[:, 0], ck, kr, bt,
                         lambda b, r: int(lens[b]), scale=SCALE)
    want = ops.paged_latent_decode_attention(ql, qr, ck, kr, bt, lens,
                                             scale=SCALE)
    _close(got[:, None], want)


@pytest.mark.parametrize("h", [4, 3, 5])
def test_latent_prefill_kernel_walk_matches_plain(h):
    """A late chunk whose causal range spans two key splits; rows of a
    16-row block straddle positions for H = 3 and 5."""
    ql, qr, ck, kr, row = _t(*_latent_prefill_case(h, 16, 20, 16, 24,
                                                   seed=13))
    start = 200
    got = emulate_latent(ql.reshape(1, 24 * h, 16), qr.reshape(1, 24 * h, 8),
                         ck, kr, row[None],
                         lambda b, r: start + r // h + 1, scale=SCALE)
    want = ops.paged_latent_prefill_attention(ql, qr, ck, kr, row, start,
                                              scale=SCALE)
    _close(got, want.reshape(1, 24 * h, 16))


@pytest.mark.parametrize("start,c,h", [(200, 24, 4), (0, 8, 5)])
def test_latent_tensor_core_walk_matches_plain_in_bf16(start, c, h):
    """The bf16 tensor-core kernel's walk (weights rounded to bf16 before
    the value product) against the plain version on bf16 inputs, within
    the kernels' bf16 tolerance (2e-2); kv_lora 64 and qk_rope 16 are the
    smallest widths that kernel takes."""
    rng = np.random.default_rng(14)
    bf = torch.bfloat16
    ql = torch.from_numpy(_rand(rng, 1, c, h, 64)).to(bf)
    qr = torch.from_numpy(_rand(rng, 1, c, h, 16)).to(bf)
    ck = torch.from_numpy(_rand(rng, 20, 16, 64)).to(bf)
    kr = torch.from_numpy(_rand(rng, 20, 16, 16)).to(bf)
    row = torch.from_numpy(rng.permutation(20)[:16].astype(np.int32))
    scale = 1 / math.sqrt(80)
    got = emulate_latent(ql.reshape(1, c * h, 64), qr.reshape(1, c * h, 16),
                         ck, kr, row[None], lambda b, r: start + r // h + 1,
                         scale=scale, p_dtype=bf)
    want = ops.paged_latent_prefill_attention(ql, qr, ck, kr, row, start,
                                              scale=scale)
    _close(got.to(bf).float(), want.float().reshape(1, c * h, 64), 2e-2)


def _latent_wgmma_splits(start, c, h, sms=132, rows=64, tile=64):
    """csrc/paged_latent_wgmma.cuh's split rule: (n_split, split_keys)."""
    blocks = -(-c * h // rows)
    keys = start + c
    split_keys = -(-keys // tile) * tile
    if blocks < sms:
        want = -(-sms // blocks)
        split_keys = -(-(-(-keys // want)) // tile) * tile
    return -(-keys // split_keys), split_keys


def _wgmma_walk(q, ckf, krf, table, lo, hi, limit, scale, tile=64,
                uniform=False, p_bf16=True):
    """csrc/paged_latent_wgmma.cuh's walk of one CTA: rows q (R, kv +
    rope) in f32 from bf16 operands against 64-key tiles inside one page
    from ``lo`` to ``hi`` of the block-table row ``table``, each row masked
    at its own ``limit`` (<= hi); S in the log2 domain; each warpgroup's 32
    keys give a row max, the two meet, and each keeps the row sum of its
    own keys (added at the end, warpgroup 0's first); the weights are
    rounded to bf16 before the value product, which each warpgroup runs
    over its half of the value features; ``uniform`` scores every key 0;
    without ``p_bf16`` the weights stay f32 (the walk's arithmetic alone).
    Returns (m in log2 units, l, acc unnormalized)."""
    page, kv = ckf.shape[1], ckf.shape[2]
    half, wk = kv // 2, tile // 2
    m = torch.full((q.shape[0],), NEG_INF)
    l_wg = torch.zeros(2, q.shape[0])
    acc = torch.zeros(q.shape[0], kv)
    for t0 in range(lo, hi, tile):
        pos = torch.arange(t0, t0 + tile)
        phys = int(table[t0 // page])
        v = ckf[phys, pos % page]
        key = torch.cat([v, krf[phys, pos % page]], -1)
        x = q @ key.T * (scale * LOG2E)
        if uniform:
            x = torch.zeros_like(x)
        x = torch.where(pos[None, :] < limit[:, None], x, NEG_INF)
        m_new = torch.maximum(m, x.max(-1).values)
        alpha = torch.exp2(m - m_new)
        p = torch.where(x <= NEG_INF, 0.0, torch.exp2(x - m_new[:, None]))
        l_wg = l_wg * alpha + torch.stack([p[:, :wk].sum(-1),
                                           p[:, wk:].sum(-1)])
        pb = _bf(p) if p_bf16 else p
        acc = acc * alpha[:, None] + torch.cat(
            [pb @ v[:, :half], pb @ v[:, half:]], -1)
        m = m_new
    return m, l_wg[0] + l_wg[1], acc


def emulate_latent_wgmma(q_lat, q_rope, ckv, kr, row, start, *, scale,
                         sms=132, rows_per_cta=64, tile=64, splits=None):
    """csrc/paged_latent_wgmma.cuh's prefill over the chunk's C * H rows
    (row r: position r // H, head r % H): per (64-row block, key split)
    CTA, the walk (``_wgmma_walk``) from the split's start to its last
    row's causal limit, each row masked by its own limit (a block may
    straddle positions); splits (when the blocks do not fill ``sms``
    processors, or ``splits`` = (n_split, split_keys) given) merge by their
    natural-log maxima in split order."""
    _, c, h, kv = q_lat.shape
    page, width = ckv.shape[1], row.shape[0]
    n_rows = c * h
    q = torch.cat([q_lat.float().reshape(n_rows, kv),
                   q_rope.float().reshape(n_rows, -1)], -1)
    ckf, krf = ckv.float(), kr.float()
    n_split, split_keys = splits or _latent_wgmma_splits(
        start, c, h, sms, rows_per_cta, tile)
    out = torch.zeros(n_rows, kv)
    for r0 in range(0, n_rows, rows_per_cta):
        r = torch.arange(r0, min(r0 + rows_per_cta, n_rows))
        limit = start + r // h + 1
        parts = []
        for s in range(n_split):
            lo = s * split_keys
            hi = min(int(limit.max()), width * page, lo + split_keys)
            m, l, acc = _wgmma_walk(q[r], ckf, krf, row, lo, hi,
                                    torch.clamp(limit, max=hi), scale, tile)
            parts.append((m * LN2, l, acc))
        if n_split == 1:
            out[r] = parts[0][2] / parts[0][1].clamp(min=1e-30)[:, None]
        else:
            out[r] = _merge(parts)
    return out.reshape(1, c, h, kv).to(q_lat.dtype)


def emulate_latent_decode_wgmma(q_lat, q_rope, ckv, kr, tables, lengths, *,
                                scale, ranks=8, rows_per_cta=64, tile=64):
    """csrc/paged_latent_wgmma.cuh's decode: per (slot, 64-head block) a
    cluster of ``ranks`` CTAs; the slot's live keys [0, min(length, width
    * page)) in 64-key tiles, rank k taking tiles [k s, k s + s) with
    s = ceil(tiles / ranks), a rank past them walking nothing and leaving
    no state; every rank merges a slice of the features from the live
    ranks' (m, l, acc) in rank order (log2 domain).  A slot with no valid
    key walks its whole table with every score 0.  Returns (B, 1, H, kv)
    and the live ranks of each slot."""
    b, _, h, kv = q_lat.shape
    page, width = ckv.shape[1], tables.shape[1]
    q = torch.cat([q_lat.float()[:, 0], q_rope.float()[:, 0]], -1)
    ckf, krf = ckv.float(), kr.float()
    out = torch.zeros(b, h, kv)
    lives = []
    for slot in range(b):
        n = max(min(int(lengths[slot]), width * page), 0)
        uniform = n == 0
        if uniform:
            n = width * page
        tiles = -(-n // tile)
        share = -(-tiles // ranks)
        live = -(-tiles // share) if share else 0
        lives.append(live)
        for h0 in range(0, h, rows_per_cta):
            rows = torch.arange(h0, min(h0 + rows_per_cta, h))
            states = []
            for rank in range(ranks):
                lo = min(rank * share * tile, n)
                hi = min(n, lo + share * tile)
                if hi > lo:
                    states.append(_wgmma_walk(
                        q[slot, rows], ckf, krf, tables[slot], lo, hi,
                        torch.full((len(rows),), hi), scale, tile,
                        uniform))
            assert len(states) == live
            if not states:
                continue
            mm = torch.stack([st[0] for st in states]).max(0).values
            ll = torch.zeros(len(rows))
            acc = torch.zeros(len(rows), kv)
            for m, l, a in states:     # rank order
                w = torch.exp2(m - mm)
                ll = ll + l * w
                acc = acc + a * w[:, None]
            out[slot, rows] = acc / ll.clamp(min=1e-30)[:, None]
    return out[:, None].to(q_lat.dtype), lives


WGMMA_CASES = [  # (h, c, start, pps, n_pages, sms)
    (3, 37, 200, 8, 13, 132),   # blocks straddle positions, four splits
    (5, 9, 3, 4, 7, 132),       # one block, start off the tile, one split
    (64, 3, 301, 6, 11, 132),   # blocks of one position, five splits
    (5, 40, 150, 4, 9, 1)]      # a card with fewer processors: no split


@pytest.mark.parametrize("case", range(len(WGMMA_CASES)))
def test_latent_wgmma_walk_matches_plain_and_pallas(case):
    """The wgmma kernel's walk on bf16 inputs (64-position pages; kv_lora
    64 and qk_rope 16 stand for 512 and 64, the warpgroups' halves of the
    value features 32 wide) against the port's plain version and repro's Pallas
    kernel in interpret mode, within the kernels' bf16 tolerance (2e-2:
    the walk rounds the unnormalized weights to bf16, the others the
    normalized ones)."""
    h, c, start, pps, n_pages, sms = WGMMA_CASES[case]
    rng = np.random.default_rng(30 + case)
    bf = torch.bfloat16
    ql = torch.from_numpy(_rand(rng, 1, c, h, 64)).to(bf)
    qr = torch.from_numpy(_rand(rng, 1, c, h, 16)).to(bf)
    ck = torch.from_numpy(_rand(rng, n_pages, 64, 64)).to(bf)
    kr = torch.from_numpy(_rand(rng, n_pages, 64, 16)).to(bf)
    row = rng.permutation(n_pages)[:pps].astype(np.int32)
    scale = 1 / math.sqrt(80)
    n_split, _ = _latent_wgmma_splits(start, c, h, sms)
    assert (n_split > 1) == (case in (0, 2))
    got = emulate_latent_wgmma(ql, qr, ck, kr, torch.from_numpy(row), start,
                               scale=scale, sms=sms)
    want = ops.paged_latent_prefill_attention(ql, qr, ck, kr,
                                              torch.from_numpy(row), start,
                                              scale=scale)
    _close(got.float(), want.float(), 2e-2)
    jq = [jnp.asarray(x.float().numpy(), jnp.bfloat16)
          for x in (ql[0], qr[0], ck, kr)]
    jwant = paged_latent_prefill_pallas(*jq, jnp.asarray(row),
                                        jnp.asarray(start, jnp.int32),
                                        scale=scale, interpret=True)
    _close(got[0].float(), np.asarray(jwant, np.float32), 2e-2)


@pytest.mark.parametrize("h,ranks", [(5, 8), (70, 4), (128, 8)])
def test_latent_decode_wgmma_ranks_match_plain_and_pallas(h, ranks):
    """The wgmma decode's live-key rank shares and rank-order merge on
    bf16 inputs (64-position pages, a table of 12 pages; kv_lora 64 and
    qk_rope 16 stand for 512 and 64) at lengths 1, 63, 64, 65, the full
    width and one past it, against the port's plain version and repro's
    Pallas kernel in interpret mode, within the kernels' bf16 tolerance
    (2e-2); ranks past a slot's tiles hold nothing, and a slot with no
    valid key walks its whole table, every key weighed alike, to the
    plain version's uniform mean of its masked keys."""
    rng = np.random.default_rng(40 + h)
    bf = torch.bfloat16
    lens = [1, 63, 64, 65, 768, 769, 0]
    b, width, page = len(lens), 12, 64
    n_pool = b * width + 1
    ql = torch.from_numpy(_rand(rng, b, 1, h, 64)).to(bf)
    qr = torch.from_numpy(_rand(rng, b, 1, h, 16)).to(bf)
    ck = torch.from_numpy(_rand(rng, n_pool, page, 64)).to(bf)
    kr = torch.from_numpy(_rand(rng, n_pool, page, 16)).to(bf)
    bt = rng.permutation(n_pool - 1)[:b * width].reshape(b, width)
    bt = torch.from_numpy(bt.astype(np.int32))
    lengths = torch.tensor(lens, dtype=torch.int32)
    scale = 1 / math.sqrt(80)
    got, lives = emulate_latent_decode_wgmma(ql, qr, ck, kr, bt, lengths,
                                             scale=scale, ranks=ranks)
    keys = [min(n, 768) or 768 for n in lens]   # length 0: the whole row
    share = [-(-(-(-n // 64)) // ranks) for n in keys]
    assert lives == [-(-(-(-n // 64)) // s) for n, s in zip(keys, share)]
    assert lives[:4] == [1, 1, 1, min(2, ranks)]
    assert lives[-1] == -(-12 // -(-12 // ranks))
    want = ops.paged_latent_decode_attention(ql, qr, ck, kr, bt, lengths,
                                             scale=scale)
    _close(got.float(), want.float(), 2e-2)
    jq = [jnp.asarray(x.float().numpy(), jnp.bfloat16)
          for x in (ql[:-1, 0], qr[:-1, 0], ck, kr)]
    jwant = paged_latent_decode_pallas(*jq, jnp.asarray(bt[:-1].numpy()),
                                       jnp.asarray(lens[:-1], jnp.int32),
                                       scale=scale, interpret=True)
    _close(got[:-1, 0].float(), np.asarray(jwant, np.float32), 2e-2)


def test_latent_and_decode_wrappers_count_variants_only_on_the_card():
    """On the CPU the wrappers take the plain version and count nothing;
    on the card they name the family the library takes."""
    counters = (K.paged_flash_decode, K.paged_latent_prefill,
                K.paged_latent_decode)
    before = [(f.launches, dict(f.variants)) for f in counters]
    K.paged_flash_decode(*_t(*_decode_case()), scale=0.25)
    ql, qr, ck, kr, row = _t(*_latent_prefill_case())
    K.paged_latent_prefill(ql.bfloat16(), qr.bfloat16(), ck.bfloat16(),
                           kr.bfloat16(), row, 8, scale=SCALE)
    ql, qr, ck, kr, bt, lens = _t(*_latent_decode_case())
    K.paged_latent_decode(ql.bfloat16(), qr.bfloat16(), ck.bfloat16(),
                          kr.bfloat16(), bt, lens, scale=SCALE)
    assert [(f.launches, dict(f.variants)) for f in counters] == before
    assert K.DECODE_VARIANTS == ("cuda_cores", "mma_sync")
    assert K.FLASH_VARIANTS == ("cuda_cores", "mma_sync", "wgmma", "cluster",
                                "wgmma_tf32x3")


def test_paged_bench_ablations_still_apply():
    """``launch.paged_bench --ablate`` builds copies of the decode and
    latent prefill sources with parts taken out: each edit still finds its
    text, and changes it."""
    from repro_torch.kernels import build
    from repro_torch.launch import paged_bench
    copies = paged_bench.ablated_sources(build.CSRC)
    assert set(copies) == set(paged_bench.ABLATIONS)
    for fname, text in copies.values():
        assert text != (build.CSRC / fname).read_text()
