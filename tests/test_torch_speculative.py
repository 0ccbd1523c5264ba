"""Speculative decoding, the single-tick decode loop and the reference
decoder of the port against ``repro``'s, on the CPU.

(a) Integer state, exactly: the n-gram drafter (fixed cases and a seeded
    random sweep against ``repro`` and a numpy oracle), the planned draft
    length, and ``verify_ticks``' token blocks, accepted-draft counts and
    history against ``repro.models.verify_ticks`` from the same state.
(b) The verify attention: the plain versions against ``repro``'s jnp path,
    its Pallas kernels in interpret mode and the dense oracles (f32 atol
    1e-4, ``torch_parity.ATOL``), and at W = 1 bitwise the port's own plain
    decode.  Non-null page pools after ``verify_ticks`` within ATOL of
    ``repro``'s (the null page takes colliding writes in any order).
(c) The engine, torch against torch: speculative serving emits the fused
    engine's tokens on every decoder arch, ``fused=False`` does too, and a
    preempted speculative request resumes identically; plus the behaviour
    tests of ``tests/test_speculative.py`` (eos mid-window, the max_seq cut,
    preemption, a prime page geometry, the acceptance stats, the history
    kept on the device, the adaptive fallback, the greedy-only and geometry
    errors) and ``reference_decode`` against ``repro``'s.
(d) CPU emulations of the two verify entries' cluster walks (``csrc/
    paged_decode.cu``: paged_verify_cluster, ``csrc/paged_latent_wgmma.cuh``:
    the latent verify's cluster_kernel): rank shares sized from
    ``lengths`` as the kernels read them on the device, per-row causal
    limits (and, for GQA, window lower bounds), empty ranks and the
    rank-order merge, against the plain versions (bf16 2e-2, f32 1e-5).
"""
import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.kernels.attention import (paged_latent_verify_attention,
                                     paged_latent_verify_ref,
                                     paged_verify_attention,
                                     paged_verify_ref)
from repro.serve import paco_draft_len as jax_draft_len
from repro_torch import configs as tcfg
from repro_torch import models as tmodels
from repro_torch.kernels.attention import attention as K
from repro_torch.kernels.attention import ops, ref
from repro_torch.serve import (Request, ServeEngine, paco_draft_len,
                               reference_decode)
from test_torch_paged_attention import _wgmma_walk, emulate_latent
from torch_parity import (close, models, pools_jax,  # noqa: F401
                          reference, serve)

DECODER_ARCHS = sorted(a for a, c in tcfg.ARCHS.items()
                       if c.family == "decoder")
KW = [{}, {"window": 6}, {"logit_cap": 20.0},
      {"window": 3, "logit_cap": 5.0}]
SPEC_PROMPTS = [[1, 2, 3, 1, 2, 3, 1], [9, 9, 9, 9, 9], [2, 4],
                [7, 1, 7, 1, 7, 1]]


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the drafter and the draft length: integers, exactly
# ---------------------------------------------------------------------------

def _draft_oracle(hist, ctx_len, draft_len, ngram):
    b, _ = hist.shape
    out = np.zeros((b, draft_len), np.int64)
    for i in range(b):
        n = int(ctx_len[i])
        row = hist[i]
        best = -1
        if n > ngram:
            for s in range(ngram, n):
                if np.array_equal(row[s - ngram:s], row[n - ngram:n]):
                    best = s           # ascending: the last match wins
        for t in range(draft_len):
            out[i, t] = row[best + t] if 0 <= best and best + t < n \
                else row[n - 1]
    return out


def _drafts_agree(hist, ctx, draft_len, ngram):
    got = tmodels.draft_ngram_propose(*_t(hist, ctx), draft_len=draft_len,
                                      ngram=ngram)
    assert got.dtype == torch.int32
    want = np.asarray(jmodels.draft_ngram_propose(
        jnp.asarray(hist), jnp.asarray(ctx), draft_len=draft_len,
        ngram=ngram))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  _draft_oracle(hist, ctx, draft_len, ngram))
    return got.numpy()


def test_draft_ngram_matches_jax_on_fixed_cases():
    """tests/test_speculative.py's cases: a periodic row, a constant run,
    no repeat, a context shorter than the n-gram."""
    hist = np.array([[1, 2, 3, 1, 2, 3, 1, 2, 0, 0],
                     [7, 7, 7, 7, 7, 0, 0, 0, 0, 0],
                     [1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
                     [4, 0, 0, 0, 0, 0, 0, 0, 0, 0]], np.int32)
    ctx = np.array([8, 5, 10, 1], np.int32)
    got = _drafts_agree(hist, ctx, 4, 2)
    assert list(got[0]) == [3, 1, 2, 2]
    assert list(got[2]) == [10, 10, 10, 10]
    assert list(got[3]) == [4, 4, 4, 4]
    with pytest.raises(ValueError):
        tmodels.draft_ngram_propose(*_t(hist, ctx), draft_len=0)


def test_draft_ngram_matches_jax_on_a_seeded_sweep():
    """Random histories over a vocab of 5 (so matches occur), 4 slots of
    1-14 tokens, every draft length 1-5 and n-gram 1-3 twice: the port
    equals repro and the oracle, twice, and proposes only its own
    context's tokens."""
    rng = np.random.default_rng(0)
    for case in range(30):
        rows = [rng.integers(0, 5, size=rng.integers(1, 15)).tolist()
                for _ in range(4)]
        draft_len, ngram = case % 5 + 1, case // 10 + 1
        hist = np.zeros((4, 16), np.int32)
        ctx = np.array([len(r) for r in rows], np.int32)
        for i, r in enumerate(rows):
            hist[i, :len(r)] = r
        got = _drafts_agree(hist, ctx, draft_len, ngram)
        np.testing.assert_array_equal(
            got, _drafts_agree(hist, ctx, draft_len, ngram))
        for i, r in enumerate(rows):
            assert set(got[i]) <= set(r)


def test_paco_draft_len_matches_jax():
    """Equal over a grid with primes in every axis; the window never
    exceeds the PACO page."""
    for slots in (1, 2, 3, 4, 7, 13, 16):
        for max_seq in (16, 31, 64, 97, 128, 512, 2048):
            for feat in (17, 64, 128, 512):
                d = paco_draft_len(slots, max_seq, feat)
                assert d == jax_draft_len(slots, max_seq, feat)
                assert 1 <= d <= 7


# ---------------------------------------------------------------------------
# (b) the verify attention
# ---------------------------------------------------------------------------

def _verify_case(w=4, seed=0):
    rng = np.random.default_rng(seed)
    b, hq, hkv, d, page, n_pages = 3, 4, 2, 16, 4, 13
    bt = np.array([[0, 3, 5, 7], [1, 2, 4, 6], [8, 9, 10, 11]], np.int32)
    return (_rand(rng, b, w, hq, d), _rand(rng, n_pages, page, hkv, d),
            _rand(rng, n_pages, page, hkv, d), bt,
            np.array([5, 12, 0], np.int32))


def _latent_verify_case(w=4, seed=1):
    rng = np.random.default_rng(seed)
    b, h, kv, rope, page, n_pages = 3, 4, 16, 8, 4, 13
    bt = np.array([[0, 3, 5, 7], [1, 2, 4, 6], [8, 9, 10, 11]], np.int32)
    return (_rand(rng, b, w, h, kv), _rand(rng, b, w, h, rope),
            _rand(rng, n_pages, page, kv), _rand(rng, n_pages, page, rope),
            bt, np.array([5, 12, 0], np.int32))


LATENT_SCALE = 1 / math.sqrt(16 + 8)


@pytest.mark.parametrize("kw", KW)
def test_plain_verify_matches_jax_and_the_dense_oracles(kw):
    """GQA with and without a window and softcap: the port's plain verify
    against repro's jnp path and both packages' dense oracles; without a
    window or softcap and with both, against repro's Pallas prefill kernel
    vmapped over the slots in interpret mode."""
    case = _verify_case()
    got = ops.paged_verify_attention(*_t(*case), **kw)
    jq = [jnp.asarray(x) for x in case]
    close(got, paged_verify_attention(*jq, **kw))
    close(got, paged_verify_ref(*jq, **kw))
    close(ref.paged_verify_ref(*_t(*case), **kw), paged_verify_ref(*jq, **kw))
    if kw in (KW[0], KW[3]):
        close(got, paged_verify_attention(*jq, use_kernel=True,
                                          interpret=True, **kw))


def test_plain_latent_verify_matches_jax_and_the_dense_oracles():
    case = _latent_verify_case()
    got = ops.paged_latent_verify_attention(*_t(*case), scale=LATENT_SCALE)
    jq = [jnp.asarray(x) for x in case]
    close(got, paged_latent_verify_attention(*jq, scale=LATENT_SCALE))
    close(got, paged_latent_verify_ref(*jq, scale=LATENT_SCALE))
    close(got, paged_latent_verify_attention(*jq, scale=LATENT_SCALE,
                                             use_kernel=True,
                                             interpret=True))
    close(ref.paged_latent_verify_ref(*_t(*case), scale=LATENT_SCALE),
          paged_latent_verify_ref(*jq, scale=LATENT_SCALE))


@pytest.mark.parametrize("kw", KW)
def test_plain_verify_at_w1_is_bitwise_the_plain_decode(kw):
    """A one-token window at position lengths is the decode tick at
    lengths + 1, bit for bit (torch against torch)."""
    q, kp, vp, bt, lens = _t(*_verify_case(w=1))
    lens = torch.tensor([5, 12, 1], dtype=torch.int32)
    assert torch.equal(ops.paged_verify_attention(q, kp, vp, bt, lens, **kw),
                       ops.paged_decode_attention(q, kp, vp, bt, lens + 1,
                                                  **kw))
    ql, qr, ck, kr, bt, _ = _t(*_latent_verify_case(w=1))
    assert torch.equal(
        ops.paged_latent_verify_attention(ql, qr, ck, kr, bt, lens,
                                          scale=LATENT_SCALE),
        ops.paged_latent_decode_attention(ql, qr, ck, kr, bt, lens + 1,
                                          scale=LATENT_SCALE))


def test_verify_wrappers_take_the_plain_version_on_the_cpu():
    before = [(f.launches, dict(f.variants))
              for f in (K.paged_flash_verify, K.paged_latent_verify)]
    q, kp, vp, bt, lens = _t(*_verify_case())
    assert torch.equal(K.paged_flash_verify(q, kp, vp, bt, lens, scale=0.25),
                       ops.paged_verify_attention(q, kp, vp, bt, lens,
                                                  scale=0.25))
    args = _t(*_latent_verify_case())
    assert torch.equal(K.paged_latent_verify(*args, scale=LATENT_SCALE),
                       ops.paged_latent_verify_attention(
                           *args, scale=LATENT_SCALE, use_kernel=True))
    assert [(f.launches, dict(f.variants)) for f in
            (K.paged_flash_verify, K.paged_latent_verify)] == before


# ---------------------------------------------------------------------------
# (a) verify_ticks against repro's, from the same engine state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,warm", [("qwen3-0.6b", 0),
                                       ("deepseek-v2-236b", 1)])
def test_verify_ticks_match_jax(models, arch, warm):
    """Two slots after ``warm`` fused dispatches (chosen so that drafts are
    both accepted and rolled back), then 4 verify steps of W = 4 in both
    packages from the same tokens, pools, tables and history: blocks,
    accepted counts and history equal, non-null pools within ATOL.  The
    port's tokens are also its fused decode's, as many as it emitted."""
    cj, ct, pj, pt = models[arch]
    eng = ServeEngine(pt, ct, slots=2, max_seq=64, page_size=4,
                      prefill_chunk_len=8, device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3, 1, 2, 3, 1],
                       max_new_tokens=50))
    eng.submit(Request(uid=1, prompt=[9, 9, 9, 9, 9], max_new_tokens=50))
    eng._admit()
    for _ in range(warm):
        eng.tick()
    steps, draft_len = 4, 3
    span = steps * (draft_len + 1)
    eng._ensure_decode_pages(span)
    bt = eng.tables.device_view(eng.pages_per_seq)
    toks = torch.tensor(eng._last_tok, dtype=torch.int32)
    lens = torch.tensor(eng._ctx_len, dtype=torch.int32)
    start = {k: v.clone() for k, v in eng.pool.pools.items()}
    hist = torch.from_numpy(eng._hist.copy())
    ones = torch.ones(2, dtype=torch.bool)
    bud = torch.full((2,), 100, dtype=torch.int32)
    eos = torch.full((2,), -1, dtype=torch.int32)
    pools = {k: v.clone() for k, v in start.items()}
    blocks, acc, hist_t, pools = tmodels.verify_ticks(
        pt, ct, toks, pools, bt, lens, ones, bud, eos, hist, lens + span,
        steps, max_seq=eng.max_seq, draft_len=draft_len)
    jb, ja, jh, jp = jmodels.verify_ticks(
        pj, cj, jnp.asarray(toks.numpy()), pools_jax(start),
        jnp.asarray(bt.numpy()), jnp.asarray(lens.numpy()),
        jnp.ones((2,), bool), jnp.full((2,), 100, jnp.int32),
        jnp.full((2,), -1, jnp.int32), jnp.asarray(hist.numpy()),
        jnp.asarray((lens + span).numpy()), jnp.zeros((steps,), jnp.int32),
        max_seq=eng.max_seq, draft_len=draft_len)
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(jh))
    n = eng.pool.n_pages
    for name in pools:
        close(pools[name][:, :n], np.asarray(jp[name])[:, :n])
    assert int(acc.sum()) > 0, "no draft was accepted: the test is vacuous"
    assert (blocks < 0).any(), "no draft was rejected"
    # the fused decode emits the same stream
    fused, _ = tmodels.decode_ticks(
        pt, ct, toks, {k: v.clone() for k, v in start.items()}, bt, lens,
        ones, bud, eos, span, max_seq=eng.max_seq)
    for slot in range(2):
        emitted = [int(x) for x in blocks[:, slot].flatten() if x >= 0]
        assert emitted == fused[:len(emitted), slot].tolist()


def test_verify_ticks_roll_back_past_a_budget_of_one(models):
    """Budget 1 and a write plan of one position: each slot emits the
    decode tick's token and the non-null pools equal one decode tick's
    (torch against torch, exactly)."""
    _, ct, _, pt = models["qwen3-0.6b"]
    eng = ServeEngine(pt, ct, slots=2, max_seq=32, page_size=4,
                      prefill_chunk_len=8, device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=50))
    eng.submit(Request(uid=1, prompt=[5, 6, 7], max_new_tokens=50))
    eng._admit()
    eng._ensure_decode_pages(1)
    bt = eng.tables.device_view(eng.pages_per_seq)
    toks = torch.tensor(eng._last_tok, dtype=torch.int32)
    lens = torch.tensor(eng._ctx_len, dtype=torch.int32)
    ones = torch.ones(2, dtype=torch.bool)
    one = torch.ones(2, dtype=torch.int32)
    eos = torch.full((2,), -1, dtype=torch.int32)
    pools_d = {k: v.clone() for k, v in eng.pool.pools.items()}
    pools_v = {k: v.clone() for k, v in eng.pool.pools.items()}
    block, pools_d = tmodels.decode_ticks(pt, ct, toks, pools_d, bt, lens,
                                          ones, one, eos, 1,
                                          max_seq=eng.max_seq)
    blocks, _, _, pools_v = tmodels.verify_ticks(
        pt, ct, toks, pools_v, bt, lens, ones, one, eos,
        torch.from_numpy(eng._hist.copy()), lens + 1, 1,
        max_seq=eng.max_seq, draft_len=3)
    for slot in range(2):
        assert [int(x) for x in blocks[0, slot] if x >= 0] == \
            [int(block[0, slot])]
    n = eng.pool.n_pages
    for name in pools_d:
        assert torch.equal(pools_v[name][:, :n], pools_d[name][:, :n])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_reference_decode_matches_jax(models, arch):
    """The port's oracle against repro's ``reference_decode`` (its padded,
    jitted form from ``torch_parity``, which ``test_torch_engine.py`` holds
    to ``reference_decode`` itself): equal tokens."""
    cj, ct, pj, pt = models[arch]
    for prompt in ([4, 2, 9], [1, 2, 3, 1, 2]):
        got = reference_decode(pt, ct, prompt, max_new_tokens=5, max_seq=32)
        assert got == reference(pj, cj, Request(0, prompt, 5), 32)
    assert len(reference_decode(pt, ct, [1] * 14, max_new_tokens=9,
                                max_seq=16)) == 2   # the max_seq cut


# ---------------------------------------------------------------------------
# (c) the engine, torch against torch
# ---------------------------------------------------------------------------

def _drain(pt, ct, prompts, max_new, eos=-1, **kw):
    eng, done = serve(pt, ct, kw, prompts, max_new, eos)
    assert len(done) == len(prompts)
    assert eng.pool.free_count() == eng.pool.n_pages
    return eng, {r.uid: r.out for r in done}


def _assert_reference(eng, pt, ct):
    for r in eng.done:
        assert r.out == reference_decode(pt, ct, r.prompt,
                                         max_new_tokens=r.max_new_tokens,
                                         eos_id=r.eos_id,
                                         max_seq=eng.max_seq), r.uid


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_spec_engine_matches_fused_on_every_decoder_arch(models, arch):
    """Speculative serving (every dispatch verifying) emits the fused
    engine's tokens: plain GQA, windows and softcaps, MoE in the verify
    window, the MLA latent pages."""
    _, ct, _, pt = models[arch]
    kw = dict(slots=3, max_seq=64, prefill_chunk_len=16)
    _, fused = _drain(pt, ct, SPEC_PROMPTS, 24, **kw)
    eng, spec = _drain(pt, ct, SPEC_PROMPTS, 24, speculate=3,
                       spec_min_accept=0, **kw)
    assert spec == fused
    assert eng.stats["accepted_tokens"] > 0, "no draft was accepted"
    assert eng.stats["spec_fallback_dispatches"] == 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b",
                                  "deepseek-v2-236b"])
def test_single_tick_engine_matches_fused(models, arch):
    """``fused=False``: one decode step and one host sync per token, full
    tables, the fused engine's tokens."""
    _, ct, _, pt = models[arch]
    kw = dict(slots=3, max_seq=64, prefill_chunk_len=16)
    _, fused = _drain(pt, ct, SPEC_PROMPTS, 12, **kw)
    eng, single = _drain(pt, ct, SPEC_PROMPTS, 12, fused=False, **kw)
    assert single == fused
    st = eng.stats
    assert st["dispatches"] == st["decode_steps"] > 0
    assert st["max_table_width"] == eng.pages_per_seq


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_preempted_spec_request_resumes_identically(models, arch):
    """A prime pool of 11 pages under speculative pre-mapping (2 steps x
    W 3 positions a slot): the youngest request is evicted at a dispatch
    boundary, re-prefilled, and every request emits what an unpressured
    fused engine emits."""
    _, ct, _, pt = models[arch]
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12]]
    kw = dict(slots=3, max_seq=32, page_size=4, prefill_chunk_len=8,
              ticks_per_dispatch=2)
    _, want = _drain(pt, ct, prompts, 16, **kw)
    eng, got = _drain(pt, ct, prompts, 16, pool_pages=11, speculate=2,
                      spec_min_accept=0, **kw)
    assert eng.stats["preemptions"] >= 1
    assert any(r.preemptions for r in eng.done)
    assert got == want


def test_spec_eos_mid_window(models):
    """eos inside a verify window: the slot stops at the reference's
    position; its sibling decodes on."""
    _, ct, _, pt = models["qwen3-0.6b"]
    want = reference_decode(pt, ct, [4, 2, 9], max_new_tokens=12,
                            max_seq=64)
    eng, out = _drain(pt, ct, [[4, 2, 9], [7, 7]], 12, eos=want[2],
                      slots=2, max_seq=64, speculate=3, ticks_per_dispatch=4,
                      spec_min_accept=0)
    assert out[0] == want[:3]
    _assert_reference(eng, pt, ct)


def test_spec_max_seq_truncation(models):
    _, ct, _, pt = models["qwen3-0.6b"]
    eng, out = _drain(pt, ct, [list(range(1, 11)), [3, 5]], 50, slots=2,
                      max_seq=16, page_size=4, speculate=3,
                      spec_min_accept=0)
    assert 10 + len(out[0]) == 16
    _assert_reference(eng, pt, ct)


def test_spec_preemption_at_block_boundary(models):
    _, ct, _, pt = models["qwen3-0.6b"]
    eng, _ = _drain(pt, ct, [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12]], 20,
                    slots=2, max_seq=32, page_size=4, pool_pages=11,
                    prefill_chunk_len=8, speculate=2, ticks_per_dispatch=2,
                    spec_min_accept=0)
    assert eng.stats["preemptions"] >= 1
    _assert_reference(eng, pt, ct)


def test_spec_prime_page_geometry(models):
    """Pages of 7, a prime pool, windows straddling page boundaries."""
    _, ct, _, pt = models["qwen3-0.6b"]
    eng, _ = _drain(pt, ct, [[1, 2, 3, 1, 2, 3], [5] * 9, [8, 6]], 9,
                    slots=3, max_seq=63, page_size=7, pool_pages=29,
                    prefill_chunk_len=7, speculate=4, spec_min_accept=0)
    _assert_reference(eng, pt, ct)


def test_spec_acceptance_stats_consistent(models):
    _, ct, _, pt = models["qwen3-0.6b"]
    eng, _ = _drain(pt, ct, SPEC_PROMPTS[:3], 12, slots=2, max_seq=64,
                    speculate=3, spec_min_accept=0)
    s = eng.stats
    assert s["spec_windows"] > 0
    assert s["drafted_tokens"] == 3 * s["spec_windows"]
    assert 0 <= s["accepted_tokens"] <= s["drafted_tokens"]
    assert (s["spec_windows"] <= s["decode_tokens"]
            <= s["spec_windows"] + s["accepted_tokens"])


def test_spec_history_stays_on_the_device(models):
    """Between speculative dispatches with no slot change the history is
    the verify steps' own copy, token for token the host's."""
    _, ct, _, pt = models["qwen3-0.6b"]
    eng = ServeEngine(pt, ct, slots=2, max_seq=64, speculate=3,
                      ticks_per_dispatch=2, spec_min_accept=0, device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=30))
    eng.submit(Request(uid=1, prompt=[9, 9, 9], max_new_tokens=30))
    eng.tick()
    first = eng._hist_dev
    assert first is not None
    eng.tick()
    assert eng._hist_dev is not None and eng._hist_dev is not first
    for s in range(2):
        upto = eng._ctx_len[s] + 1
        np.testing.assert_array_equal(eng._hist_dev[s, :upto].numpy(),
                                      eng._hist[s, :upto])
    eng.run_until_drained()
    _assert_reference(eng, pt, ct)


def test_spec_adaptive_fallback_and_its_probes(models):
    """A threshold above any real acceptance: once 32 windows are in, most
    dispatches are fused decodes, every 16th a speculative probe, and the
    tokens are those of an engine that always speculates."""
    _, ct, _, pt = models["qwen3-0.6b"]
    prompts = [[11 + 7 * i, 3 + i, 29] for i in range(4)]
    kw = dict(slots=2, max_seq=64, speculate=3, ticks_per_dispatch=2)
    eng, out = _drain(pt, ct, prompts, 24, spec_min_accept=0.99, **kw)
    s = eng.stats
    assert s["spec_fallback_dispatches"] > 0
    assert s["spec_windows"] > 0
    _assert_reference(eng, pt, ct)
    # the probe: with the fallback engaged, the 16th skipped dispatch
    # speculates
    probe = ServeEngine(pt, ct, spec_min_accept=0.99, device="cpu", **kw)
    probe._spec_recent.extend([0] * 32)
    picks = [probe._use_speculation() for _ in range(32)]
    assert picks == ([False] * 15 + [True]) * 2
    eng2, out2 = _drain(pt, ct, prompts, 24, spec_min_accept=0, **kw)
    assert eng2.stats["spec_fallback_dispatches"] == 0
    assert out2 == out


def test_speculate_rejects_sampled_configs(models):
    _, ct, _, pt = models["qwen3-0.6b"]
    with pytest.raises(NotImplementedError, match="(?i)rejection sampling"):
        ServeEngine(pt, ct, speculate=4, top_k=4, device="cpu")
    with pytest.raises(NotImplementedError, match="(?i)rejection sampling"):
        ServeEngine(pt, ct, speculate=4, temperature=0.8, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        ServeEngine(pt, ct, speculate=4, fused=False, device="cpu")
    with pytest.raises(ValueError, match="speculate"):
        ServeEngine(pt, ct, speculate=-1, device="cpu")


def test_geometry_errors_name_the_value(models):
    _, ct, _, pt = models["qwen3-0.6b"]
    for kw, pattern in (
            (dict(page_size=5), r"page_size=5.*max_seq=64"),
            (dict(page_size=4, prefill_chunk_len=6),
             r"prefill_chunk_len=6.*page_size=4"),
            (dict(page_size=4, prefill_chunk_len=24),
             r"prefill_chunk_len=24.*max_seq=64"),
            (dict(page_size=4, pool_pages=3), r"pool_pages=3")):
        with pytest.raises(ValueError, match=pattern):
            ServeEngine(pt, ct, max_seq=64, speculate=2, device="cpu", **kw)


def test_launch_serve_speculates_and_checks_reference_parity(capsys,
                                                             monkeypatch):
    from repro_torch.launch import serve as launch

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
        "--speculate", "0", "--verify-parity", "--requests", "4",
        "--new-tokens", "8", "--slots", "2", "--max-seq", "32"])
    launch.main()
    out = capsys.readouterr().out
    assert "speculation: draft_len=" in out
    assert "reference parity: ok (4 requests)" in out


# ---------------------------------------------------------------------------
# (d) the verify entries' walks (CPU emulations of the CUDA kernels)
# ---------------------------------------------------------------------------

INT32_MAX = 2 ** 31 - 1
NEG_INF = -1e30
LN2, LOG2E = math.log(2.0), 1.0 / math.log(2.0)


def _online_log2(st, x, ok, v, p_bf16):
    """One 16-key step of the cluster walks' online softmax in the log2
    domain: a masked key (``ok`` False) weighs 0 outright; with ``p_bf16``
    the weights are rounded to bf16 for the value product."""
    m, l, acc = st
    m_new = torch.maximum(m, torch.where(ok, x, NEG_INF).max(-1).values)
    p = torch.where(ok, torch.exp2(x - m_new[:, None]), 0.0)
    alpha = torch.exp2(m - m_new)
    pv = (p.bfloat16().float() if p_bf16 else p) @ v
    return m_new, l * alpha + p.sum(-1), acc * alpha[:, None] + pv


def _merge_natural(states):
    """States (m in natural units, l, acc) merged in the order given:
    the kernels' warp and rank merges.  Returns (m, l, acc)."""
    m = torch.stack([st[0] for st in states]).max(0).values
    w = [torch.exp(st[0] - m) for st in states]
    return (m, sum(st[1] * wi for st, wi in zip(states, w)),
            sum(st[2] * wi[:, None] for st, wi in zip(states, w)))


def verify_cluster_ranges(length, w, window, wp):
    """csrc/paged_decode.cu's verify key ranges: the slot's [lo, hi) from
    its first row's window start to its last row's causal limit, and each
    position t's own [rlo, rhi) and whether it is uniform (a window wholly
    past the table: the whole table, scored 0; then the slot's range is the
    whole table too)."""
    p = length + np.arange(w)
    rlo = np.minimum(np.maximum(p - window + 1, 0), wp)
    rhi = np.minimum(p + 1, wp)
    uni = rhi <= rlo
    rlo, rhi = np.where(uni, 0, rlo), np.where(uni, wp, rhi)
    if uni[-1]:
        return 0, wp, rlo, rhi, uni
    return int(max(length - window + 1, 0)), int(rhi[-1]), rlo, rhi, uni


def emulate_verify(q, kp, vp, bt, lens, *, window=None, logit_cap=None,
                   ranks=8, warps=4, stage_bytes=48 * (256 + 16)):
    """paged_verify_cluster (csrc/paged_decode.cu): per (slot, kv head) a
    cluster of ``ranks`` CTAs over the slot's W x G rows (row r = position
    t = r // G, head r % G, as one 16-row tile).  The slot's live keys
    [lo, hi) (``verify_cluster_ranges``: from lengths[b], as the kernel
    reads them on the device) in rank shares of ceil(n / ranks) rounded up
    to whole 16-key steps, a rank past them holding none; a rank's keys pass through shared memory in
    stages of ``stage_bytes`` of K (a multiple of 16 keys), warp w taking
    16-key steps w, w + warps, ... of each stage, each row masked at its
    own [rlo, rhi) with the softcap applied before the mask, the weights
    rounded to bf16 for the value product in bf16 (not in f32: the walk's
    arithmetic alone); the warps' states merge in warp order, then rank 0
    merges the live ranks' in rank order.  Returns the output and the live
    ranks of each slot."""
    b, w, hq, d = q.shape
    _, page, hkv, _ = kp.shape
    g, wp = hq // hkv, bt.shape[1] * page
    window = INT32_MAX if window is None else window
    scale_log2 = LOG2E / math.sqrt(d)
    p_bf16 = q.dtype == torch.bfloat16
    stage_keys = stage_bytes // (d * 2 + 16) // 16 * 16
    rows = w * g
    qf, kf, vf = q.float(), kp.float(), vp.float()
    out = torch.zeros(q.shape)
    lives = []
    for bi in range(b):
        lo, hi, rlo, rhi, uni = verify_cluster_ranges(int(lens[bi]), w,
                                                      window, wp)
        rlo, rhi, uni = (torch.from_numpy(np.repeat(x, g))
                         for x in (rlo, rhi, uni))
        n = hi - lo
        share = -(-(-(-n // ranks)) // 16) * 16
        live = -(-n // share) if share else 1
        lives.append(live)
        for h in range(hkv):
            qh = qf[bi, :, h * g:(h + 1) * g].reshape(rows, d)
            rank_states = []
            for r in range(live):
                r_lo = lo + r * share
                r_hi = min(hi, r_lo + share)
                warp_states = []
                for wi in range(warps):
                    st = (torch.full((rows,), NEG_INF), torch.zeros(rows),
                          torch.zeros(rows, d))
                    for s0 in range(r_lo, r_hi, stage_keys):
                        nk = min(stage_keys, r_hi - s0)
                        for j0 in range(wi * 16, nk, warps * 16):
                            pos = torch.arange(s0 + j0,
                                               s0 + min(j0 + 16, nk))
                            phys = bt[bi, pos // page].long()
                            sc = qh @ kf[phys, pos % page, h].T
                            if logit_cap is None:
                                x = sc * scale_log2
                            else:
                                x = (torch.tanh(sc * (scale_log2 / LOG2E)
                                                / logit_cap)
                                     * (logit_cap * LOG2E))
                            x = torch.where(uni[:, None], 0.0, x)
                            ok = ((pos[None] >= rlo[:, None])
                                  & (pos[None] < rhi[:, None]))
                            st = _online_log2(st, x, ok,
                                              vf[phys, pos % page, h],
                                              p_bf16)
                    warp_states.append((st[0] * LN2, st[1], st[2]))
                rank_states.append(_merge_natural(warp_states))
            _, l, acc = _merge_natural(rank_states)
            o = acc / l.clamp(min=1e-30)[:, None]
            out[bi, :, h * g:(h + 1) * g] = o.reshape(w, g, d)
    return out.to(q.dtype), lives


def _walk_case(dtype, seed, b=4, w=8, hq=16, hkv=8, d=64, page=16,
               width=24, lens=(0, 20, 130, 367)):
    """Pages of 16 over tables of 384 keys, lengths including an inactive
    slot, a window crossing a page, one reaching the last mapped page, and
    one whose keys span every rank."""
    rng = np.random.default_rng(seed)
    n_pool = b * width + 1
    bt = rng.permutation(n_pool - 1)[:b * width].reshape(b, width)
    q, kp, vp = (torch.from_numpy(_rand(rng, *s)).to(dtype) for s in
                 ((b, w, hq, d), (n_pool, page, hkv, d),
                  (n_pool, page, hkv, d)))
    return q, kp, vp, torch.from_numpy(bt.astype(np.int32)), \
        torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("kw", [{}, {"window": 40, "logit_cap": 5.0}])
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-5)])
def test_verify_walk_matches_plain(kw, dtype, atol):
    """The cluster walk at qwen3's verify geometry (G 2, W 8: the 16 rows
    of one tile) and at G 1 over W 3, against the plain version; at
    qwen3's, without a window every rank of the longest slot holds keys,
    and the inactive slot's range has one rank; without a window or softcap, against
    repro's Pallas prefill kernel vmapped over the slots in interpret mode
    too."""
    for hq, hkv, w in ((16, 8, 8), (4, 4, 3)):
        q, kp, vp, bt, lens = _walk_case(dtype, 3, hq=hq, hkv=hkv, w=w)
        got, lives = emulate_verify(q, kp, vp, bt, lens, **kw)
        assert lives[0] == 1 and (kw or lives[-1] == 8), lives
        want = ops.paged_verify_attention(q, kp, vp, bt, lens, **kw)
        close(got.float(), want.float().numpy(), atol)
        if not kw and dtype == torch.bfloat16:
            jq = [jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  for x in (q, kp, vp)]
            jwant = paged_verify_attention(
                *jq, jnp.asarray(bt.numpy()), jnp.asarray(lens.numpy()),
                use_kernel=True, interpret=True)
            close(got.float(), np.asarray(jwant, np.float32), atol)


# (lengths, window, softcap) over tables of 24 pages of 16 (384 keys): a
# window across a page (lower bounds 20 - 6 + 1 .. 27 - 6 + 1 straddle key
# 16), rows past the table (379 + t), a slot whose last rows' windows lie
# wholly past the table (382 + t - 2 + 1 >= 384 from t = 3: those rows
# uniform, the slot's range the whole table), one wholly past it
# (uniform), and gemma2's short window with its softcap
VERIFY_EDGE_CASES = [((0, 20, 379, 200), 6, None),
                     ((5, 382, 400, 100), 2, 30.0),
                     ((0, 17, 300, 383), 100, 50.0)]


@pytest.mark.parametrize("case", range(len(VERIFY_EDGE_CASES)))
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-5)])
def test_verify_walk_edges_match_plain(case, dtype, atol):
    """The cluster walk's per-row masks at the edges: windows across a
    page, rows past the table, rows whose window sees no key (the plain
    version's uniform mean over the whole table), at G 2, W 8, D 64 and
    gemma2-2b's D 256 (16 keys a stage)."""
    lens, window, cap = VERIFY_EDGE_CASES[case]
    d = 256 if case == 2 else 64
    q, kp, vp, bt, lens = _walk_case(dtype, 7 + case, d=d, lens=lens,
                                     hq=4, hkv=2)
    kw = {"window": window, "logit_cap": cap}
    got, _ = emulate_verify(q, kp, vp, bt, lens, **kw)
    want = ops.paged_verify_attention(q, kp, vp, bt, lens, **kw)
    close(got.float(), want.float().numpy(), atol)
    if case == 1:
        _, _, _, _, uni = verify_cluster_ranges(382, 8, 2, 384)
        assert uni.tolist() == [False] * 3 + [True] * 5


def emulate_latent_verify(q_lat, q_rope, ckv, kr, tables, lengths, *, scale,
                          ranks=2, rows_per_cta=64, tile=64):
    """The latent verify's cluster_kernel (csrc/paged_latent_wgmma.cuh):
    per (slot, 64-row block) of the slot's W x H rows (row r: position
    r // H, head r % H) a cluster of ``ranks`` CTAs; row r sees the keys
    [0, min(lengths[b] + r // H + 1, width * page)), the block's live keys
    those of its last row, in 64-key tiles, rank k taking tiles [k s,
    k s + s) with s = ceil(tiles / ranks); a rank past them walks nothing
    and leaves no state; each walk (``_wgmma_walk``) masks every row at its
    own limit; the live ranks' (m, l, acc) merge in rank order (log2
    domain).  bf16 rounds the weights for the value product, f32 does not.
    Returns (B, W, H, kv) and the live ranks of each block."""
    b, w, h, kv = q_lat.shape
    page, wp = ckv.shape[1], tables.shape[1] * ckv.shape[1]
    n_rows = w * h
    p_bf16 = q_lat.dtype == torch.bfloat16
    q = torch.cat([q_lat.float().reshape(b, n_rows, kv),
                   q_rope.float().reshape(b, n_rows, -1)], -1)
    ckf, krf = ckv.float(), kr.float()
    out = torch.zeros(b, n_rows, kv)
    lives = []
    for slot in range(b):
        for r0 in range(0, n_rows, rows_per_cta):
            rows = torch.arange(r0, min(r0 + rows_per_cta, n_rows))
            limit = torch.clamp(int(lengths[slot]) + rows // h + 1, max=wp)
            n = int(limit[-1])
            tiles = -(-n // tile)
            share = -(-tiles // ranks)
            states = []
            for rank in range(ranks):
                lo = min(rank * share * tile, n)
                hi = min(n, lo + share * tile)
                if hi > lo:
                    states.append(_wgmma_walk(
                        q[slot, rows], ckf, krf, tables[slot], lo, hi,
                        torch.clamp(limit, max=hi), scale, tile,
                        p_bf16=p_bf16))
            lives.append(len(states))
            mm = torch.stack([st[0] for st in states]).max(0).values
            ll = torch.zeros(len(rows))
            acc = torch.zeros(len(rows), kv)
            for m, l, a in states:     # rank order
                wt = torch.exp2(m - mm)
                ll = ll + l * wt
                acc = acc + a * wt[:, None]
            out[slot, rows] = acc / ll.clamp(min=1e-30)[:, None]
    return out.reshape(b, w, h, kv).to(q_lat.dtype), lives


@pytest.mark.parametrize("ranks", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype,atol", [(torch.bfloat16, 2e-2),
                                        (torch.float32, 1e-5)])
def test_latent_verify_walks_match_plain(ranks, dtype, atol):
    """paged_latent_verify's cluster walk (kv_lora 64 and qk_rope 16
    standing for 512 and 64, pages of 64, W 4 x H 40: blocks straddling
    positions and a block of the next slot's rows past the last) at each
    rank count paged_bench times, over a slot of length 0, a window across
    a page (60 .. 63 + 1) and a slot whose keys span every rank and whose
    rows run past the table (1022 + t over 1,024 keys), against the plain
    version; in f32 also the 16-row family with each slot's rows limited at
    lens[b] + r / H + 1."""
    rng = np.random.default_rng(5)
    lens = [0, 60, 300, 1022]
    b, w, h, page, width = len(lens), 4, 40, 64, 16
    n_pool = b * width + 1
    bt = torch.from_numpy(rng.permutation(n_pool - 1)[:b * width]
                          .reshape(b, width).astype(np.int32))
    lens_t = torch.tensor(lens, dtype=torch.int32)
    ql, qr = (torch.from_numpy(_rand(rng, b, w, h, f)).to(dtype)
              for f in (64, 16))
    ck, kr = (torch.from_numpy(_rand(rng, n_pool, page, f)).to(dtype)
              for f in (64, 16))
    scale = 1 / math.sqrt(80)
    got, lives = emulate_latent_verify(ql, qr, ck, kr, bt, lens_t,
                                       scale=scale, ranks=ranks)
    # 160 rows: blocks of rows 0..63, 64..127, 128..159 a slot; the last
    # slot's 16 tiles span every rank
    assert lives[:3] == [1, 1, 1]
    assert lives[6:9] == [-(-5 // -(-5 // ranks))] * 3
    assert lives[9:] == [ranks] * 3
    want = ops.paged_latent_verify_attention(ql, qr, ck, kr, bt, lens_t,
                                             scale=scale)
    close(got.float(), want.float().numpy(), atol)
    if dtype == torch.float32 and ranks == 1:
        got = emulate_latent(ql.reshape(b, w * h, 64),
                             qr.reshape(b, w * h, 16), ck, kr, bt,
                             lambda s, r: lens[s] + r // h + 1, scale=scale)
        close(got, want.reshape(b, w * h, 64).numpy(), 1e-5)


def test_latent_decode_walk_of_a_zero_length_slot_matches_plain():
    """Kernel 3's 16-row families: a slot of length 0 walks its whole
    table with every score 0, the plain version's uniform mean."""
    rng = np.random.default_rng(6)
    b, h, page, width = 3, 4, 16, 4
    bt = torch.from_numpy(rng.permutation(b * width).reshape(b, width)
                          .astype(np.int32))
    ql, qr = (torch.from_numpy(_rand(rng, b, 1, h, f)) for f in (16, 8))
    ck, kr = (torch.from_numpy(_rand(rng, b * width + 1, page, f))
              for f in (16, 8))
    lens = torch.tensor([0, 30, 0], dtype=torch.int32)
    got = emulate_latent(ql[:, 0], qr[:, 0], ck, kr, bt,
                         lambda s, r: int(lens[s]), scale=LATENT_SCALE,
                         uniform=(0, 2))
    want = ops.paged_latent_decode_attention(ql, qr, ck, kr, bt, lens,
                                             scale=LATENT_SCALE)
    close(got[:, None], want.numpy(), 1e-5)
