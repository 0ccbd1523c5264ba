"""The port's paged model and serving engine against ``repro``'s, with the
same weights (``repro.models.init_params``, converted by
``repro_torch.convert.from_jax``), on the CPU.

Reduced configs with UNTIED embeddings, as ``tests/test_serve.py`` uses:
with tied embeddings a random-init decoder echoes its last token, which
would let a broken cache path pass.  Tolerances: model logits and page
pools in float32 agree to atol 1e-4 (two frameworks, different summation
orders through the layers); tokens and block tables agree exactly, and
the port's fused decode equals its single ticks bitwise.
"""
import ast
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro_torch import configs as tcfg
from repro_torch import models as tmodels
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.paging import init_pool, paco_page_size
from torch_parity import close, models, pools_jax, reference, serve  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# model: paged prefill and decode against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b",
                                  "deepseek-v2-236b", "olmoe-1b-7b"])
def test_prefill_chunks_match_jax(models, arch):
    """Two page-aligned chunks of one slot (the second at start 8 over past
    pages and stale ones); gemma2 adds a window, softcaps and post-norms;
    deepseek-v2 writes and reads the latent c_kv/k_rope pools and routes
    through MoE, as olmoe does."""
    cj, ct, pj, pt = models[arch]
    page, chunk = 4, 8
    pools_t = init_pool(tmodels.paged_cache_leaf_specs(ct, page), 6, page,
                        "cpu").pools
    next(iter(pools_t.values())).normal_(
        generator=torch.Generator().manual_seed(1))
    pools_j = pools_jax(pools_t)
    row = np.array([3, 0, 5, 1], np.int32)
    rng = np.random.default_rng(0)
    for start in (0, chunk):
        toks = rng.integers(0, cj.vocab, size=(1, chunk)).astype(np.int32)
        lt, pools_t = tmodels.prefill_chunk(pt, ct, torch.from_numpy(toks),
                                            start, pools_t,
                                            torch.from_numpy(row))
        lj, pools_j = jmodels.prefill_chunk(pj, cj, jnp.asarray(toks),
                                            jnp.asarray(start, jnp.int32),
                                            pools_j, jnp.asarray(row))
        close(lt, lj)
        for name in pools_t:
            close(pools_t[name], pools_j[name])


def _admitted_engine(pt, ct, **kw):
    eng = ServeEngine(pt, ct, slots=2, max_seq=32, page_size=4,
                      prefill_chunk_len=8, device="cpu", **kw)
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=20))
    eng.submit(Request(uid=1, prompt=[5, 6, 7, 8, 9], max_new_tokens=20))
    eng._admit()
    eng._ensure_decode_pages(4)
    return eng


def test_decode_ticks_equal_single_ticks_and_jax(models):
    """decode_ticks(n=4) == four decode_step_paged ticks with host argmax,
    bitwise (torch against torch); its tokens equal JAX decode_ticks' and
    its pools agree with JAX's from the same pool state."""
    cj, ct, pj, pt = models["qwen3-0.6b"]
    eng = _admitted_engine(pt, ct)
    bt = eng.tables.device_view(eng.pages_per_seq)
    toks0 = torch.tensor(eng._last_tok, dtype=torch.int32)
    lens0 = torch.tensor(eng._ctx_len, dtype=torch.int32)
    start = {k: v.clone() for k, v in eng.pool.pools.items()}

    pools_a = {k: v.clone() for k, v in start.items()}
    cur, lens, got = toks0[:, None], lens0, []
    for _ in range(4):
        logits, pools_a = tmodels.decode_step_paged(pt, ct, cur, pools_a, bt,
                                                    lens)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        got.append(nxt)
        cur, lens = nxt[:, None], lens + 1

    pools_b = {k: v.clone() for k, v in start.items()}
    ones = torch.ones(2, dtype=torch.bool)
    budget = torch.full((2,), 100, dtype=torch.int32)
    eos = torch.full((2,), -1, dtype=torch.int32)
    block, pools_b = tmodels.decode_ticks(pt, ct, toks0, pools_b, bt, lens0,
                                          ones, budget, eos, 4,
                                          max_seq=eng.max_seq)
    assert torch.equal(block, torch.stack(got))
    for name in start:
        assert torch.equal(pools_a[name], pools_b[name])

    block_j, pools_j = jmodels.decode_ticks(
        pj, cj, jnp.asarray(toks0.numpy()), pools_jax(start),
        jnp.asarray(bt.numpy()), jnp.asarray(lens0.numpy()),
        jnp.ones((2,), bool), jnp.full((2,), 100, jnp.int32),
        jnp.full((2,), -1, jnp.int32), jnp.zeros((4, 2), jnp.uint32),
        max_seq=eng.max_seq)
    np.testing.assert_array_equal(block.numpy(), np.asarray(block_j))
    for name in start:
        close(pools_b[name], pools_j[name])


def test_decode_ticks_retire_like_emit(models):
    """Budget 2 for slot 0 and an eos for slot 1: the device flags stop
    each slot where the engine's _emit rule does (-1 filler after)."""
    _, ct, _, pt = models["qwen3-0.6b"]
    eng = _admitted_engine(pt, ct)
    bt = eng.tables.device_view(eng.pages_per_seq)
    toks0 = torch.tensor(eng._last_tok, dtype=torch.int32)
    lens0 = torch.tensor(eng._ctx_len, dtype=torch.int32)
    pools = {k: v.clone() for k, v in eng.pool.pools.items()}
    free, _ = tmodels.decode_ticks(
        pt, ct, toks0, pools, bt, lens0, torch.ones(2, dtype=torch.bool),
        torch.full((2,), 100, dtype=torch.int32),
        torch.full((2,), -1, dtype=torch.int32), 4, max_seq=eng.max_seq)
    eos1 = int(free[1, 1])
    pools = {k: v.clone() for k, v in eng.pool.pools.items()}
    block, _ = tmodels.decode_ticks(
        pt, ct, toks0, pools, bt, lens0, torch.ones(2, dtype=torch.bool),
        torch.tensor([2, 100], dtype=torch.int32),
        torch.tensor([-1, eos1], dtype=torch.int32), 4, max_seq=eng.max_seq)
    assert block[:2, 0].tolist() == free[:2, 0].tolist()
    assert block[2:, 0].tolist() == [-1, -1]
    assert block[:2, 1].tolist() == free[:2, 1].tolist()
    assert block[2:, 1].tolist() == [-1, -1]


# ---------------------------------------------------------------------------
# engine: tokens equal repro's reference decode
# ---------------------------------------------------------------------------

UNEQUAL = (dict(slots=3, max_seq=64, prefill_chunk_len=8),
           [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [3, 1], [9] * 12,
            [2, 4, 6, 8], [13]], 6)


def test_engine_matches_reference_decode_unequal_prompts(models):
    """Prompts of different lengths sharing slots and the page pool; more
    requests than slots, so admission waits mid-flight."""
    cj, ct, pj, pt = models["qwen3-0.6b"]
    kw, prompts, max_new = UNEQUAL
    eng, done = serve(pt, ct, kw, prompts, max_new)
    assert len(done) == len(prompts)
    assert eng.pool.free_count() == eng.pool.n_pages
    for r in done:
        assert r.out == reference(pj, cj, r, eng.max_seq), r.uid


def test_preemption_resumes_identically(models):
    """Pool too small for two full sequences: the youngest request is
    evicted, re-queued, re-prefilled, and still emits the reference
    continuation; the block-table invariants hold after every tick."""
    cj, ct, pj, pt = models["qwen3-0.6b"]
    eng = ServeEngine(pt, ct, slots=2, max_seq=32, page_size=4,
                      pool_pages=10, prefill_chunk_len=8, device="cpu")
    for i, p in enumerate([[1, 2, 3, 4, 5], [7, 8, 9], [11, 12]]):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=20))
    while eng.queue or any(eng.active):
        eng.tick()
        eng.check_page_invariants()
    assert eng.stats["preemptions"] >= 1
    assert any(r.preemptions > 0 for r in eng.done)
    assert eng.pool.free_count() == eng.pool.n_pages
    for r in eng.done:
        assert r.out == reference(pj, cj, r, 32), r.uid


def test_engine_topk_sampling_is_seeded_and_respects_retirement(models):
    """Top-k on the device sampler: same seed, same tokens; every request
    gets its budget, tokens stay in the vocab, pages all come back."""
    _, ct, _, pt = models["qwen3-0.6b"]
    outs = []
    for seed in (3, 3, 4):
        eng = ServeEngine(pt, ct, slots=2, max_seq=32, page_size=4,
                          top_k=4, temperature=1.5, seed=seed, device="cpu")
        for i, p in enumerate([[1, 2, 3], [5, 6], [7]]):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=6))
        done = sorted(eng.run_until_drained(), key=lambda r: r.uid)
        assert [len(r.out) for r in done] == [6, 6, 6]
        assert all(0 <= t < ct.vocab for r in done for t in r.out)
        assert eng.pool.free_count() == eng.pool.n_pages
        outs.append([r.out for r in done])
    assert outs[0] == outs[1] != outs[2]


# ---------------------------------------------------------------------------
# MLA latent paging (deepseek-v2) and MoE (olmoe)
# ---------------------------------------------------------------------------

def test_mla_decode_tick_logits_and_pools_match_jax(models):
    """Reduced deepseek-v2: one decode tick's logits and the latent pools
    it writes (one row per slot at (write_page, write_off)) against JAX
    from the same pool state; then four fused ticks emit JAX's tokens."""
    cj, ct, pj, pt = models["deepseek-v2-236b"]
    eng = _admitted_engine(pt, ct)
    assert set(eng.pool.pools) == {"c_kv", "k_rope"}
    bt = eng.tables.device_view(eng.pages_per_seq)
    toks0 = torch.tensor(eng._last_tok, dtype=torch.int32)
    lens0 = torch.tensor(eng._ctx_len, dtype=torch.int32)
    start = {k: v.clone() for k, v in eng.pool.pools.items()}
    pools_t = {k: v.clone() for k, v in start.items()}
    lt, pools_t = tmodels.decode_step_paged(pt, ct, toks0[:, None], pools_t,
                                            bt, lens0)
    lj, pools_j = jmodels.decode_step_paged(
        pj, cj, jnp.asarray(toks0.numpy()[:, None]), pools_jax(start),
        jnp.asarray(bt.numpy()), jnp.asarray(lens0.numpy()))
    close(lt, lj)
    for name in start:
        close(pools_t[name], pools_j[name])
        assert not torch.equal(pools_t[name], start[name])
    ones = torch.ones(2, dtype=torch.bool)
    block, _ = tmodels.decode_ticks(
        pt, ct, toks0, {k: v.clone() for k, v in start.items()}, bt, lens0,
        ones, torch.full((2,), 100, dtype=torch.int32),
        torch.full((2,), -1, dtype=torch.int32), 4, max_seq=eng.max_seq)
    block_j, _ = jmodels.decode_ticks(
        pj, cj, jnp.asarray(toks0.numpy()), pools_jax(start),
        jnp.asarray(bt.numpy()), jnp.asarray(lens0.numpy()),
        jnp.ones((2,), bool), jnp.full((2,), 100, jnp.int32),
        jnp.full((2,), -1, jnp.int32), jnp.zeros((4, 2), jnp.uint32),
        max_seq=eng.max_seq)
    np.testing.assert_array_equal(block.numpy(), np.asarray(block_j))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "olmoe-1b-7b"])
def test_mla_and_moe_engines_match_reference_decode(models, arch):
    """Unequal prompts sharing slots and pages, more requests than slots:
    the latent-paged MLA engine (deepseek-v2, MLA + MoE) and the MoE
    engine (olmoe) emit reference_decode's tokens."""
    cj, ct, pj, pt = models[arch]
    kw, prompts, max_new = UNEQUAL
    eng, done = serve(pt, ct, kw, prompts, max_new)
    assert len(done) == len(prompts)
    assert eng.pool.free_count() == eng.pool.n_pages
    for r in done:
        assert r.out == reference(pj, cj, r, eng.max_seq), r.uid


def test_mla_latent_preemption_resumes_identically(models):
    """A prime pool of 11 latent pages for 3 slots: the youngest request
    is evicted, re-prefilled (latents recomputed from prompt + generated)
    and still emits the reference continuation."""
    cj, ct, pj, pt = models["deepseek-v2-236b"]
    eng = ServeEngine(pt, ct, slots=3, max_seq=32, page_size=4,
                      pool_pages=11, prefill_chunk_len=8, device="cpu")
    for i, p in enumerate([[1, 2, 3, 4, 5], [7, 8, 9], [11, 12]]):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=16))
    while eng.queue or any(eng.active):
        eng.tick()
        eng.check_page_invariants()
    assert eng.stats["preemptions"] >= 1
    assert eng.pool.free_count() == eng.pool.n_pages
    for r in eng.done:
        assert r.out == reference(pj, cj, r, 32), r.uid


def test_mla_engine_chooses_latent_page_geometry(models):
    """The page is planned on the (slots x seq x kv_lora) cuboid, as
    repro's engine plans it; the pools are the head-free latent leaves,
    whose bytes per position at full width are under 2% of dense KV."""
    from repro.serve import ServeEngine as JaxEngine

    cj, ct, pj, pt = models["deepseek-v2-236b"]
    m = ct.mla
    for slots, max_seq in ((2, 16), (3, 64)):
        eng = ServeEngine(pt, ct, slots=slots, max_seq=max_seq,
                          device="cpu")
        assert eng.page == paco_page_size(slots, max_seq, m.kv_lora)
        assert eng.page == JaxEngine(pj, cj, slots=slots,
                                     max_seq=max_seq).page
        n = eng.pool.n_pages + 1
        assert eng.pool.pools["c_kv"].shape == (ct.n_layers, n, eng.page,
                                                m.kv_lora)
        assert eng.pool.pools["k_rope"].shape == (ct.n_layers, n, eng.page,
                                                  m.qk_rope)
    full = tcfg.get_arch("deepseek-v2-236b")
    specs = tmodels.paged_cache_leaf_specs(full, 128)
    latent = sum(math.prod(s.shape) for s in specs.values()) / 128
    fm = full.mla
    dense = full.n_layers * full.n_heads * (fm.qk_nope + fm.qk_rope
                                            + fm.v_head)
    assert latent * 50 < dense
    assert paco_page_size(8, 2048, fm.kv_lora) == 128


def test_launch_serve_runs_on_the_cpu(capsys, monkeypatch):
    from repro_torch.launch import serve as launch

    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
        "--requests", "3", "--new-tokens", "3", "--slots", "2"])
    launch.main()
    out = capsys.readouterr().out
    assert "device=cpu" in out and "served 3 requests, 9 tokens" in out


def test_engine_rejects_what_it_does_not_serve(models):
    _, ct, _, pt = models["qwen3-0.6b"]
    # the engine serves on a mesh now (tests/test_torch_spmd.py); a mesh
    # without a process group is refused
    with pytest.raises(RuntimeError, match="no process group"):
        ServeEngine(pt, ct, device="cpu", mesh=object())
    eng = ServeEngine(pt, ct, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(Request(uid=0, prompt=[], max_new_tokens=2))
    with pytest.raises(ValueError):
        eng.submit(Request(uid=0, prompt=[1], max_new_tokens=0))
    # the ssm family has weights and a dense-state decode, but no paged
    # serving (nor has repro)
    cm = tcfg.get_arch("mamba2-780m").reduced()
    with pytest.raises(NotImplementedError):
        ServeEngine(tmodels.init_params(cm, device="cpu"), cm, device="cpu")


@pytest.mark.parametrize("kw", [{"speculate": 2}, {"fused": False}])
def test_engine_serves_speculation_and_the_single_tick_loop(models, kw):
    """``speculate`` and ``fused=False``, which the engine once refused,
    serve and emit the fused engine's tokens."""
    _, ct, _, pt = models["qwen3-0.6b"]
    prompts = [[1, 2, 3, 1, 2, 3], [5, 6, 7], [9, 9, 9, 9]]
    outs = [[r.out for r in serve(pt, ct, dict(slots=2, max_seq=32, **k),
                                  prompts, 10)[1]] for k in ({}, kw)]
    assert outs[0] == outs[1]


def test_default_device_is_cuda_and_raises_without_a_card(models):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    _, ct, _, pt = models["qwen3-0.6b"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(pt, ct)


def test_port_imports_neither_jax_nor_repro():
    """AST scan of every module of the port and of chip_smoke.py."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{f.relative_to(ROOT)}: {n}")
    assert not bad, bad
