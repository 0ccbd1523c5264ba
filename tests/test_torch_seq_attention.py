"""Sequence-parallel attention (``repro.models.layers.attention``'s cut of
the key sequence) in the port, on the CPU, in one process: the key-block
entries' plain versions (``ref.attention_block_ref`` and
``attention_block_ref_grad``, what the wrappers take on a CPU tensor) and
the merge (``attention.seq_attention``) over p = 1, 2, 3, 5 and 16 blocks
of one key sequence, the reduction summing over the list of blocks, held
to JAX's unmeshed ``repro.models.layers.attention`` (forward, and
``jax.grad``'s q/k/v gradients) and to the port's plain
``models.layers.attention`` (autograd) on the same numpy inputs; CPU
emulations of the CUDA kernels' key-block walks
(``test_torch_flash_attention``'s ``emulate_fwd`` / ``emulate_bwd`` with
an offset) merged the same way; the work formula per block; the entries on
fake tensors.  The meshed path (a 5-rank gloo group) is in
``test_torch_spmd.py``, the dry-run's count of it in
``test_torch_launch.py``.

Tolerances (f32): the merge adds the blocks' partials in another order
than one softmax does, SEQ_ATOL on the output and SEQ_GRAD_ATOL on each
gradient against both references; at p = 1 the forward is bitwise the
port's plain path.  The tensor-core walks round the softmax weights to
bf16 as the kernels do: 2e-2 of max(1, max |plain|), chip_smoke.py's
FLASH_TOL.  About 9 s of tests on one core, ~7 s of imports beside."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_flash_attention as FA
from repro.models import layers as JL
from repro_torch.kernels import work
from repro_torch.kernels.attention import attention as K
from repro_torch.kernels.attention import ref
from repro_torch.launch import cost, specs
from repro_torch.models import layers as TL

torch.set_num_threads(1)
SEQ_ATOL = 1e-5
SEQ_GRAD_ATOL = 1e-5
B, HQ, HKV, D = 2, 4, 2, 16
# (Sq, Sk, causal, window, softcap): causal, gemma2's window with its
# softcap (S 40 against a window of 16: rows see no key in most blocks),
# the window alone, and a non-causal cross-attention with Sq != Sk
CASES = {"causal": (40, 40, True, None, None),
         "window_softcap": (40, 40, True, 16, 50.0),
         "window": (40, 40, True, 16, None),
         "cross": (24, 40, False, None, None)}
BLOCKS = (1, 2, 3, 5, 16)


def _inputs(name):
    sq, sk = CASES[name][:2]
    rng = np.random.default_rng(sorted(CASES).index(name))
    draw = lambda *shape: rng.standard_normal(shape).astype(  # noqa: E731
        np.float32)
    return (draw(B, sq, HQ, D), draw(B, sk, HKV, D), draw(B, sk, HKV, D),
            draw(B, sq, HQ, D))


_REFS = {}


def _refs(name):
    """JAX's and the port's plain attention of a case: (output, q/k/v
    gradients of sum(out * d_o)), each once per module."""
    if name not in _REFS:
        sq, sk, causal, window, cap = CASES[name]
        q, k, v, d_o = _inputs(name)

        def jfn(q, k, v):
            return JL.attention(q, k, v, q_positions=jnp.arange(sq),
                                k_positions=jnp.arange(sk), causal=causal,
                                window=window, logit_cap=cap)

        jo, vjp = jax.vjp(jfn, q, k, v)
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        to = TL.attention(*leaves, q_positions=torch.arange(sq),
                          k_positions=torch.arange(sk), causal=causal,
                          window=window, logit_cap=cap)
        to.backward(torch.from_numpy(d_o))
        _REFS[name] = {
            "jax": (np.asarray(jo), [np.asarray(g) for g in vjp(d_o)]),
            "port": (to.detach(), [t.grad for t in leaves])}
    return _REFS[name]


def _split(sk, p):
    """Contiguous blocks of the Sk keys, as ``np.array_split`` cuts them
    (repro's blocks where p divides Sk): (offsets, lengths)."""
    parts = np.array_split(np.arange(sk), p)
    return [int(x[0]) for x in parts], [len(x) for x in parts]


@pytest.mark.parametrize("p", BLOCKS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_merged_blocks_match_jax_and_the_plain_path(name, p):
    sq, sk, causal, window, cap = CASES[name]
    q, k, v, d_o = _inputs(name)
    offs, lens = _split(sk, p)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = K.seq_attention(qt, list(torch.split(kt, lens, 1)),
                          list(torch.split(vt, lens, 1)), offs,
                          blocks=K.KeyBlocks(), causal=causal, window=window,
                          logit_cap=cap)
    out.backward(torch.from_numpy(d_o))
    refs = _refs(name)
    grads = [t.grad for t in (qt, kt, vt)]
    for who in ("jax", "port"):
        want_o, want_g = refs[who]
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                                   atol=SEQ_ATOL, rtol=0, err_msg=who)
        for got, want in zip(grads, want_g):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=SEQ_GRAD_ATOL, rtol=0,
                                       err_msg=who)
    if p == 1:
        assert torch.equal(out.detach(), refs["port"][0])


def test_rows_that_see_no_key_of_a_block_weigh_nothing():
    """A block past every row's window (and, causal, past the rows before
    it): O = 0 and lse = -inf there, and no NaN in the merge's output or
    gradients even where most blocks are empty for a row."""
    q, k, v, d_o = map(torch.from_numpy, _inputs("window"))
    o, lse = ref.attention_block_ref(q, k[:, 32:], v[:, 32:], k_off=32,
                                     causal=True, window=16)
    seen = torch.arange(40) >= 32          # rows 32.. see keys 32..
    assert torch.equal(o[:, ~seen], torch.zeros_like(o[:, ~seen]))
    assert torch.isinf(lse[..., ~seen]).all() and (lse[..., ~seen] < 0).all()
    assert torch.isfinite(lse[..., seen]).all()
    offs, lens = _split(40, 16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = K.seq_attention(leaves[0], list(torch.split(leaves[1], lens, 1)),
                          list(torch.split(leaves[2], lens, 1)), offs,
                          blocks=K.KeyBlocks(), window=16)
    out.backward(d_o)
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(t.grad).all() for t in leaves)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    q, k, v, d_o = map(torch.from_numpy, _inputs("window_softcap"))
    kw = dict(k_off=16, causal=True, window=16, logit_cap=50.0)
    o, lse = K.flash_attention_block(q, k[:, 16:32], v[:, 16:32], **kw)
    want = ref.attention_block_ref(q, k[:, 16:32], v[:, 16:32], **kw)
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
    assert o.dtype == torch.float32
    grads = K.flash_attention_block_bwd(q, k[:, 16:32], v[:, 16:32], q, lse,
                                        d_o, **kw)
    want = ref.attention_block_ref_grad(q, k[:, 16:32], v[:, 16:32], q, lse,
                                        d_o, **kw)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    assert K.flash_attention_block.launches == 0
    assert K.flash_attention_block_bwd.launches == 0
    with pytest.raises(ValueError):
        K.flash_attention_block(q, k, v, k_off=-1)


@pytest.mark.parametrize("sq,sk,causal,window", [
    (40, 40, True, None), (40, 40, True, 16), (24, 40, False, None),
    (4096, 4096, True, None), (8192, 8192, True, 4096)])
@pytest.mark.parametrize("p", [2, 5, 16])
def test_block_formulas_add_up_to_the_whole(sq, sk, causal, window, p):
    offs, lens = _split(sk, p)
    pairs = [work.visible_pairs(sq, n, causal, window, k_off=o)
             for o, n in zip(offs, lens)]
    assert sum(pairs) == work.visible_pairs(sq, sk, causal, window)
    # each block's closed form against a count row by row
    i = np.arange(sq)
    for o, n, got in zip(offs, lens, pairs):
        lo = np.maximum(o, i - (window or sq + sk) + 1)
        hi = np.minimum(o + n, i + 1) if causal else o + n
        assert got == int(np.maximum(hi - lo, 0).sum())
    flops = sum(work.flash_bwd_work(1, sq, n, 8, 4, 256, 2, causal=causal,
                                    window=window, k_off=o)[0]
                for o, n in zip(offs, lens))
    assert flops == work.flash_bwd_work(1, sq, sk, 8, 4, 256, 2,
                                        causal=causal, window=window)[0]
    # the block entries write O and dQ in f32
    whole = work.flash_fwd_work(1, sq, sk, 8, 4, 256, 2, causal=causal)[1]
    block = work.flash_fwd_work(1, sq, sk, 8, 4, 256, 2, causal=causal,
                                k_off=0)[1]
    assert block - whole == 2 * sq * 8 * 256


def test_rank0_share_of_gemma2s_cells():
    """Rank 0's pairs under repro's contiguous cut into 16 blocks: at
    train_4k (S 4096) 256 x 257 / 2 + 3840 x 256 of 8,390,656 (12.1%), at
    prefill_32k's local layers (window 4096) about 6.7%."""
    r0 = work.visible_pairs(4096, 256, True, None, k_off=0)
    assert r0 == 256 * 257 // 2 + 3840 * 256
    assert abs(r0 / work.visible_pairs(4096, 4096) - 0.121) < 1e-3
    local = work.visible_pairs(32768, 2048, True, 4096, k_off=0) / \
        work.visible_pairs(32768, 32768, True, 4096)
    assert abs(local - 0.067) < 1e-3


@pytest.mark.parametrize("walk", [FA.CUDA_CORES, FA.WGMMA256, FA.WGMMA],
                         ids=["cuda_cores", "wgmma_d256", "wgmma"])
@pytest.mark.parametrize("p,kw", [(2, dict(causal=True)),
                                  (5, dict(causal=True, window=9,
                                           logit_cap=5.0)),
                                  (3, dict(causal=False))])
def test_key_block_walks_merge_to_the_whole(walk, p, kw):
    """The kernels' walks with a key offset (``emulate_fwd`` /
    ``emulate_bwd`` at ``k_off``), one per block of 77 keys, merged as
    ``SeqAttention`` merges them: O, and dQ summed over the blocks with dK
    and dV concatenated, against ``ref.attention_ref`` and its gradient;
    every item of each launch taken once, and items whose key range is
    empty among them (their rows stored as zeros, lse -inf)."""
    rng = np.random.default_rng(p)
    s, g = 77, 2
    q, k, v, d_o = (torch.from_numpy(rng.standard_normal((B, s, h, D))
                                     .astype(np.float32))
                    for h in (HKV * g, HKV, HKV, HKV * g))
    if walk.mma:
        q, k, v, d_o = map(FA._bf16, (q, k, v, d_o))
    window = kw.get("window", 2 ** 31 - 1)
    cap = kw.get("logit_cap")
    offs, lens = _split(s, p)
    parts, visited = [], []
    for off, n in zip(offs, lens):
        kb, vb = k[:, off:off + n], v[:, off:off + n]
        parts.append(FA.emulate_fwd(q, kb, vb, causal=kw["causal"],
                                    window=window, cap=cap, walk=walk,
                                    visited=visited, k_off=off))
    assert len(visited) == p * -(-s // (walk.rows // g)) * HKV * B
    m = torch.stack([lse for _, lse in parts]).amax(0)
    w = [torch.exp(lse - m) for _, lse in parts]
    den = sum(w)
    o = sum(po * wi.transpose(1, 2)[..., None] for (po, _), wi in
            zip(parts, w)) / den.transpose(1, 2)[..., None]
    o = walk.round(o)
    lse = m + torch.log(den)
    if kw["causal"]:
        assert any(torch.isinf(pl).any() for _, pl in parts)
    grads = [FA.emulate_bwd(q, k[:, off:off + n], v[:, off:off + n], o, lse,
                            d_o, causal=kw["causal"], window=window, cap=cap,
                            walk=walk, k_off=off)
             for off, n in zip(offs, lens)]
    dq = walk.round(sum(gr[0] for gr in grads))
    dk = torch.cat([gr[1] for gr in grads], 1)
    dv = torch.cat([gr[2] for gr in grads], 1)
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    want_o = ref.attention_ref(*tr[:3], **kw).transpose(1, 2)
    want_g = [t.transpose(1, 2) for t in ref.attention_ref_grad(*tr, **kw)]
    tol = ((lambda w: 2e-2 * max(1.0, float(w.abs().max()))) if walk.mma
           else (lambda w: 2e-5))
    assert float((o - want_o).abs().max()) <= tol(want_o)
    for got, want in zip((dq, dk, dv), want_g):
        assert float((got - want).abs().max()) <= tol(want)


@pytest.mark.parametrize("p,kw", [(3, dict(causal=True, logit_cap=50.0)),
                                  (5, dict(causal=True, window=9,
                                           logit_cap=5.0))])
def test_key_block_walks_at_d256_merge_to_the_whole(p, kw):
    """The D-256 kernels' key-block walks (their tiles, split dK/dV pass
    and staged f32 epilogues) at gemma2-2b's true
    head_dim, one walk per block of 77 keys at its offset, merged as
    ``SeqAttention`` merges them: O and dQ summed over the blocks, dK and
    dV concatenated, against ``ref.attention_ref`` and its gradient."""
    rng = np.random.default_rng(256 + p)
    s, g, d, walk = 77, 2, 256, FA.WGMMA256
    q, k, v, d_o = (FA._bf16(torch.from_numpy(
        rng.standard_normal((1, s, h, d)).astype(np.float32)))
        for h in (HKV * g, HKV, HKV, HKV * g))
    window = kw.get("window", 2 ** 31 - 1)
    cap = kw.get("logit_cap")
    offs, lens = _split(s, p)
    parts = [FA.emulate_fwd(q, k[:, o:o + n], v[:, o:o + n],
                            causal=kw["causal"], window=window, cap=cap,
                            walk=walk, k_off=o)
             for o, n in zip(offs, lens)]
    m = torch.stack([lse for _, lse in parts]).amax(0)
    w = [torch.exp(lse - m) for _, lse in parts]
    o = walk.round(sum(po * wi.transpose(1, 2)[..., None] for (po, _), wi
                       in zip(parts, w)) / sum(w).transpose(1, 2)[..., None])
    lse = m + torch.log(sum(w))
    grads = [FA.emulate_bwd(q, k[:, off:off + n], v[:, off:off + n], o, lse,
                            d_o, causal=kw["causal"], window=window, cap=cap,
                            walk=walk, k_off=off)
             for off, n in zip(offs, lens)]
    got = (walk.round(sum(gr[0] for gr in grads)),
           torch.cat([gr[1] for gr in grads], 1),
           torch.cat([gr[2] for gr in grads], 1))
    tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
    want_o = ref.attention_ref(*tr[:3], **kw).transpose(1, 2)
    want_g = [t.transpose(1, 2) for t in ref.attention_ref_grad(*tr, **kw)]
    for a, b in zip((o, *got), (want_o, *want_g)):
        assert float((a - b).abs().max()) <= 2e-2 * max(
            1.0, float(b.abs().max()))


def test_block_entries_on_fake_tensors_record_their_formula():
    """On fake tensors (the dry-run's) the two entries allocate f32 O and
    dQ, record ``flash_fwd_block`` / ``flash_bwd_block`` by the block
    formula and launch nothing."""
    bf, f32 = torch.bfloat16, torch.float32
    with specs.fake_mode():
        e = lambda *shp, dt=bf: torch.empty(shp, dtype=dt)  # noqa: E731
        for name, call, (flops, nbytes) in [
                ("flash_fwd_block", lambda: K.flash_attention_block(
                    e(1, 64, 8, 256), e(1, 16, 4, 256), e(1, 16, 4, 256),
                    k_off=32, window=24),
                 work.flash_fwd_work(1, 64, 16, 8, 4, 256, 2, window=24,
                                     k_off=32)),
                ("flash_bwd_block", lambda: K.flash_attention_block_bwd(
                    e(1, 64, 8, 256), e(1, 16, 4, 256), e(1, 16, 4, 256),
                    e(1, 64, 8, 256), e(1, 8, 64, dt=f32), e(1, 64, 8, 256),
                    k_off=32),
                 work.flash_bwd_work(1, 64, 16, 8, 4, 256, 2, k_off=32))]:
            with cost.StepCounters() as c:
                out = call()
            assert all(work.is_fake(o) for o in out), name
            assert out[0].dtype == f32, name
            assert c.kernel_calls == {name: 1}, name
            assert c.flops.kernel_flops[name] == flops, name
            assert c.bytes.kernel_bytes[name] == nbytes, name
    assert K.flash_attention_block.launches == 0
    assert K.flash_attention_block_bwd.launches == 0


def test_head_names_cut_the_keys_where_no_head_count_divides():
    """The cut under a (1, 5) mesh (sizes only): gemma2-2b reduced (4 query
    heads, 2 KV heads) cuts its 40 keys, not 42; a model axis that divides
    Hkv or Hq cuts heads."""
    from repro_torch.dist import act_sharding as act

    with act.use_mesh_rules({"data": 1, "model": 5}):
        assert TL.head_names(4, 2, 40) == (("dp", None, None, None),
                                           ("dp", "model", None, None),
                                           "keys")
        assert TL.head_names(4, 2, 42)[2] == "whole"
        assert TL.head_names(10, 5, 40)[2] == "heads"
        assert TL.head_names(10, 2, 40)[2] == "repeat"

