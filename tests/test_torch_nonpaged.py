"""The port's non-paged cache path against ``repro`` on the CPU: the
decode attentions over a dense cache (``layers.decode_attention`` and
``latent_decode_attention``), ``layers.attention`` with Sq != Sk (the
cross-attention the flash kernel now takes), and the decoder's
``prefill_decoder`` / ``decode_step_decoder`` (dense GQA with gemma2's
windows and softcaps, and the MLA latent) through ``models.prefill`` and
``decode_step``, every cache leaf included.  Torch against torch: the
non-paged decode equals the paged ``decode_step_paged`` on the same
weights and prompts, and the absorbed MLA decode equals the uncompressed
``serve.reference.mla_materialized_qkv`` (``tests/test_models.py:114``'s
invariant).

Reduced, untied configs and weights from ``tests/torch_parity.py``; inputs
drawn by numpy from a seed.  Tolerance 1e-4, float32 throughout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.models import layers as JL
from repro_torch import models as tmodels
from repro_torch.kernels.attention import ref
from repro_torch.models import layers as TL
from repro_torch.models.transformer import _layer
from repro_torch.serve.paging import init_pool
from torch_parity import ATOL, close, models  # noqa: F401  (fixture)

torch.set_num_threads(1)


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


def _rand(rng, *shape):
    return _pair(rng.standard_normal(shape).astype(np.float32))


# ---------------------------------------------------------------------------
# the attention functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv,window,cap", [
    (4, 4, None, None), (8, 2, None, None), (8, 2, 5, None),
    (6, 3, 3, 7.0)])
def test_decode_attention_matches_jax(hq, hkv, window, cap):
    """Grouped (G = Hq / Hkv up to 4) decode over a padded cache: lengths
    0 (the uniform mean of a wholly masked row), 1, mid and full; a window
    and a softcap."""
    rng = np.random.default_rng(hq * 10 + hkv)
    b, s, d = 4, 11, 8
    qj, qt = _rand(rng, b, 1, hq, d)
    kj, kt = _rand(rng, b, s, hkv, d)
    vj, vt = _rand(rng, b, s, hkv, d)
    lj, lt = _pair(np.array([0, 1, 6, s], np.int32))
    got = TL.decode_attention(qt, kt, vt, lengths=lt, window=window,
                              logit_cap=cap)
    want = JL.decode_attention(qj, kj, vj, lengths=lj, window=window,
                               logit_cap=cap)
    assert got.shape == (b, 1, hq, d)
    close(got, want)


def test_latent_decode_attention_matches_jax():
    rng = np.random.default_rng(3)
    b, s, h, kv, rope = 3, 9, 5, 16, 4
    qlj, qlt = _rand(rng, b, 1, h, kv)
    qrj, qrt = _rand(rng, b, 1, h, rope)
    cj, ct = _rand(rng, b, s, kv)
    krj, krt = _rand(rng, b, s, rope)
    lj, lt = _pair(np.array([1, 5, s], np.int32))
    got = TL.latent_decode_attention(qlt, qrt, ct, krt, lengths=lt,
                                     scale=0.3)
    close(got, JL.latent_decode_attention(qlj, qrj, cj, krj, lengths=lj,
                                          scale=0.3))


@pytest.mark.parametrize("sq,sk", [(5, 13), (13, 5), (40, 24)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_with_its_own_key_length_matches_jax(sq, sk, causal):
    """``layers.attention`` at Sq != Sk (positions from 0 on both sides):
    the chunked plain version (query chunks of 16) and the kernel lowering
    (on the CPU its plain version, ``ref.attention_ref``) against
    ``repro``'s chunked attention."""
    rng = np.random.default_rng(sq * 100 + sk)
    qj, qt = _rand(rng, 2, sq, 4, 8)
    kj, kt = _rand(rng, 2, sk, 2, 8)
    vj, vt = _rand(rng, 2, sk, 2, 8)
    want = JL.attention(qj, kj, vj, q_positions=jnp.arange(sq),
                        k_positions=jnp.arange(sk), causal=causal,
                        q_chunk=16)
    for use_kernel in (False, True):
        got = TL.attention(qt, kt, vt, q_positions=torch.arange(sq),
                           k_positions=torch.arange(sk), causal=causal,
                           q_chunk=16, use_kernel=use_kernel)
        close(got, want)


# ---------------------------------------------------------------------------
# prefill and decode on the dense cache
# ---------------------------------------------------------------------------

PROMPT, MAX_SEQ, STEPS = 8, 16, 4


def _prompts(vocab, b=2, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, PROMPT + STEPS))
    return _pair(toks.astype(np.int32))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b",
                                  "deepseek-v2-236b"])
def test_prefill_and_decode_match_jax(models, arch):
    """``models.prefill`` over the prompts, then teacher-forced
    ``decode_step``s: logits, lengths and every cache leaf against
    ``repro``'s (gemma2: windows of 16 on alternate layers, softcaps;
    deepseek-v2: the latent cache and MoE)."""
    cj, ct, pj, pt = models[arch]
    tj, tt = _prompts(cj.vocab)
    assert {k: tuple(v.shape) for k, v in
            tmodels.cache_spec(ct, 2, MAX_SEQ).items()} == {
        k: v.shape for k, v in jmodels.cache_spec(cj, 2, MAX_SEQ).items()}
    lg_j, cache_j, len_j = jmodels.prefill(
        pj, cj, {"tokens": tj[:, :PROMPT]}, max_seq=MAX_SEQ)
    lg_t, cache_t, len_t = tmodels.prefill(
        pt, ct, {"tokens": tt[:, :PROMPT]}, MAX_SEQ)
    for t in range(STEPS + 1):
        close(lg_t, lg_j)
        assert set(cache_t) == set(cache_j)
        for k in cache_j:
            close(cache_t[k], cache_j[k])
        assert torch.equal(len_t, torch.from_numpy(np.array(len_j)))
        if t == STEPS:
            break
        tok = slice(PROMPT + t, PROMPT + t + 1)
        lg_j, cache_j, len_j = jmodels.decode_step(pj, cj, tj[:, tok],
                                                   cache_j, len_j)
        lg_t, cache_t, len_t = tmodels.decode_step(pt, ct, tt[:, tok],
                                                   cache_t, len_t)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_nonpaged_decode_equals_paged_decode(models, arch):
    """The same prompts through the paged path (one page-aligned chunk per
    slot, then ``decode_step_paged`` ticks) and the dense-cache path: the
    same logits within ATOL at every step, and the same greedy tokens
    wherever the top-2 margin exceeds ATOL."""
    _, ct, _, pt = models[arch]
    page, b = 4, 2
    _, prompts = _prompts(ct.vocab, b, seed=1)
    pages = init_pool(tmodels.paged_cache_leaf_specs(ct, page),
                      b * MAX_SEQ // page, page, "cpu").pools
    tables = torch.arange(b * MAX_SEQ // page, dtype=torch.int32).reshape(
        b, MAX_SEQ // page)
    last = []
    for i in range(b):
        lg, pages = tmodels.prefill_chunk(pt, ct, prompts[i:i + 1, :PROMPT],
                                          0, pages, tables[i])
        last.append(lg[-1])
    lg_paged = torch.stack(last)
    lg_dense, cache, lengths = tmodels.prefill(
        pt, ct, {"tokens": prompts[:, :PROMPT]}, MAX_SEQ)
    for _ in range(STEPS):
        close(lg_dense, lg_paged.numpy())
        tok = lg_paged.argmax(-1, keepdim=True).to(torch.int32)
        top2 = lg_paged.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > ATOL
        assert torch.equal(tok[clear], lg_dense.argmax(
            -1, keepdim=True).to(torch.int32)[clear])
        lg_paged, pages = tmodels.decode_step_paged(pt, ct, tok, pages,
                                                    tables, lengths)
        lg_dense, cache, lengths = tmodels.decode_step(pt, ct, tok, cache,
                                                       lengths)
    close(lg_dense, lg_paged.numpy())


def test_absorbed_mla_decode_equals_uncompressed(models):
    """The absorbed latent decode (queries projected into the latent
    space) at the last position equals dense attention over per-head
    keys and values materialized from the latent."""
    from repro_torch.serve.reference import mla_materialized_qkv

    _, ct, _, pt = models["deepseek-v2-236b"]
    attn = _layer(pt["blocks"], 0)["attn"]
    b, s = 2, 24
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (b, s, ct.d_model)).astype(np.float32))
    positions = torch.arange(s)
    q, k, v = mla_materialized_qkv(attn, ct, x, positions)
    o = ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True)
    want = o.transpose(1, 2).reshape(b, s, -1) @ attn["wo"]
    q_lat, q_rope = TL.mla_absorbed_q(attn, ct, x[:, -1:],
                                      torch.full((b, 1), s - 1))
    c_kv, k_rope = TL.mla_latents(attn, ct, x, positions)
    o_dec = TL.latent_decode_attention(
        q_lat, q_rope, c_kv, k_rope,
        lengths=torch.full((b,), s, dtype=torch.int32),
        scale=TL.mla_scale(ct))
    got = TL.mla_out(attn, ct, o_dec)
    assert float((got[:, 0] - want[:, -1]).abs().max()) <= ATOL
