"""The port's configs, planner, layers, sampler and weight bridge against
``repro`` on the same inputs (numpy, from a seed), on the CPU.

Tolerances: layer functions in float32 agree to atol 1e-5 (the two
frameworks order their float32 sums differently), the MLA and MoE blocks,
whose products run over wider sums, to atol 1e-4; config fields, page
sizes, router ids, greedy tokens and converted weights agree exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import moe as JM
from repro.serve.paging import paco_page_size as jax_paco_page_size
from repro_torch import configs as tcfg
from repro_torch.convert import from_jax
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models.sampling import sample_tokens
from repro_torch.serve.paging import paco_page_size

# Small tensors: one intra-op thread each, so these tests do not crowd the
# other workers of a parallel run.
torch.set_num_threads(1)
ATOL = 1e-5
ARCHS = sorted(jcfg.ARCHS)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# configs and the PACO page planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_field_for_field(arch):
    for j, t in [(jcfg.get_arch(arch), tcfg.get_arch(arch)),
                 (jcfg.get_arch(arch).reduced(),
                  tcfg.get_arch(arch).reduced())]:
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert j.padded_vocab == t.padded_vocab
        assert str(j.dtype) == str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("max_seq", [33, 36, 63, 64, 97, 128, 2048])
def test_paco_page_size_matches_repro(max_seq):
    """Prime and odd max_seq included: the port's copy of the planner
    picks the same page as repro's."""
    for slots in (1, 2, 3, 7, 8):
        for feat in (16, 32, 128):
            assert paco_page_size(slots, max_seq, feat) == \
                jax_paco_page_size(slots, max_seq, feat)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norm_softcap_mask_act_match_jax():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 3, 5, 16), _rand(rng, 16)
    _close(TL.rms_norm(_t(x), _t(scale)), JL.rms_norm(x, scale))
    _close(TL.softcap(_t(x) * 40, 30.0), JL.softcap(x * 40, 30.0))
    assert TL.softcap(_t(x), None) is not None
    logits = _rand(rng, 4, 300)
    _close(TL.mask_vocab(_t(logits), 256), JL.mask_vocab(logits, 256))
    for kind in ("silu", "gelu", "sq_relu"):
        _close(TL.act_fn(kind, _t(x)), JL.act_fn(kind, x))


@pytest.mark.parametrize("head_axis", [True, False])
def test_apply_rope_matches_jax(head_axis):
    rng = np.random.default_rng(1)
    shape = (2, 7, 3, 16) if head_axis else (2, 7, 16)
    x = _rand(rng, *shape)
    pos = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    _close(TL.apply_rope(_t(x), _t(pos), 1e6, head_axis=head_axis),
           JL.apply_rope(x, pos, 1e6, head_axis=head_axis))
    _close(TL.rope_freqs(16, 1e6), JL.rope_freqs(16, 1e6))


def _gqa_params(rng, cfg):
    dh = cfg.head_dim
    p = {"wq": _rand(rng, cfg.d_model, cfg.n_heads * dh) / 8,
         "wk": _rand(rng, cfg.d_model, cfg.n_kv_heads * dh) / 8,
         "wv": _rand(rng, cfg.d_model, cfg.n_kv_heads * dh) / 8,
         "wo": _rand(rng, cfg.n_heads * dh, cfg.d_model) / 8}
    if cfg.qk_norm:
        p["q_norm"] = _rand(rng, dh) / 4
        p["k_norm"] = _rand(rng, dh) / 4
    return p


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "codeqwen1.5-7b"])
def test_gqa_qkv_matches_jax(arch):
    """qk-norm (qwen3) and without (codeqwen), before rope."""
    rng = np.random.default_rng(2)
    cfg_j = jcfg.get_arch(arch).reduced()
    cfg_t = tcfg.get_arch(arch).reduced()
    p = _gqa_params(rng, cfg_j)
    x = _rand(rng, 2, 5, cfg_j.d_model)
    pos = np.tile(np.arange(3, 8, dtype=np.int32), (2, 1))
    got = TL.gqa_qkv({k: _t(v) for k, v in p.items()}, cfg_t, _t(x), _t(pos))
    want = JL.gqa_qkv(p, cfg_j, x, pos)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-2b",
                                  "nemotron-4-15b"])
def test_apply_mlp_matches_jax(arch):
    """swiglu, geglu and sq_relu."""
    rng = np.random.default_rng(3)
    cfg_j = jcfg.get_arch(arch).reduced()
    cfg_t = tcfg.get_arch(arch).reduced()
    p = {"down": _rand(rng, cfg_j.d_ff, cfg_j.d_model) / 8,
         "up": _rand(rng, cfg_j.d_model, cfg_j.d_ff) / 8}
    if cfg_j.act != "sq_relu":
        p["gate"] = _rand(rng, cfg_j.d_model, cfg_j.d_ff) / 8
    x = _rand(rng, 2, 3, cfg_j.d_model)
    _close(TL.apply_mlp({k: _t(v) for k, v in p.items()}, cfg_t, _t(x)),
           JL.apply_mlp(p, cfg_j, x))


# ---------------------------------------------------------------------------
# MLA (absorbed latent attention) and MoE
# ---------------------------------------------------------------------------

BLOCK_ATOL = 1e-4


def _tp(tree):
    return {k: _tp(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _mla_setup(seed=6):
    rng = np.random.default_rng(seed)
    cfg_j = jcfg.get_arch("deepseek-v2-236b").reduced()
    cfg_t = tcfg.get_arch("deepseek-v2-236b").reduced()
    m, h, d = cfg_j.mla, cfg_j.n_heads, cfg_j.d_model
    p = {"w_dq": _rand(rng, d, m.q_lora) / 8,
         "q_norm": _rand(rng, m.q_lora) / 4,
         "w_uq": _rand(rng, m.q_lora, h * (m.qk_nope + m.qk_rope)) / 6,
         "w_dkv": _rand(rng, d, m.kv_lora + m.qk_rope) / 8,
         "kv_norm": _rand(rng, m.kv_lora) / 4,
         "w_uk": _rand(rng, m.kv_lora, h * m.qk_nope) / 6,
         "w_uv": _rand(rng, m.kv_lora, h * m.v_head) / 6,
         "wo": _rand(rng, h * m.v_head, d) / 8}
    x = _rand(rng, 2, 6, d)
    pos = np.tile(np.arange(5, 11, dtype=np.int32), (2, 1))
    return rng, cfg_j, cfg_t, p, x, pos


def test_mla_projections_match_jax():
    """mla_latents, mla_queries, mla_absorbed_q, mla_out and mla_scale on
    reduced deepseek-v2."""
    rng, cfg_j, cfg_t, p, x, pos = _mla_setup()
    pt = _tp(p)
    assert TL.mla_scale(cfg_t) == JL.mla_scale(cfg_j)
    for fn in ("mla_latents", "mla_queries", "mla_absorbed_q"):
        got = getattr(TL, fn)(pt, cfg_t, _t(x), _t(pos))
        want = getattr(JL, fn)(p, cfg_j, x, pos)
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape, fn
            _close(g, w, BLOCK_ATOL)
    o_lat = _rand(rng, 2, 6, cfg_j.n_heads, cfg_j.mla.kv_lora)
    _close(TL.mla_out(pt, cfg_t, _t(o_lat)), JL.mla_out(p, cfg_j, o_lat),
           BLOCK_ATOL)


@pytest.mark.parametrize("sq,k_off", [(6, 0), (3, 4)])
def test_latent_attention_matches_jax(sq, k_off):
    """Decomposed-score attention against the shared latent, causal over
    global positions: a full square and a late query block over a longer
    context."""
    rng, cfg_j, cfg_t, p, x, pos = _mla_setup(7)
    m, h = cfg_j.mla, cfg_j.n_heads
    sk = sq + k_off
    ql, qr = _rand(rng, 2, sq, h, m.kv_lora), _rand(rng, 2, sq, h, m.qk_rope)
    ck, kr = _rand(rng, 2, sk, m.kv_lora), _rand(rng, 2, sk, m.qk_rope)
    qpos = np.arange(k_off, sk, dtype=np.int32)
    kpos = np.arange(sk, dtype=np.int32)
    scale = JL.mla_scale(cfg_j)
    got = TL.latent_attention(*map(_t, (ql, qr, ck, kr)),
                              q_positions=_t(qpos), k_positions=_t(kpos),
                              scale=scale)
    want = JL.latent_attention(ql, qr, ck, kr, q_positions=qpos,
                               k_positions=kpos, scale=scale, q_chunk=4)
    _close(got, want, BLOCK_ATOL)


def _moe_setup(arch, seed):
    rng = np.random.default_rng(seed)
    cfg_j = jcfg.get_arch(arch).reduced()
    cfg_t = tcfg.get_arch(arch).reduced()
    m, d = cfg_j.moe, cfg_j.d_model
    p = {"router": _rand(rng, d, m.n_experts),
         "gate": _rand(rng, m.n_experts, d, m.d_ff_expert) / 8,
         "up": _rand(rng, m.n_experts, d, m.d_ff_expert) / 8,
         "down": _rand(rng, m.n_experts, m.d_ff_expert, d) / 6}
    if m.n_shared:
        f = m.d_ff_expert * m.n_shared
        p["shared"] = {"gate": _rand(rng, d, f) / 8,
                       "up": _rand(rng, d, f) / 8,
                       "down": _rand(rng, f, d) / 6}
    return rng, cfg_j, cfg_t, p, _rand(rng, 2, 8, d)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "olmoe-1b-7b"])
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_apply_moe_matches_jax(arch, capacity_factor):
    """Router ids exactly equal; the MoE output within 1e-4.  At the
    reduced capacity factor (2.0) no token is ever dropped, so a factor of
    0.5 on both sides exercises the drop path."""
    rng, cfg_j, cfg_t, p, x = _moe_setup(arch, 8)
    if capacity_factor is not None:
        cfg_j = dataclasses.replace(cfg_j, moe=dataclasses.replace(
            cfg_j.moe, capacity_factor=capacity_factor))
        cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(
            cfg_t.moe, capacity_factor=capacity_factor))
    m = cfg_j.moe
    xf = x.reshape(-1, cfg_j.d_model)
    w_t, ids_t = TM.router_topk(_tp(p), cfg_t, _t(xf))
    w_j, ids_j = JM.router_topk(p, cfg_j, xf)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    _close(w_t, w_j, BLOCK_ATOL)
    _close(TM.apply_moe(_tp(p), cfg_t, _t(x)), JM.apply_moe(p, cfg_j, x),
           BLOCK_ATOL)
    n = xf.shape[0]
    cap = max(1, int(m.capacity_factor * n * m.top_k / m.n_experts))
    load = np.bincount(np.asarray(ids_j).ravel(), minlength=m.n_experts)
    assert (load.max() > cap) == (capacity_factor == 0.5), (load, cap)


def test_router_ties_go_to_the_lower_expert():
    """Equal router probabilities: the stable sort picks the lower ids, as
    jax.lax.top_k does."""
    _, cfg_j, cfg_t, p, x = _moe_setup("olmoe-1b-7b", 9)
    p["router"][:, 1] = p["router"][:, 3]
    p["router"][:, 2] = p["router"][:, 3]
    xf = x.reshape(-1, cfg_j.d_model)
    _, ids_t = TM.router_topk(_tp(p), cfg_t, _t(xf))
    np.testing.assert_array_equal(
        ids_t.numpy(), np.asarray(JM.router_topk(p, cfg_j, xf)[1]))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def test_greedy_sampling_matches_jax_exactly():
    from repro.models.sampling import sample_tokens as jax_sample

    rng = np.random.default_rng(4)
    logits = _rand(rng, 16, 300)
    logits[3, [7, 9]] = 50.0        # a tie: both take the first maximum
    logits = np.asarray(JL.mask_vocab(logits, 256))
    got = sample_tokens(_t(logits)).numpy()
    want = np.asarray(jax_sample(logits))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got[3] == 7


def test_topk_sampling_properties():
    """Top-k draws from JAX's PRNG cannot be reproduced, so test what the
    draw must satisfy: never a masked vocab entry, only the k largest."""
    rng = np.random.default_rng(5)
    k = 4
    logits = TL.mask_vocab(_t(_rand(rng, 8, 300)), 256)
    top = torch.topk(logits, k, dim=-1).indices
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(50):
        tok = sample_tokens(logits, generator=gen, top_k=k,
                            temperature=2.0).long()
        assert (tok < 256).all()
        assert (top == tok[:, None]).any(dim=1).all()
        seen.update(tok.tolist())
    assert len(seen) > 8        # it samples, not argmax
    # padded columns even when k reaches into them
    tok = sample_tokens(logits[:, :260], generator=gen, top_k=258)
    assert (tok < 256).all()
    with pytest.raises(ValueError):
        sample_tokens(logits, top_k=k)


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("qwen3-0.6b", "bfloat16")])
def test_from_jax_round_trips(arch, dtype):
    """Every arch's reduced config: same tree, shapes, dtypes, and
    bit-identical values (bf16 through its uint16 view)."""
    cfg_j = dataclasses.replace(jcfg.get_arch(arch).reduced(),
                                param_dtype=dtype)
    cfg_t = dataclasses.replace(tcfg.get_arch(arch).reduced(),
                                param_dtype=dtype)
    params = jax.tree.map(np.asarray,
                          jax_init_params(cfg_j, jax.random.PRNGKey(0)))
    got = dict(_leaves(from_jax(params, cfg_t, "cpu")))
    want = dict(_leaves(params))
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == w.shape, name
        assert g.dtype == cfg_t.dtype, name
        if dtype == "bfloat16":
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy().view(np.uint16),
                w.view(np.uint16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    if dtype == "bfloat16":
        with pytest.raises(TypeError):
            from_jax(params, dataclasses.replace(cfg_t,
                                                 param_dtype="float32"),
                     "cpu")


def test_config_dtype_is_a_torch_dtype():
    assert tcfg.get_arch("qwen3-0.6b").dtype is torch.bfloat16
    assert jcfg.get_arch("qwen3-0.6b").dtype == jnp.bfloat16
