"""The port's SSM and hybrid families (``repro_torch.models.ssm`` and
``hybrid``: mamba2-780m and zamba2-7b) against ``repro`` on the CPU.

Reduced configs in float32 (zamba2 also at 4 layers in 2 groups, so that
two groups share the attention block), weights from
``repro.models.init_params`` through ``convert.from_jax``, inputs drawn by
numpy from a seed.  Per function: ``segsum``, ``ssd_chunked`` with and
without an initial state (and its gradient), ``ssd_step``,
``apply_mamba2``, ``step_mamba2``.  Per model: ``forward`` and
``loss_fn``, ``decode_step`` (logits and every state leaf), decode
against the port's own forward (``tests/test_models.py:100``'s
invariant), ``prefill`` refusing as ``repro``'s does, one AdamW train step
against ``repro``'s and the launcher on the CPU; the bf16 weight bridge.

Tolerance: 1e-4 (``tests/torch_parity.py``), float32 throughout; the
train step is held as ``tests/test_torch_train.py`` holds it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro import models as jmodels
from repro.models import ssm as JS
from repro_torch import configs as tcfg
from repro_torch import models as tmodels
from repro_torch.convert import from_jax
from repro_torch.models import ssm as TS
from repro_torch.models.transformer import _layer
from test_torch_train import _check_step

torch.set_num_threads(1)
ATOL = 1e-4
# repro's functions jitted once per config: eager JAX traces every step
jforward = jax.jit(jmodels.forward, static_argnums=1,
                   static_argnames="remat")
jdecode_step = jax.jit(jmodels.decode_step, static_argnums=1)
ARCHS = {"mamba2": ("mamba2-780m", {}),
         "zamba2": ("zamba2-7b", {}),
         "zamba2_2groups": ("zamba2-7b", {"n_layers": 4, "attn_every": 2})}


def _cfgs(name):
    arch, kw = ARCHS[name]
    return tuple(dataclasses.replace(m.get_arch(arch).reduced(), **kw)
                 for m in (jcfg, tcfg))


class _Models(dict):
    def __missing__(self, name):
        cj, ct = _cfgs(name)
        pj = jmodels.init_params(cj, jax.random.PRNGKey(0))
        pt = from_jax(jax.tree.map(np.asarray, pj), ct, "cpu")
        self[name] = (cj, ct, pj, pt)
        return self[name]


@pytest.fixture(scope="module")
def models():
    return _Models()


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j),
                               atol=atol, rtol=0)


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


def _tokens(vocab, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s))
    return _pair(toks.astype(np.int32))


# ---------------------------------------------------------------------------
# the SSD functions and the Mamba-2 block
# ---------------------------------------------------------------------------

def test_segsum_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 7)).astype(
        np.float32)
    xj, xt = _pair(x)
    got, want = TS.segsum(xt).numpy(), np.asarray(JS.segsum(xj))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-5, rtol=0)


def _ssd_inputs(seed, b=2, s=24, h=6, g=2, p=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = -np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 0.5
    bb, cc = (rng.standard_normal((b, s, g, n)).astype(np.float32)
              for _ in range(2))
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, a, bb, cc, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [8, 24])
def test_ssd_chunked_matches_jax(with_h0, chunk):
    x, a, b, c, h0 = _ssd_inputs(1)
    h0 = h0 if with_h0 else None
    yj, fj = jax.jit(JS.ssd_chunked, static_argnums=4)(
        *map(jnp.asarray, (x, a, b, c)), chunk,
        None if h0 is None else jnp.asarray(h0))
    yt, ft = TS.ssd_chunked(*map(torch.from_numpy, (x, a, b, c)), chunk,
                            None if h0 is None else torch.from_numpy(h0))
    close(yt, yj)
    close(ft, fj)


def test_ssd_chunked_gradient_is_finite_and_matches_jax():
    """segsum's -inf mask must not leak NaN into the gradient."""
    x, a, b, c, h0 = _ssd_inputs(2)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(*args):
        y, f = JS.ssd_chunked(*args[:4], 8, args[4])
        return jnp.sum(y * w) + jnp.sum(f)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, (x, a, b, c, h0)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (x, a, b, c, h0)]
    y, f = TS.ssd_chunked(*leaves[:4], 8, leaves[4])
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum() + f.sum(),
                              leaves)
    for g, wg in zip(got, want):
        assert torch.isfinite(g).all()
        close(g, wg)


def test_ssd_step_matches_jax():
    x, a, b, c, h0 = _ssd_inputs(4)
    args = (h0, x[:, 0], a[:, 0], b[:, 0], c[:, 0])
    yj, hj = JS.ssd_step(*map(jnp.asarray, args))
    yt, ht = TS.ssd_step(*map(torch.from_numpy, args))
    close(yt, yj)
    close(ht, hj)


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_mamba2_block_and_step_match_jax(models, name):
    cj, ct, pj, pt = models[name]
    if name == "mamba2":
        mj = jax.tree.map(lambda t: t[0], pj["blocks"])["mixer"]
        mt = _layer(pt["blocks"], 0)["mixer"]
    else:
        mj = jax.tree.map(lambda t: t[0, 1], pj["groups"])["mixer"]
        mt = _layer(_layer(pt["groups"], 0), 1)["mixer"]
    rng = np.random.default_rng(5)
    uj, ut = _pair(rng.standard_normal((2, 16, cj.d_model)).astype(
        np.float32))
    close(TS.apply_mamba2(mt, ct, ut),
          jax.jit(JS.apply_mamba2, static_argnums=1)(mj, cj, uj))
    conv_s, ssm_s = TS.mamba2_state_shapes(ct, 2)
    assert (conv_s, ssm_s) == JS.mamba2_state_shapes(cj, 2)
    cj_, ct_ = _pair(rng.standard_normal(conv_s).astype(np.float32))
    sj_, st_ = _pair(rng.standard_normal(ssm_s).astype(np.float32))
    got = TS.step_mamba2(mt, ct, ut[:, 0], ct_, st_)
    want = JS.step_mamba2(mj, cj, uj[:, 0], cj_, sj_)
    for g, w in zip(got, want):
        close(g, w)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_and_loss_match_jax(models, name):
    cj, ct, pj, pt = models[name]
    tj, tt = _tokens(cj.vocab, 2, 24, 6)
    lj_, lt_ = _tokens(cj.vocab, 2, 24, 7)
    logits = tmodels.forward(pt, ct, {"tokens": tt}, remat=False)
    close(logits, jforward(pj, cj, {"tokens": tj}, remat=False))
    loss, _ = tmodels.loss_fn(pt, ct, {"tokens": tt, "labels": lt_})
    want, _ = jmodels.loss_fn(pj, cj, {"tokens": tj, "labels": lj_})
    assert abs(float(loss) - float(want)) <= 1e-5


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_decode_steps_match_jax_and_forward(models, name):
    """Decode from the empty state: logits and every state leaf against
    ``repro``'s decode, and logits against the port's own forward at each
    position."""
    cj, ct, pj, pt = models[name]
    b, s, max_seq = 2, 8, 16
    tj, tt = _tokens(cj.vocab, b, s, 8)
    full = tmodels.forward(pt, ct, {"tokens": tt}, remat=False)
    spec = tmodels.cache_spec(ct, b, max_seq)
    assert {k: (v.shape, v.dtype) for k, v in spec.items()} == {
        k: (v.shape, getattr(torch, str(v.dtype)))
        for k, v in jmodels.cache_spec(cj, b, max_seq).items()}
    cache_j = jmodels.init_cache(cj, b, max_seq)
    cache_t = tmodels.init_cache(ct, b, max_seq, device="cpu")
    len_j = jnp.zeros((b,), jnp.int32)
    len_t = torch.zeros((b,), dtype=torch.int32)
    for t in range(s):
        lg_j, cache_j, len_j = jdecode_step(pj, cj, tj[:, t:t + 1],
                                            cache_j, len_j)
        lg_t, cache_t, len_t = tmodels.decode_step(pt, ct, tt[:, t:t + 1],
                                                   cache_t, len_t)
        close(lg_t, lg_j)
        close(lg_t, full[:, t].numpy())
        for k in cache_j:
            close(cache_t[k], cache_j[k])
        assert torch.equal(len_t, torch.from_numpy(np.array(len_j)))


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_prefill_raises_as_jax_does(models, name):
    cj, ct, pj, pt = models[name]
    tj, tt = _tokens(cj.vocab, 1, 8, 9)
    with pytest.raises(NotImplementedError):
        jmodels.prefill(pj, cj, {"tokens": tj}, max_seq=16)
    with pytest.raises(NotImplementedError):
        tmodels.prefill(pt, ct, {"tokens": tt}, max_seq=16)


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_train_step_matches_jax(models, name):
    """One AdamW step from the same params and a zero state, with remat,
    on the data pipeline's batch (as ``test_torch_train.py`` holds the
    decoder's)."""
    from repro.data import pipeline as jdata
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import init_train_state as jinit_train_state
    from repro.train.train_step import make_train_step
    from repro_torch.data import pipeline as tdata
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, train_step

    cj, ct, pj, pt = models[name]
    lr = 1e-2
    opt = dict(lr=lr, warmup_steps=1, total_steps=10)
    tcj = JTrainConfig(opt=JAdamWConfig(**opt))
    tct = TrainConfig(opt=AdamWConfig(**opt))
    bj = jdata.global_batch_rowwise(
        jdata.DataConfig(seq_len=16, global_batch=2, vocab=cj.vocab), 0)
    bt = tdata.global_batch_rowwise(
        tdata.DataConfig(seq_len=16, global_batch=2, vocab=ct.vocab), 0)
    pj1, sj1, mj1 = jax.jit(make_train_step(cj, tcj))(
        pj, jinit_train_state(cj, tcj, pj), bj)
    pt0 = jax.tree.map(torch.clone, pt)
    pt1, st1, mt1 = train_step(pt0, init_train_state(ct, tct, pt0), bt,
                               cfg=ct, tcfg=tct)
    _check_step(pt1, st1, mt1, pj1, sj1, mj1, lr)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_launch_train_reduced_cpu(monkeypatch, capsys, arch):
    from repro_torch.launch import train as launch

    monkeypatch.setattr("sys.argv", [
        "train", "--arch", arch, "--reduced", "--device", "cpu",
        "--steps", "2", "--batch", "2", "--seq", "16"])
    launch.main()
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "done: loss" in out


def test_bf16_weight_bridge_keeps_the_f32_mixer_leaves():
    """A bf16 mamba2: the mixer's a_log, dt_bias and d_skip stay f32 and
    pass bit-identical; every other leaf is bf16; any other dtype
    mismatch is still refused."""
    cj, ct = (dataclasses.replace(m.get_arch("mamba2-780m").reduced(),
                                  param_dtype="bfloat16")
              for m in (jcfg, tcfg))
    pj = jax.tree.map(np.asarray, jmodels.init_params(cj,
                                                      jax.random.PRNGKey(0)))
    pt = from_jax(pj, ct, "cpu")
    mixer = pt["blocks"]["mixer"]
    for k in ("a_log", "dt_bias", "d_skip"):
        assert mixer[k].dtype == torch.float32
        np.testing.assert_array_equal(mixer[k].numpy(),
                                      pj["blocks"]["mixer"][k])
    assert mixer["in_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        mixer["in_proj"].view(torch.int16).numpy(),
        pj["blocks"]["mixer"]["in_proj"].view(np.int16))
    bad = jax.tree.map(lambda t: t, pj)
    bad["blocks"]["mixer"]["conv_w"] = bad["blocks"]["mixer"][
        "conv_w"].astype(np.float32)
    with pytest.raises(TypeError, match="conv_w"):
        from_jax(bad, ct, "cpu")
    bad = jax.tree.map(lambda t: t, pj)
    bad["blocks"]["mixer"]["a_log"] = bad["blocks"]["mixer"][
        "a_log"].astype(pj["embed"].dtype)
    with pytest.raises(TypeError, match="a_log"):
        from_jax(bad, ct, "cpu")
    bad = jax.tree.map(lambda t: t, pj)
    bad["final_norm"] = bad["final_norm"].astype(np.float32)
    with pytest.raises(TypeError, match="final_norm"):
        from_jax(bad, ct, "cpu")
