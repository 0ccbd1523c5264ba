"""The port's encoder-decoder family (``repro_torch.models.encdec``:
seamless-m4t-medium) against ``repro`` on the CPU.

Reduced config in float32, weights from ``repro.models.init_params``
through ``convert.from_jax``, source frames and tokens drawn by numpy from
a seed.  ``encode`` and ``_cross_attention`` (S target positions against
S_src frames, no mask: the flash kernel's Sq != Sk entry on the card);
``forward`` and ``loss_fn``; ``prefill`` (the encoder and every layer's
cross K/V) and ``decode_step`` (logits and every cache leaf); greedy
decode against the port's own teacher-forced forward; one AdamW train
step against ``repro``'s and the launcher on the CPU.

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
from repro.models import encdec as JE
from repro_torch import configs as tcfg
from repro_torch import models as tmodels
from repro_torch.convert import from_jax
from repro_torch.models import encdec as TE
from repro_torch.models.transformer import _layer
from test_torch_train import _check_step

torch.set_num_threads(1)
ATOL = 1e-4
ARCH = "seamless-m4t-medium"
B, S_SRC, S_TGT, MAX_SEQ = 2, 20, 12, 16


@pytest.fixture(scope="module")
def model():
    cj, ct = (m.get_arch(ARCH).reduced() for m in (jcfg, tcfg))
    pj = jmodels.init_params(cj, jax.random.PRNGKey(0))
    pt = from_jax(jax.tree.map(np.asarray, pj), ct, "cpu")
    return cj, ct, pj, pt


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j),
                               atol=atol, rtol=0)


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, S_SRC, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S_TGT)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S_TGT)).astype(np.int32)
    pairs = {k: _pair(v) for k, v in
             (("src_emb", src), ("tokens", toks), ("labels", labels))}
    return ({k: v[0] for k, v in pairs.items()},
            {k: v[1] for k, v in pairs.items()})


def test_encode_and_cross_attention_match_jax(model):
    cj, ct, pj, pt = model
    bj, bt = _batch(cj, 0)
    enc_j = JE.encode(pj, cj, bj["src_emb"], remat=False)
    enc_t = TE.encode(pt, ct, bt["src_emb"], remat=False)
    close(enc_t, enc_j)
    xj = jax.tree.map(lambda t: t[1], pj["dec_blocks"])["xattn"]
    xt = _layer(pt["dec_blocks"], 1)["xattn"]
    hj, ht = _pair(np.random.default_rng(1).standard_normal(
        (B, S_TGT, cj.d_model)).astype(np.float32))
    close(TE._cross_attention(xt, ct, ht, enc_t),
          JE._cross_attention(xj, cj, hj, enc_j))


def test_forward_and_loss_match_jax(model):
    cj, ct, pj, pt = model
    bj, bt = _batch(cj, 2)
    close(tmodels.forward(pt, ct, bt, remat=False),
          jmodels.forward(pj, cj, bj, remat=False))
    loss, _ = tmodels.loss_fn(pt, ct, bt)
    want, _ = jmodels.loss_fn(pj, cj, bj)
    assert abs(float(loss) - float(want)) <= 1e-5


def test_prefill_and_decode_match_jax_and_forward(model):
    """prefill fills the cross K/V of every decoder layer; greedy decode
    from an empty target matches ``repro``'s decode (logits and every cache
    leaf) step by step, and the port's teacher-forced forward over the
    decoded tokens at every position."""
    cj, ct, pj, pt = model
    bj, bt = _batch(cj, 3)
    spec = tmodels.cache_spec(ct, B, MAX_SEQ, S_SRC)
    assert {k: (v.shape, v.dtype) for k, v in spec.items()} == {
        k: (v.shape, getattr(torch, str(v.dtype)))
        for k, v in jmodels.cache_spec(cj, B, MAX_SEQ, S_SRC).items()}
    lg_j, cache_j, len_j = jmodels.prefill(pj, cj, bj, max_seq=MAX_SEQ)
    lg_t, cache_t, len_t = tmodels.prefill(pt, ct, bt, MAX_SEQ)
    close(lg_t, lg_j)
    for k in cache_j:
        close(cache_t[k], cache_j[k])
    assert torch.equal(len_t, torch.from_numpy(np.array(len_j)))
    tok_j, tok_t = _pair(np.zeros((B, 1), np.int32))
    steps, tokens, logits = 6, [tok_t], []
    for _ in range(steps):
        lg_j, cache_j, len_j = jmodels.decode_step(pj, cj, tok_j, cache_j,
                                                   len_j)
        lg_t, cache_t, len_t = tmodels.decode_step(pt, ct, tok_t, cache_t,
                                                   len_t)
        close(lg_t, lg_j)
        for k in cache_j:
            close(cache_t[k], cache_j[k])
        tok_t = lg_t.argmax(-1, keepdim=True).to(torch.int32)
        tok_j = jnp.asarray(tok_t.numpy())
        tokens.append(tok_t)
        logits.append(lg_t)
    assert torch.equal(len_t, torch.full((B,), steps, dtype=torch.int32))
    full = tmodels.forward(pt, ct, {"src_emb": bt["src_emb"],
                                    "tokens": torch.cat(tokens[:-1], 1)},
                           remat=False)
    close(torch.stack(logits, 1), full.numpy())


def test_train_step_matches_jax(model):
    from repro.data import pipeline as jdata
    from repro.optim import AdamWConfig as JAdamWConfig
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import init_train_state as jinit_train_state
    from repro.train.train_step import make_train_step
    from repro_torch.data import pipeline as tdata
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, train_step

    cj, ct, pj, pt = model
    lr = 1e-2
    opt = dict(lr=lr, warmup_steps=1, total_steps=10)
    tcj = JTrainConfig(opt=JAdamWConfig(**opt))
    tct = TrainConfig(opt=AdamWConfig(**opt))
    kw = dict(seq_len=12, global_batch=2, vocab=cj.vocab, src_len=S_SRC)
    bj = jdata.global_batch_rowwise(jdata.DataConfig(**kw), 0,
                                    d_model=cj.d_model)
    bt = tdata.global_batch_rowwise(tdata.DataConfig(**kw), 0,
                                    d_model=ct.d_model)
    np.testing.assert_array_equal(bt["src_emb"].numpy(), bj["src_emb"])
    pj1, sj1, mj1 = jax.jit(make_train_step(cj, tcj))(
        pj, jinit_train_state(cj, tcj, pj), bj)
    pt0 = jax.tree.map(torch.clone, pt)
    pt1, st1, mt1 = train_step(pt0, init_train_state(ct, tct, pt0), bt,
                               cfg=ct, tcfg=tct)
    _check_step(pt1, st1, mt1, pj1, sj1, mj1, lr)


def test_launch_train_reduced_cpu(monkeypatch, capsys):
    from repro_torch.launch import train as launch

    monkeypatch.setattr("sys.argv", [
        "train", "--arch", ARCH, "--reduced", "--device", "cpu",
        "--steps", "2", "--batch", "2", "--seq", "16"])
    launch.main()
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "done: loss" in out


def test_frames_are_taken_in_the_weights_dtype(model):
    """bf16 weights with f32 frames: the encoder runs in bf16 (the frames
    cast once), the same as bf16 frames."""
    _, ct, _, pt = model
    ct16 = dataclasses.replace(ct, param_dtype="bfloat16")
    pt16 = jax.tree.map(lambda t: t.to(torch.bfloat16), pt)
    src = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 8, ct.d_model)).astype(np.float32))
    a = TE.encode(pt16, ct16, src, remat=False)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, TE.encode(pt16, ct16, src.bfloat16(), remat=False))
