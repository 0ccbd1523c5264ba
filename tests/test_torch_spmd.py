"""The port's distributed paths across several ranks, on the CPU: gloo
process groups of 8 and 5 ranks (``tests/torch_spmd_worker.py``), one
spawn per world size running all of that size's checks (the 5 ranks also
run sequence-parallel attention on a (1, 5) mesh), and one
``torch.distributed.run`` of ``launch.train --mesh 2x2``.  The references
are computed here, in the parent, from the same numpy inputs (JAX's from
``repro``, with ``convert.from_jax`` weights where the port is held to
it).  Each check states its tolerance; f32 throughout.

Wall time: about 110 s on an idle 8-core host, most of it the 8-rank
spawn (serving, the elastic runs, the forward and the train step through
DTensor's dispatch) and the parent's references, then the launcher run
and the 5-rank spawn."""
import dataclasses
import os
import pickle
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parity as TP
import torch_spmd_worker as W
from repro import configs as jcfg
from repro import models as jmodels
from repro.data import DataConfig as JDataConfig
from repro.data import global_batch_rowwise as j_batch
from repro.models.moe import init_moe as j_init_moe
from repro.optim import AdamWConfig as JAdamW
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_state
from repro.train import make_train_step as j_make_step
from repro_torch import configs as tcfg
from repro_torch import models as tmodels
from repro_torch.convert import from_jax
from repro_torch.core.sort import choose_pivots
from repro_torch.data.pipeline import DataConfig, global_batch_rowwise
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_train_state, train_step

torch.set_num_threads(1)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FWD_ARCHS = ("qwen3-0.6b", "deepseek-v2-236b", "mamba2-780m",
             "seamless-m4t-medium")
SERVE_ARCHS = ("qwen3-0.6b", "deepseek-v2-236b")
NO_PREFILL = ("mamba2-780m", "zamba2-7b")    # SSM, hybrid: as in repro
DECODE_ARCHS = SERVE_ARCHS + NO_PREFILL + ("seamless-m4t-medium",)
# f32 tolerances: the sharded paths sum k-cut partial products and
# data-parallel gradients in another order than one device does
FWD_ATOL = 1e-4          # sharded vs unsharded logits
MM_ATOL = 1e-4           # paco_matmul_shmap / pjit vs a @ b
MOE_ATOL = 1e-5          # apply_moe_paco_ep vs JAX's dense top-1
PIPE_ATOL = 1e-5         # GPipe vs the sequential stack
TRAIN_LOSS_JAX, TRAIN_LEAF_JAX = 1e-3, 5e-3      # as tests/test_spmd.py
TRAIN_LOSS_PORT, TRAIN_LEAF_PORT = 1e-5, 1e-5    # vs the port, one device
ELASTIC_RTOL = 2e-4      # as tests/test_spmd.py
DECODE_ATOL = TP.ATOL    # meshed dense-cache logits and cache vs one
                         # device and vs JAX (f32, as test_torch_nonpaged)
DECODE_PROMPT, DECODE_STEPS, DECODE_MAX_SEQ = 8, 4, 32
# sequence-parallel attention on the (1, 5) mesh: reduced gemma2-2b at
# B 2 x S 40 (its local window 16: rows see no key in most blocks of 8;
# the prefill into a cache of 80 positions), reduced seamless-m4t-medium
# with 40 source frames and 20 target tokens, reduced zamba2-7b at S 40
SEQ_ARCH, SEQ_ENCDEC, SEQ_HYBRID = ("gemma2-2b", "seamless-m4t-medium",
                                    "zamba2-7b")
SEQ_BATCH, SEQ_LEN, SEQ_SRC, SEQ_TGT = 2, 40, 40, 20
SEQ_MAX_SEQ = 80
# the dims of K and V that the (1, 5) mesh's (data, model) axes cut where
# they meet the key cut: the keys over the model axis, never whole there
KV_KEY_CUT = ((None, 1),) * 2
j_decode_step = jax.jit(jmodels.decode_step, static_argnums=1)


def _spawn(world, jobs, tmp):
    """Run ``world`` ranks on ``jobs``; rank 0's results.  The parent
    computes its references after, not meanwhile: its JAX work would take
    the cores the ranks need."""
    job_path, out_path = os.path.join(tmp, "jobs.pkl"), os.path.join(
        tmp, "out.pkl")
    with open(job_path, "wb") as f:
        pickle.dump(jobs, f)
    mp.start_processes(W.main, args=(world, os.path.join(tmp, "store"),
                                     job_path, out_path),
                       nprocs=world, start_method="spawn")
    with open(out_path, "rb") as f:
        return pickle.load(f)


def _seq_apply(layers, xs):
    x = torch.from_numpy(xs)
    for w, b in layers:
        x = W._apply_layer({"w": torch.from_numpy(w),
                            "b": torch.from_numpy(b)}, x)
    return x.numpy()


def _moe_case():
    base = jcfg.get_arch("olmoe-1b-7b").reduced()
    moe = dict(n_experts=8, top_k=1, capacity_factor=8.0, n_shared=0)
    cj = dataclasses.replace(base, moe=dataclasses.replace(base.moe, **moe))
    tb = tcfg.get_arch("olmoe-1b-7b").reduced()
    ct = dataclasses.replace(tb, moe=dataclasses.replace(tb.moe, **moe))
    p = j_init_moe(jax.random.PRNGKey(0), cj, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 16, cj.d_model))
    # tests/test_spmd.py's dense reference: every token through its top-1
    xf = x.reshape(-1, cj.d_model)
    logits = xf @ p["router"]
    eid = jnp.argmax(logits, -1)
    w = jax.nn.softmax(logits, -1)[jnp.arange(xf.shape[0]), eid]
    h = jax.nn.silu(jnp.einsum("nd,ndf->nf", xf, p["gate"][eid]))
    h = h * jnp.einsum("nd,ndf->nf", xf, p["up"][eid])
    want = (jnp.einsum("nf,nfd->nd", h, p["down"][eid])
            * w[:, None]).reshape(x.shape)
    return ({"cfg": ct, "x": np.asarray(x),
             "params": {k: np.asarray(v) for k, v in p.items()}},
            np.asarray(want))


def _forward_cases():
    cases = []
    for arch in FWD_ARCHS:
        cfg = tcfg.get_arch(arch).reduced()
        params = tmodels.init_params(cfg, seed=0, device="cpu")
        dcfg = DataConfig(seq_len=16, global_batch=4, vocab=cfg.vocab,
                          src_len=16 if cfg.family == "encdec" else 0)
        batch = global_batch_rowwise(dcfg, 0, d_model=cfg.d_model)
        cases.append((arch, cfg, params, batch))
    return {"cases": cases}


def _forward_refs(job):
    with torch.no_grad():
        return {arch: tmodels.forward(params, cfg, batch,
                                      remat=False).numpy()
                for arch, cfg, params, batch in job["cases"]}


def _train_case():
    """The meshed step's job, and a function that computes the
    references: JAX's unsharded step and the port's."""
    cj = jcfg.get_arch("qwen3-0.6b").reduced()
    ct = tcfg.get_arch("qwen3-0.6b").reduced()
    pj = jmodels.init_params(cj, jax.random.PRNGKey(0))
    tc = TrainConfig(opt=AdamWConfig(lr=1e-3))
    batch = global_batch_rowwise(DataConfig(seq_len=32, global_batch=4,
                                            vocab=ct.vocab), 0)
    fresh = lambda: from_jax(jax.tree.map(np.asarray, pj), ct,  # noqa
                             "cpu")
    return ({"cfg": ct, "tcfg": tc, "params": fresh(), "batch": batch},
            lambda: _train_refs(cj, ct, pj, tc, batch, fresh()))


def _train_refs(cj, ct, pj, tc, batch, pt, seq=32, global_batch=4):
    step = j_make_step(cj, JTrainConfig(opt=JAdamW(lr=1e-3)))
    batch_j = j_batch(JDataConfig(seq_len=seq, global_batch=global_batch,
                                  vocab=cj.vocab), 0)
    pj_out, _, mj = jax.jit(step)(pj, j_init_state(
        cj, JTrainConfig(opt=JAdamW(lr=1e-3)), pj), batch_j)
    pt, _, mt = train_step(pt, init_train_state(ct, tc, pt), batch,
                           cfg=ct, tcfg=tc)
    return {"jax": (float(mj["loss"]),
                    _flat_np(jax.tree.map(np.asarray, pj_out))),
            "port": (float(mt["loss"]), _flat_np(pt))}


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_np(v, key))
        else:
            out[key] = np.asarray(v.numpy() if isinstance(v, torch.Tensor)
                                  else v, np.float32)
    return out


SERVE_KW = {"fused": (dict(slots=4, max_seq=32, prefill_chunk_len=8),
                      [[1, 2, 3], [5, 6, 7, 8, 9], [9], [4] * 11, [2, 8]],
                      6),
            "single_tick": (dict(slots=4, max_seq=32, prefill_chunk_len=8,
                                 fused=False),
                            [[1, 2, 3], [5, 6, 7, 8, 9], [4] * 11], 4),
            "spec": (dict(slots=4, max_seq=64, prefill_chunk_len=8,
                          speculate=3, ticks_per_dispatch=4,
                          spec_min_accept=0),
                     [[1, 2, 3, 1, 2, 3, 1], [9, 9, 9, 9, 9], [2, 8]], 12)}


def _serve_cases(models):
    cases = []
    for arch in SERVE_ARCHS:
        _, ct, _, pt = models[arch]
        for mode, (kw, prompts, max_new) in SERVE_KW.items():
            cases.append(((arch, mode), ct, pt, kw, prompts, max_new))
    return {"cases": cases}


def _serve_refs(models):
    """Per (arch, mode): the unmeshed engine's finished requests and
    JAX's reference tokens for each."""
    refs = {}
    for arch in SERVE_ARCHS:
        cj, ct, pj, pt = models[arch]
        for mode, (kw, prompts, max_new) in SERVE_KW.items():
            _, done = TP.serve(pt, ct, kw, prompts, max_new)
            refs[(arch, mode)] = (done, [TP.reference(pj, cj, r,
                                                      kw["max_seq"])
                                         for r in done])
    return refs


def _decode_cases(models):
    """Per arch: tokens (4, 12), the enc-dec's source frames, and the
    prompt the prefill takes (0 for SSM and hybrid: no prefill, every
    token decoded from the empty state)."""
    rng = np.random.default_rng(19)
    cases = []
    for arch in DECODE_ARCHS:
        _, ct, _, pt = models[arch]
        toks = rng.integers(0, ct.vocab, (4, DECODE_PROMPT + DECODE_STEPS),
                            dtype=np.int32)
        src = (rng.standard_normal((4, DECODE_PROMPT, ct.d_model)).astype(
            np.float32) if ct.family == "encdec" else None)
        prompt = 0 if arch in NO_PREFILL else DECODE_PROMPT
        cases.append((arch, ct, pt, toks, src, prompt, DECODE_MAX_SEQ))
    return {"cases": cases}


def _decode_refs(models, job):
    """Per arch: (the port's, JAX's) logits of the prefill and each
    decode step, final caches and lengths, on one device."""
    refs = {}
    for arch, _, _, toks, src, prompt, max_seq in job["cases"]:
        cj, ct, pj, pt = models[arch]
        tt, tj = torch.from_numpy(toks), jnp.asarray(toks)
        bt, bj = {"tokens": tt[:, :prompt]}, {"tokens": tj[:, :prompt]}
        if src is not None:
            bt["src_emb"], bj["src_emb"] = torch.from_numpy(src), \
                jnp.asarray(src)
        b = toks.shape[0]
        port, jx = [], []
        with torch.no_grad():
            if prompt:
                lg, cache, lens = tmodels.prefill(pt, ct, bt, max_seq)
                port.append(lg.numpy())
            else:
                cache = tmodels.init_cache(ct, b, max_seq, device="cpu")
                lens = torch.zeros((b,), dtype=torch.int32)
            for t in range(prompt, toks.shape[1]):
                lg, cache, lens = tmodels.decode_step(pt, ct,
                                                      tt[:, t:t + 1],
                                                      cache, lens)
                port.append(lg.numpy())
        if prompt:
            lgj, cj_cache, lj = jmodels.prefill(pj, cj, bj, max_seq=max_seq)
            jx.append(np.asarray(lgj))
        else:
            cj_cache = jmodels.init_cache(cj, b, max_seq)
            lj = jnp.zeros((b,), jnp.int32)
        for t in range(prompt, toks.shape[1]):
            lgj, cj_cache, lj = j_decode_step(pj, cj, tj[:, t:t + 1],
                                              cj_cache, lj)
            jx.append(np.asarray(lgj))
        refs[arch] = {"port": (port, {k: v.numpy() for k, v in
                                      cache.items()}, lens.numpy()),
                      "jax": (jx, {k: np.asarray(v) for k, v in
                                   cj_cache.items()}, np.asarray(lj))}
    return refs


def _elastic_job(tmp):
    cfg = tcfg.get_arch("qwen3-0.6b").reduced()
    return {"cfg": cfg, "tcfg": TrainConfig(opt=AdamWConfig(lr=1e-3)),
            "dcfg": DataConfig(seq_len=16, global_batch=4, vocab=cfg.vocab),
            "params": tmodels.init_params(cfg, seed=0, device="cpu"),
            "save_every": 2}


@pytest.fixture(scope="module")
def models():
    return TP._Models()


@pytest.fixture(scope="module")
def world8(tmp_path_factory, models):
    tmp = str(tmp_path_factory.mktemp("spmd8"))
    rng = np.random.default_rng(0)
    mm = {"a": rng.standard_normal((256, 128), np.float32),
          "b": rng.standard_normal((128, 192), np.float32),
          "ak": rng.standard_normal((64, 512), np.float32),
          "bk": rng.standard_normal((512, 64), np.float32)}
    sort = {"seed": 3, "exact": rng.uniform(size=2048).astype(np.float32),
            "overflow": (rng.exponential(size=2048) ** 3).astype(
                np.float32)}
    moe_job, moe_ref = _moe_case()
    pipe = {"layers": [(rng.standard_normal((8, 8), np.float32) * 0.3,
                        rng.standard_normal(8).astype(np.float32) * 0.1)
                       for _ in range(6)],
            "xs": rng.standard_normal((3, 2, 8), np.float32)}
    fwd_job = _forward_cases()
    train_job, train_refs = _train_case()
    decode_job = _decode_cases(models)
    elastic = _elastic_job(tmp)
    elastic["runs"] = [
        ("base", os.path.join(tmp, "ck_a"), list(range(4)), None),
        # the batch at the failure is consumed by it (as repro's runner
        # does); the survivors replay batches 2 and 3 from the step-2 save
        ("C", os.path.join(tmp, "ck_c"), list(range(4)) + [2, 3], (3, 5))]
    jobs = [("agree", {}), ("matmul", mm), ("sort", sort), ("moe_ep", moe_job),
            ("pipeline", pipe), ("forward", fwd_job), ("train", train_job),
            ("serve", _serve_cases(models)), ("decode", decode_job),
            ("elastic", elastic)]
    t0 = time.perf_counter()
    got = _spawn(8, jobs, tmp)
    print(f"8-rank spawn {time.perf_counter() - t0:.1f} s: {got['seconds']}")
    refs = {"matmul": mm, "sort": sort, "moe_ep": moe_ref,
            "pipeline": _seq_apply(pipe["layers"], pipe["xs"]),
            "forward": _forward_refs(fwd_job), "train": train_refs(),
            "serve": _serve_refs(models),
            "decode": _decode_refs(models, decode_job), "tmp": tmp}
    return got, refs


def _seq_case(models):
    """The (1, 5) mesh's job (the forward of reduced gemma2-2b,
    seamless-m4t-medium and zamba2-7b, gemma2's dense-cache prefill and
    train step, on ``from_jax`` weights) and a function that computes its
    references: the port unmeshed and JAX."""
    cj, ct, pj, pt = models[SEQ_ARCH]
    et = models[SEQ_ENCDEC][1]
    ht = models[SEQ_HYBRID][1]
    batch = global_batch_rowwise(DataConfig(seq_len=SEQ_LEN,
                                            global_batch=SEQ_BATCH,
                                            vocab=ct.vocab), 0)
    ebatch = global_batch_rowwise(
        DataConfig(seq_len=SEQ_TGT, global_batch=SEQ_BATCH, vocab=et.vocab,
                   src_len=SEQ_SRC), 0, d_model=et.d_model)
    hbatch = global_batch_rowwise(DataConfig(seq_len=SEQ_LEN,
                                             global_batch=SEQ_BATCH,
                                             vocab=ht.vocab), 0)
    cases = ((SEQ_ARCH, batch), (SEQ_ENCDEC, ebatch), (SEQ_HYBRID, hbatch))
    tokens = {"tokens": batch["tokens"]}
    tc = TrainConfig(opt=AdamWConfig(lr=1e-3))
    fresh = lambda: from_jax(jax.tree.map(np.asarray, pj), ct,  # noqa
                             "cpu")
    job = {"forward": [(arch, models[arch][1], models[arch][3], b)
                       for arch, b in cases],
           "prefill": (ct, pt, tokens, SEQ_MAX_SEQ),
           "train": (ct, tc, fresh(), batch)}

    def refs():
        out = {}
        for arch, b in cases:
            c_j, c_t, p_j, p_t = models[arch]
            with torch.no_grad():
                port = tmodels.forward(p_t, c_t, b, remat=False).numpy()
            bj = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
            out[arch] = {"port": port, "jax": np.asarray(
                jmodels.forward(p_j, c_j, bj, remat=False))}
        with torch.no_grad():
            lg, cache, lens = tmodels.prefill(pt, ct, tokens, SEQ_MAX_SEQ)
        lgj, cache_j, lens_j = jmodels.prefill(
            pj, cj, {"tokens": jnp.asarray(tokens["tokens"].numpy())},
            max_seq=SEQ_MAX_SEQ)
        out["prefill"] = {
            "port": (lg.numpy(), {k: v.numpy() for k, v in cache.items()},
                     lens.numpy()),
            "jax": (np.asarray(lgj), {k: np.asarray(v)
                                      for k, v in cache_j.items()},
                    np.asarray(lens_j))}
        out["train"] = _train_refs(cj, ct, pj, tc, batch, fresh(),
                                   seq=SEQ_LEN, global_batch=SEQ_BATCH)
        return out

    return job, refs


@pytest.fixture(scope="module")
def world5(world8, models, tmp_path_factory):
    """Restores world8's checkpoint at step 2 on 5 ranks (a (5, 1) mesh)
    and trains on through step 4; then sequence-parallel attention on a
    (1, 5) mesh (``check_seq_attention``).  Returns rank 0's results and,
    under "seq_refs", the references of the last."""
    tmp = world8[1]["tmp"]
    # run C's step-2 checkpoint (saved on 8 ranks before its failure) as
    # the latest of a fresh directory
    for sub in ("", "_state"):
        shutil.copytree(os.path.join(tmp, "ck_c" + sub, "step_00000002"),
                        os.path.join(tmp, "ck_b" + sub, "step_00000002"))
    job = _elastic_job(tmp)
    job["runs"] = [("B", os.path.join(tmp, "ck_b"), [2, 3], None)]
    seq_job, seq_refs = _seq_case(models)
    got = _spawn(5, [("elastic", job), ("seq_attention", seq_job)],
                 str(tmp_path_factory.mktemp("spmd5")))
    print(f"5-rank spawn: {got['seconds']}")
    got["seq_refs"] = seq_refs()
    return got


def test_paco_matmul_shmap_and_pjit(world8):
    got, refs = world8
    mm = refs["matmul"]
    r = got["matmul"]
    assert r["mesh"] == (4, 2, 1)     # make_paco_mesh(256, 192, 128, 8)
    want = mm["a"].astype(np.float64) @ mm["b"]
    np.testing.assert_allclose(r["shmap"], want, atol=MM_ATOL, rtol=0)
    np.testing.assert_allclose(r["pjit"], want, atol=MM_ATOL, rtol=0)
    np.testing.assert_allclose(r["pjit_k"], mm["ak"].astype(np.float64)
                               @ mm["bk"], atol=MM_ATOL, rtol=0)


def test_ranks_that_disagree_are_caught(world8):
    got, _ = world8
    assert got["agree"] == "tokens differs between ranks"


def _replay_sort(x, pivots, p, cap):
    """A single-process replay of the SPMD bucket rule: each rank's slice
    bucketed by the pivots (stable), the first ``cap`` of each bucket
    kept, received by the bucket's rank, sorted, +inf padded."""
    per = x.shape[0] // p
    recv = [[] for _ in range(p)]
    for src in range(p):
        xs = x[src * per:(src + 1) * per]
        bucket = np.searchsorted(pivots, xs, side="left")
        for dst in range(p):
            recv[dst].extend(xs[bucket == dst][:cap].tolist())
    out = np.full((p, p * cap), np.inf, np.float32)
    for dst in range(p):
        out[dst, :len(recv[dst])] = np.sort(np.asarray(recv[dst],
                                                       np.float32))
    return out.reshape(-1)


def test_paco_sort_shmap_exact_and_overflow(world8):
    got, refs = world8
    x = refs["sort"]["exact"]
    vals, valid = got["sort"]["exact"]
    np.testing.assert_array_equal(vals[valid], np.sort(x))
    xo = refs["sort"]["overflow"]
    vals, valid = got["sort"]["overflow"]
    pivots = choose_pivots(torch.from_numpy(xo), 8, torch.Generator()
                           .manual_seed(refs["sort"]["seed"])).numpy()
    want = _replay_sort(xo, pivots, 8, int(np.ceil(0.5 * 256 / 8)))
    assert valid.sum() < xo.size          # the capacity dropped some
    np.testing.assert_array_equal(vals, want)
    np.testing.assert_array_equal(valid, want != np.inf)


def test_apply_moe_paco_ep_matches_dense_top1(world8):
    got, refs = world8
    np.testing.assert_allclose(got["moe_ep"], refs["moe_ep"],
                               atol=MOE_ATOL, rtol=0)


def test_pipeline_apply_matches_sequential(world8):
    got, refs = world8
    np.testing.assert_allclose(got["pipeline"], refs["pipeline"],
                               atol=PIPE_ATOL, rtol=0)


@pytest.mark.parametrize("arch", FWD_ARCHS)
def test_sharded_forward_matches_unsharded(world8, arch):
    got, refs = world8
    np.testing.assert_allclose(got["forward"][arch], refs["forward"][arch],
                               atol=FWD_ATOL, rtol=0)


def test_sharded_train_step_matches_jax_and_port(world8):
    got, refs = world8
    r = got["train"]
    flat = _flat_np(r["params"])
    for ref, (loss_tol, leaf_tol) in (
            (refs["train"]["jax"], (TRAIN_LOSS_JAX, TRAIN_LEAF_JAX)),
            (refs["train"]["port"], (TRAIN_LOSS_PORT, TRAIN_LEAF_PORT))):
        loss, leaves = ref
        assert abs(r["loss"] - loss) < loss_tol
        assert set(leaves) == set(flat)
        for k in leaves:
            np.testing.assert_allclose(flat[k], leaves[k], atol=leaf_tol,
                                       rtol=0, err_msg=k)
    # the weights were really cut over the (2 data, 4 model) mesh
    assert "Shard" in r["placements"]["wq"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
@pytest.mark.parametrize("mode", list(SERVE_KW))
def test_meshed_engine_tokens_equal_unmeshed_and_jax(world8, arch, mode):
    got, refs = world8
    outs, prefill_calls, accepted = got["serve"][(arch, mode)]
    done, jax_tokens = refs["serve"][(arch, mode)]
    assert outs == {r.uid: r.out for r in done}
    for r, want in zip(done, jax_tokens):
        assert prefill_calls[r.uid] == -(-len(r.prompt) // 8)
        assert r.out == want, r.uid
    if mode == "spec":
        assert accepted > 0


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_meshed_dense_cache_decode_matches_unmeshed_and_jax(world8, arch):
    """Dense-cache prefill and 4 decode steps on a (2, 4) mesh of reduced
    qwen3 (its cache cut over the sequence: 2 KV heads on a model axis of
    4), deepseek-v2 (the latent cache, MoE in 2 groups) and seamless (the
    encoder's cross K/V written by the prefill), and 12 decode steps from
    the empty state of mamba2 and zamba2 (conv and SSM states, and the
    hybrid's shared-attention cache): logits, cache and lengths within
    DECODE_ATOL of the port on one device and of JAX's ``prefill`` /
    ``decode_step``."""
    got, refs = world8
    logits, cache, lens = got["decode"][arch]
    steps = (DECODE_PROMPT + DECODE_STEPS if arch in NO_PREFILL
             else DECODE_STEPS + 1)
    for who in ("port", "jax"):
        r_logits, r_cache, r_lens = refs["decode"][arch][who]
        assert len(logits) == len(r_logits) == steps
        for a, b in zip(logits, r_logits):
            np.testing.assert_allclose(a, b, atol=DECODE_ATOL, rtol=0)
        assert set(cache) == set(r_cache)
        for k in cache:
            np.testing.assert_allclose(cache[k], np.asarray(
                r_cache[k], np.float32), atol=DECODE_ATOL, rtol=0)
        np.testing.assert_array_equal(lens, r_lens)


def test_elastic_restart_8_to_5_ranks(world8, world5):
    got, _ = world8
    base, c = got["elastic"]["base"], got["elastic"]["C"]
    b = world5["elastic"]["B"]
    assert len(base) == 4 and len(c) == 5 and len(b) == 2
    # checkpoint at step 2 on 8 ranks, restore on 5 (a (5, 1) mesh)
    np.testing.assert_allclose(base[:2] + b, base, rtol=ELASTIC_RTOL)
    # in one group: ranks 5-7 leave at step 3, the 5 left replay from the
    # step-2 checkpoint
    np.testing.assert_allclose(c, base[:3] + base[2:], rtol=ELASTIC_RTOL)


def test_torchrun_train_mesh_2x2():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--reduced", "--arch", "qwen3-0.6b", "--device", "cpu", "--mesh",
         "2x2", "--steps", "2", "--batch", "4", "--seq", "32"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    losses = [float(line.split()[3]) for line in proc.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "mesh={'data': 2, 'model': 2}" in proc.stdout


@pytest.mark.parametrize("arch", [SEQ_ARCH, SEQ_ENCDEC, SEQ_HYBRID])
def test_sequence_parallel_forward_matches_unmeshed_and_jax(world5, arch):
    """On the (1, 5) mesh every attention of reduced gemma2-2b (4 query, 2
    KV heads), seamless-m4t-medium (4 and 4) and zamba2-7b's shared block
    (4 and 4) cuts its keys: each rank r took the block of Sk / 5 keys at
    r Sk / 5 (8 at 8r of 40 positions or source frames, 4 at 4r of
    seamless's 20 target tokens), and no other; the logits within
    FWD_ATOL of the port unmeshed and of JAX's unmeshed ``forward``.  K
    and V reach the key cut already laid out over the sequence (no rank
    held all of them)."""
    r = world5["seq_attention"]
    assert r["kv_layouts"][arch] == [KV_KEY_CUT]
    refs = world5["seq_refs"][arch]
    lengths = (SEQ_SRC, SEQ_TGT) if arch == SEQ_ENCDEC else (SEQ_LEN,)
    for rank, blocks in enumerate(r["blocks"]):
        assert blocks[arch] == sorted((n // 5, rank * n // 5)
                                      for n in lengths)
    for who in ("port", "jax"):
        np.testing.assert_allclose(r[arch], refs[who], atol=FWD_ATOL,
                                   rtol=0, err_msg=who)


def test_sequence_parallel_prefill_matches_unmeshed_and_jax(world5):
    """gemma2-2b's dense-cache prefill of 40 tokens on the (1, 5) mesh:
    the attention of each layer cuts its keys (rank r: 8 at 8r) while the
    cache of 80 positions is cut over the sequence; the last logits, every
    cache leaf and the lengths within DECODE_ATOL of the port unmeshed
    and of JAX's ``prefill``."""
    r = world5["seq_attention"]
    assert [b["prefill"] for b in r["blocks"]] == [[(8, 8 * i)]
                                                   for i in range(5)]
    assert r["kv_layouts"]["prefill"] == [KV_KEY_CUT]
    logits, cache, lens = r["prefill"]
    for who in ("port", "jax"):
        r_logits, r_cache, r_lens = world5["seq_refs"]["prefill"][who]
        np.testing.assert_allclose(logits, r_logits, atol=DECODE_ATOL,
                                   rtol=0, err_msg=who)
        assert set(cache) == set(r_cache)
        for k in cache:
            np.testing.assert_allclose(cache[k], np.asarray(
                r_cache[k], np.float32), atol=DECODE_ATOL, rtol=0,
                err_msg=f"{who} {k}")
        np.testing.assert_array_equal(lens, r_lens)


def test_sequence_parallel_train_step_matches_jax_and_port(world5):
    """One train step of reduced gemma2-2b at B 2 x S 40 on the (1, 5)
    mesh, through the key-block entries' plain versions and the merge's
    backward (dQ summed across the ranks, dK and dV on their blocks): the
    loss and every updated leaf against JAX's step and the port's, one
    device (the TRAIN_* tolerances), each rank on its block of 8 keys."""
    r = world5["seq_attention"]
    assert [b["train"] for b in r["blocks"]] == [[(8, 8 * i)]
                                                 for i in range(5)]
    assert r["kv_layouts"]["train"] == [KV_KEY_CUT]
    flat = _flat_np(r["train"]["params"])
    refs = world5["seq_refs"]["train"]
    for ref, (loss_tol, leaf_tol) in (
            (refs["jax"], (TRAIN_LOSS_JAX, TRAIN_LEAF_JAX)),
            (refs["port"], (TRAIN_LOSS_PORT, TRAIN_LEAF_PORT))):
        loss, leaves = ref
        assert abs(r["train"]["loss"] - loss) < loss_tol
        assert set(leaves) == set(flat)
        for k in leaves:
            np.testing.assert_allclose(flat[k], leaves[k], atol=leaf_tol,
                                       rtol=0, err_msg=k)
