"""The rank side of ``test_torch_spmd.py``: one process of a gloo group on
the CPU.  ``main`` joins the group over a ``FileStore``, runs every check
the job file names, in order (each rank alike: the checks are collective),
and rank 0 writes the results for the parent to hold against its
references.  Imports torch and the port only."""
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    from repro_torch.dist.act_sharding import replicate
    return replicate(t).detach().cpu().numpy()


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


def check_matmul(job):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import (make_paco_mesh, paco_matmul_pjit,
                                  paco_matmul_shmap)
    out = {}
    a, b = _t(job["a"]), _t(job["b"])
    mesh = make_paco_mesh(a.shape[0], b.shape[1], a.shape[1],
                          dist.get_world_size())
    out["mesh"] = tuple(mesh.mesh.shape)
    out["shmap"] = _np(paco_matmul_shmap(a, b, mesh))
    mesh1 = init_device_mesh("cpu", (dist.get_world_size(),),
                             mesh_dim_names=("model",))
    out["pjit"] = _np(paco_matmul_pjit(a, b, mesh1, "model"))
    ak, bk = _t(job["ak"]), _t(job["bk"])     # k-dominant: a Partial C
    out["pjit_k"] = _np(paco_matmul_pjit(ak, bk, mesh1, "model"))
    return out


def check_sort(job):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import paco_sort_shmap
    mesh = init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("p",))
    out = {}
    for name, cf in (("exact", 4.0), ("overflow", 0.5)):
        gen = torch.Generator().manual_seed(job["seed"])
        vals, valid = paco_sort_shmap(_t(job[name]), mesh, "p", gen,
                                      capacity_factor=cf)
        out[name] = (_np(vals), _np(valid))
    return out


def check_moe_ep(job):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.moe import apply_moe_paco_ep
    mesh = init_device_mesh("cpu", (dist.get_world_size(),),
                            mesh_dim_names=("model",))
    p = {k: _t(v) for k, v in job["params"].items()}
    return _np(apply_moe_paco_ep(p, job["cfg"], _t(job["x"]), mesh,
                                 "model"))


def check_pipeline(job):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist.pipeline import pipeline_apply, stack_stage_params
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "stage"))
    layers = [{"w": _t(w), "b": _t(b)} for w, b in job["layers"]]
    stage, mask = stack_stage_params(layers, 4)
    return _np(pipeline_apply(stage, mask, _t(job["xs"]), _apply_layer,
                              mesh, "stage"))


def _apply_layer(p, x):
    return torch.tanh(x @ p["w"] + p["b"]) + x


def check_forward(job):
    from repro_torch.dist import act_sharding as act
    from repro_torch.dist import sharding as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import forward
    mesh = make_host_mesh((4, 2), device_type="cpu")
    out = {}
    for arch, cfg, params, batch in job["cases"]:
        params = {k: v for k, v in params.items()}
        ps = D.distribute(mesh, params, D.param_specs(cfg, params, mesh))
        bs = D.distribute(mesh, batch, D.batch_specs(cfg, mesh, batch))
        with act.use_mesh_rules(mesh), torch.no_grad():
            out[arch] = _np(forward(ps, cfg, bs, remat=False))
    return out


def check_train(job):
    from repro_torch.dist import sharding as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import init_train_state, train_step
    mesh = make_host_mesh((2, 4), device_type="cpu")
    cfg, tcfg, params, batch = job["cfg"], job["tcfg"], job["params"], \
        job["batch"]
    ps = D.distribute(mesh, params, D.param_specs(cfg, params, mesh))
    state = init_train_state(cfg, tcfg, ps)
    bs = D.distribute(mesh, batch, D.batch_specs(cfg, mesh, batch))
    ps, state, metrics = train_step(ps, state, bs, cfg=cfg, tcfg=tcfg)
    return {"loss": float(metrics["loss"]), "params": _tree_np(ps),
            "placements": {k: str(v.placements) for k, v
                           in ps["blocks"]["attn"].items()}}


def check_serve(job):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import Request, ServeEngine
    mesh = make_host_mesh((4, 2), device_type="cpu")
    out = {}
    for key, cfg, params, kw, prompts, max_new in job["cases"]:
        eng = ServeEngine(params, cfg, mesh=mesh, device="cpu", **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p, max_new_tokens=max_new))
        done = eng.run_until_drained()
        eng.check_page_invariants()
        out[key] = ({r.uid: r.out for r in done},
                    {r.uid: r.prefill_calls for r in done},
                    eng.stats["accepted_tokens"])
    return out


def check_decode(job):
    """Dense-cache prefill, then teacher-forced decode steps, on a (2, 4)
    mesh: each step's logits, the final cache and lengths, whole.  SSM
    and hybrid configs have no prefill (as in ``repro``): they decode
    every token from the empty state, laid out by ``cache_specs``."""
    from repro_torch.dist import act_sharding as act
    from repro_torch.dist import sharding as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import decode_step, init_cache, prefill
    mesh = make_host_mesh((2, 4), device_type="cpu")
    out = {}
    for arch, cfg, params, tokens, src, prompt, max_seq in job["cases"]:
        ps = D.distribute(mesh, params, D.param_specs(cfg, params, mesh))
        toks = _t(tokens)
        b = toks.shape[0]
        if prompt == 0:
            cache = init_cache(cfg, b, max_seq, device="cpu")
            cache = D.distribute(mesh, cache, D.cache_specs(cfg, mesh, cache))
            lengths = D.distribute(
                mesh, {"n": torch.zeros((b,), dtype=torch.int32)},
                {"n": ("data",)})["n"]
        else:
            batch = {"tokens": toks[:, :prompt].contiguous()}
            if src is not None:
                batch["src_emb"] = _t(src)
            bs = D.distribute(mesh, batch, D.batch_specs(cfg, mesh, batch))
        with act.use_mesh_rules(mesh), torch.no_grad():
            logits = []
            if prompt:
                lg, cache, lengths = prefill(ps, cfg, bs, max_seq)
                logits.append(_np(lg))
            for t in range(prompt, toks.shape[1]):
                tok = D.distribute(mesh, {"t": toks[:, t:t + 1].contiguous()},
                                   {"t": ("data", None)})["t"]
                lg, cache, lengths = decode_step(ps, cfg, tok, cache,
                                                 lengths)
                logits.append(_np(lg))
        out[arch] = (logits, _tree_np(cache), _np(lengths))
    return out


def check_elastic(job):
    """Every rank runs the runner; rank 0 reports the losses."""
    from repro_torch.data.pipeline import global_batch_rowwise
    from repro_torch.dist import sharding as D
    from repro_torch.ft import ElasticRunner
    from repro_torch.train import init_train_state, train_step
    cfg, tcfg, dcfg, params0 = (job["cfg"], job["tcfg"], job["dcfg"],
                                job["params"])

    def build(mesh):
        # a fresh copy: ``distribute`` shares the storage of whole blocks,
        # and the step updates params in place
        fresh = D.tree_map(torch.clone, params0)
        ps = D.distribute(mesh, fresh, D.param_specs(cfg, fresh, mesh))
        state = init_train_state(cfg, tcfg, ps)

        def step_fn(p, s, batch):
            bs = D.distribute(mesh, batch, D.batch_specs(cfg, mesh, batch))
            return train_step(p, s, bs, cfg=cfg, tcfg=tcfg)
        return {"params": ps, "state": state, "step_fn": step_fn}

    out = {}
    for name, ckpt, steps, fail in job["runs"]:
        batches = [global_batch_rowwise(dcfg, i) for i in steps]
        kw = {} if fail is None else {"fail_at": fail[0],
                                      "surviving": fail[1]}
        runner = ElasticRunner(ckpt, build, save_every=job["save_every"])
        _, _, losses = runner.run(dist.get_world_size(), batches, **kw)
        out[name] = losses
        dist.barrier()
    return out


def check_agree(job):
    """``assert_replicated`` passes tokens equal on every rank and raises
    on every rank when one rank's differ."""
    from repro_torch.dist.act_sharding import assert_replicated
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh((4, 2), device_type="cpu")
    toks = torch.arange(6)
    assert_replicated(toks, mesh, "tokens")
    try:
        assert_replicated(toks + (dist.get_rank() == 5), mesh, "tokens")
    except RuntimeError as e:
        return str(e)
    return None


def check_seq_attention(job):
    """Sequence-parallel attention on a (1, 5) mesh, whose model axis of 5
    divides neither reduced gemma2-2b's 4 query heads nor its 2 KV heads:
    the forward logits of gemma2, seamless-m4t-medium (its encoder,
    decoder and cross-attention all cut their keys) and zamba2-7b (the
    hybrid's shared attention block), gemma2's dense-cache prefill
    (logits, cache, lengths) and one gemma2 train step.  Each rank also
    reports the (length, offset) of every key block its
    ``layers._key_block_attention`` took, per case, gathered to rank 0,
    and the placements of the K and V that reached the key cut."""
    from repro_torch.dist import act_sharding as act
    from repro_torch.dist import sharding as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import forward, layers, prefill
    from repro_torch.train import init_train_state, train_step
    mesh = make_host_mesh((1, 5), device_type="cpu")
    inner, seen = layers._key_block_attention, set()
    inner_sh, laid = layers._sharded_attention, set()

    def spy(q, k, v, qp, kp, k_off, blocks, **kw):
        seen.add((k.shape[1], k_off))
        return inner(q, k, v, qp, kp, k_off, blocks, **kw)

    def spy_sh(q, k, v, **kw):
        # per mesh dim the tensor dim it cuts, None where it cuts none
        laid.add(tuple(tuple(p.dim if p.is_shard() else None
                             for p in t.placements) for t in (k, v)))
        return inner_sh(q, k, v, **kw)

    out, blocks, layouts = {}, {}, {}
    layers._key_block_attention = spy
    layers._sharded_attention = spy_sh
    try:
        for arch, cfg, params, batch in job["forward"]:
            ps = D.distribute(mesh, params, D.param_specs(cfg, params, mesh))
            bs = D.distribute(mesh, batch, D.batch_specs(cfg, mesh, batch))
            with act.use_mesh_rules(mesh), torch.no_grad():
                out[arch] = _np(forward(ps, cfg, bs, remat=False))
            blocks[arch], seen = sorted(seen), set()
            layouts[arch], laid = sorted(laid), set()
        cfg, params, batch, max_seq = job["prefill"]
        ps = D.distribute(mesh, params, D.param_specs(cfg, params, mesh))
        bs = D.distribute(mesh, batch, D.batch_specs(cfg, mesh, batch))
        with act.use_mesh_rules(mesh), torch.no_grad():
            lg, cache, lengths = prefill(ps, cfg, bs, max_seq)
            out["prefill"] = (_np(lg), _tree_np(cache), _np(lengths))
        blocks["prefill"], seen = sorted(seen), set()
        layouts["prefill"], laid = sorted(laid), set()
        cfg, tcfg, params, batch = job["train"]
        ps = D.distribute(mesh, params, D.param_specs(cfg, params, mesh))
        state = init_train_state(cfg, tcfg, ps)
        bs = D.distribute(mesh, batch, D.batch_specs(cfg, mesh, batch))
        ps, state, metrics = train_step(ps, state, bs, cfg=cfg, tcfg=tcfg)
        out["train"] = {"loss": float(metrics["loss"]),
                        "params": _tree_np(ps)}
        blocks["train"] = sorted(seen)
        layouts["train"] = sorted(laid)
    finally:
        layers._key_block_attention = inner
        layers._sharded_attention = inner_sh
    out["kv_layouts"] = layouts
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, blocks)
    out["blocks"] = ranks
    return out


CHECKS = {"agree": check_agree, "matmul": check_matmul, "sort": check_sort,
          "moe_ep": check_moe_ep, "pipeline": check_pipeline,
          "forward": check_forward, "train": check_train,
          "serve": check_serve, "decode": check_decode,
          "elastic": check_elastic, "seq_attention": check_seq_attention}


def main(rank, world, store_path, job_path, out_path):
    import faulthandler
    faulthandler.dump_traceback_later(int(os.environ.get(
        "SPMD_RANK_TIMEOUT", 600)), exit=True)
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    with open(job_path, "rb") as f:
        jobs = pickle.load(f)
    results = {}
    try:
        for name, job in jobs:
            t0 = time.perf_counter()
            results[name] = CHECKS[name](job)
            results.setdefault("seconds", {})[name] = (time.perf_counter()
                                                       - t0)
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        raise
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()
