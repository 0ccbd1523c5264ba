#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

  python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the script with a nonzero exit:

1. Device: the card's name, the device count and its power limit.
2. Build: every CUDA kernel of ``src/repro_torch/csrc`` with nvcc for
   sm_90a into ``build/repro_torch/`` (registers and shared memory from
   ``-Xptxas -v``).
3. Kernels against their plain versions: each hand-written kernel and its
   plain PyTorch version on the same CUDA inputs, at the serving shapes in
   bf16 and f32 and on small prime/odd geometries with a window and a
   softcap (tolerances: f32 atol 1e-4; bf16 atol 2e-2, since the plain
   version rounds the softmax weights to bf16 and the kernel keeps f32).
   Device times of the kernel, the plain version and one library call
   (``scaled_dot_product_attention`` on pre-gathered K/V), each from a
   CUDA-graph replay of many calls cycling through the 28 layers' pools
   (the eager per-call time of the kernel, host launch cost included, is
   printed beside it), and the bound from the shapes (bytes at 3.35 TB/s,
   flops at 989 TFLOP/s bf16).
4. One full-width qwen3-0.6b prompt chunk per slot and 8 decode ticks
   through the kernels and through the plain path (``use_kernel=False``)
   with the same seeded random weights, in float32 and in bf16: logits
   agree within MODEL_ATOL of the dtype, and greedy tokens agree wherever
   the plain path's top-2 margin exceeds it.
5. Serve: ``ServeEngine`` on full-width qwen3-0.6b (8 slots, max_seq 2048,
   page 64, chunk 64, 8 ticks per dispatch), 16 requests with prompt
   lengths drawn in [48, 1000] and 32 new tokens each.  The launch counts
   of both kernels are zeroed just before and read just after: prefill
   launches == prefill_calls * 28 and decode launches == decode_steps * 28.
   One served request is replayed through the plain path, teacher-forced,
   and its tokens must agree under the margin rule of phase 4.

The second-to-last line is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the rest of the repository beside it, the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Full-model logits of the kernel path vs the plain path, 28 layers deep.
# The paths differ only in how attention rounds: in float32 by summation
# order, so they agree to 1e-3 on logits of unit scale; in bf16 the plain
# version also rounds the softmax weights to bf16, and every layer's bf16
# activations carry a rounding step (2**-8 of the value) that the next
# layers of a random-weight model amplify, so logits of unit scale move by
# up to a tenth: 0.25 bounds that, and float32 shows the math is the same.
MODEL_ATOL = {torch.float32: 1e-3, torch.bfloat16: 0.25}
ARCH = "qwen3-0.6b"
ITERS = 200   # timed calls per kernel


def log(msg: str) -> None:
    print(msg, flush=True)


def _events_ms(run, iters: int) -> float:
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def time_ms(fn, iters: int) -> tuple[float, float]:
    """Mean ms per call of fn(i) over ``iters`` calls, by CUDA events after
    a warm-up: (device time, from one replay of a CUDA graph that captured
    the calls; eager time, host launch cost included)."""
    for i in range(3):
        fn(i)
    eager = _events_ms(lambda: [fn(i) for i in range(iters)], iters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    device = _events_ms(graph.replay, iters)
    del graph
    return device, eager


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_small_geometries(gen: torch.Generator) -> dict[str, float]:
    """The prime/odd pools, windows and softcaps of the repo's serving
    tests, in f32 and bf16: kernel vs plain version."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ops

    dev = "cuda"
    worst = {"paged_decode": 0.0, "paged_prefill": 0.0}

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for kw in ({}, {"window": 6}, {"logit_cap": 20.0},
                   {"window": 3, "logit_cap": 5.0}):
            b, hq, hkv, d, page, n_pages = 3, 4, 2, 16, 4, 13
            q = rnd(b, 1, hq, d, dtype=dtype)
            kp = rnd(n_pages, page, hkv, d, dtype=dtype)
            vp = rnd(n_pages, page, hkv, d, dtype=dtype)
            bt = torch.tensor([[0, 3, 5, 7], [1, 2, 4, 6], [8, 9, 10, 11]],
                              dtype=torch.int32, device=dev)
            lens = torch.tensor([5, 16, 1], dtype=torch.int32, device=dev)
            got = K.paged_flash_decode(q, kp, vp, bt, lens,
                                       scale=1 / math.sqrt(d), **kw)
            want = ops.paged_decode_attention(q, kp, vp, bt, lens,
                                              use_kernel=False, **kw)
            err = max_err(got, want)
            assert err <= ATOL[dtype], ("paged_decode", dtype, kw, err)
            worst["paged_decode"] = max(worst["paged_decode"], err)
        for kw in ({}, {"window": 5}, {"logit_cap": 20.0},
                   {"window": 3, "logit_cap": 5.0}):
            hq, hkv, d, page, n_pages, c = 4, 2, 16, 4, 13, 8
            q = rnd(1, c, hq, d, dtype=dtype)
            kp = rnd(n_pages, page, hkv, d, dtype=dtype)
            vp = rnd(n_pages, page, hkv, d, dtype=dtype)
            row = torch.tensor([2, 5, 7, 11], dtype=torch.int32, device=dev)
            got = K.paged_flash_prefill(q, kp, vp, row, 8,
                                        scale=1 / math.sqrt(d), **kw)
            want = ops.paged_prefill_attention(q, kp, vp, row, 8,
                                               use_kernel=False, **kw)
            err = max_err(got, want)
            assert err <= ATOL[dtype], ("paged_prefill", dtype, kw, err)
            worst["paged_prefill"] = max(worst["paged_prefill"], err)
        for page, pps, n_pages, c, start in [(3, 3, 11, 3, 3),
                                             (5, 2, 7, 5, 5),
                                             (2, 4, 13, 6, 0)]:
            hq, hkv, d = 4, 2, 8
            row = torch.randperm(n_pages, generator=gen, device=dev)[:pps]
            row = row.to(torch.int32)
            q = rnd(1, c, hq, d, dtype=dtype)
            kp = rnd(n_pages, page, hkv, d, dtype=dtype)
            vp = rnd(n_pages, page, hkv, d, dtype=dtype)
            got = K.paged_flash_prefill(q, kp, vp, row, start,
                                        scale=1 / math.sqrt(d))
            want = ops.paged_prefill_attention(q, kp, vp, row, start,
                                               use_kernel=False)
            err = max_err(got, want)
            assert err <= ATOL[dtype], ("paged_prefill", dtype, page, err)
            worst["paged_prefill"] = max(worst["paged_prefill"], err)
    return worst


def bench_kernels(cfg, gen: torch.Generator, iters: int) -> list[dict]:
    """Each kernel at the serving shapes of full-width qwen3-0.6b: checked
    against its plain version in f32 and bf16 (with and without a window
    and a softcap), then timed in bf16 over the 28 layers' pools in turn,
    so that each call finds its layer's K/V outside the 50 MB L2 as the
    serving loop does."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ops

    dev = "cuda"
    n_layers, hkv, d = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    hq, g = cfg.n_heads, cfg.n_heads // cfg.n_kv_heads
    slots, page, pps = 8, 64, 32
    n_pool = slots * pps + 1
    scale = 1 / math.sqrt(d)
    rows = []

    # ---- decode: B=8 slots, lengths as the serving run's contexts
    lens = torch.randint(48, 1000 + 32 + 1, (slots,), generator=gen,
                         device=dev, dtype=torch.int32)
    perm = torch.randperm(n_pool - 1, generator=gen, device=dev)
    bt = perm[:slots * pps].reshape(slots, pps).to(torch.int32).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(slots, 1, hq, d, generator=gen, device=dev).to(dtype)
        kp = torch.randn(n_pool, page, hkv, d, generator=gen,
                         device=dev).to(dtype)
        vp = torch.randn(n_pool, page, hkv, d, generator=gen,
                         device=dev).to(dtype)
        for kw in ({}, {"window": 300}, {"logit_cap": 30.0}):
            err = max_err(K.paged_flash_decode(q, kp, vp, bt, lens,
                                               scale=scale, **kw),
                          ops.paged_decode_attention(q, kp, vp, bt, lens,
                                                     use_kernel=False, **kw))
            assert err <= ATOL[dtype], ("paged_decode", dtype, kw, err)
    err_decode = err   # bf16, softcap: the last checked case
    del kp, vp

    # ---- the 28 layers' pools, bf16
    dtype = torch.bfloat16
    kpool = torch.randn(n_layers, n_pool, page, hkv, d, generator=gen,
                        device=dev).to(dtype)
    vpool = torch.randn(n_layers, n_pool, page, hkv, d, generator=gen,
                        device=dev).to(dtype)
    q = torch.randn(slots, 1, hq, d, generator=gen, device=dev).to(dtype)
    err_decode = max(err_decode, max_err(
        K.paged_flash_decode(q, kpool[0], vpool[0], bt, lens, scale=scale),
        ops.paged_decode_attention(q, kpool[0], vpool[0], bt, lens,
                                   use_kernel=False)))
    assert err_decode <= ATOL[dtype], ("paged_decode", err_decode)
    ms, eager_ms = time_ms(lambda i: K.paged_flash_decode(
        q, kpool[i % n_layers], vpool[i % n_layers], bt, lens, scale=scale),
        iters)
    plain_ms, _ = time_ms(lambda i: ops.paged_decode_attention(
        q, kpool[i % n_layers], vpool[i % n_layers], bt, lens,
        use_kernel=False), max(iters // 4, 10))
    # library yardstick: SDPA over K/V pre-gathered to (B, Hkv, S, D)
    s_max = int(lens.max())
    ctx_pages = -(-s_max // page)
    kg = [ops.gather_kv_pages(kpool[i], bt[:, :ctx_pages])[:, :s_max]
          .transpose(1, 2).contiguous() for i in range(n_layers)]
    vg = [ops.gather_kv_pages(vpool[i], bt[:, :ctx_pages])[:, :s_max]
          .transpose(1, 2).contiguous() for i in range(n_layers)]
    mask = (torch.arange(s_max, device=dev)[None, :] < lens[:, None])
    mask = mask[:, None, None, :]
    qt = q.transpose(1, 2)
    library_ms, _ = time_ms(lambda i: torch.nn.functional.
                            scaled_dot_product_attention(
                                qt, kg[i % n_layers], vg[i % n_layers],
                                attn_mask=mask, enable_gqa=True), iters)
    del kg, vg
    n_keys = int(lens.sum())
    nbytes = (2 * q.numel() * 2 + bt.numel() * 4 + lens.numel() * 4
              + 2 * n_keys * hkv * d * 2)
    flops = 4 * n_keys * hq * d
    rows.append(_row("paged_decode", "src/repro_torch/csrc/paged_decode.cu",
                     "src/repro/kernels/attention/attention.py:371",
                     err_decode, ms, eager_ms, plain_ms, library_ms, nbytes,
                     flops, dtype))

    # ---- prefill: one 64-token chunk at start 960 of a ~1000-token prompt
    c, start, width = 64, 960, 16
    row = perm[:width].to(torch.int32).contiguous()
    err_prefill = 0.0
    for dt in (torch.float32, torch.bfloat16):
        qc = torch.randn(1, c, hq, d, generator=gen, device=dev).to(dt)
        kp = kpool[0].to(dt)
        vp = vpool[0].to(dt)
        for kw in ({}, {"window": 300}, {"logit_cap": 30.0}):
            err = max_err(K.paged_flash_prefill(qc, kp, vp, row, start,
                                                scale=scale, **kw),
                          ops.paged_prefill_attention(qc, kp, vp, row, start,
                                                      use_kernel=False,
                                                      **kw))
            assert err <= ATOL[dt], ("paged_prefill", dt, kw, err)
            if dt == torch.bfloat16:
                err_prefill = max(err_prefill, err)
    qc = torch.randn(1, c, hq, d, generator=gen, device=dev).to(dtype)
    ms, eager_ms = time_ms(lambda i: K.paged_flash_prefill(
        qc, kpool[i % n_layers], vpool[i % n_layers], row, start,
        scale=scale), iters)
    plain_ms, _ = time_ms(lambda i: ops.paged_prefill_attention(
        qc, kpool[i % n_layers], vpool[i % n_layers], row, start,
        use_kernel=False), max(iters // 4, 10))
    s_ctx = start + c
    kg = [ops.gather_kv_pages(kpool[i], row[None])[:, :s_ctx]
          .transpose(1, 2).contiguous() for i in range(n_layers)]
    vg = [ops.gather_kv_pages(vpool[i], row[None])[:, :s_ctx]
          .transpose(1, 2).contiguous() for i in range(n_layers)]
    q_pos = start + torch.arange(c, device=dev)[:, None]
    cmask = q_pos >= torch.arange(s_ctx, device=dev)[None, :]
    qt = qc.transpose(1, 2)
    library_ms, _ = time_ms(lambda i: torch.nn.functional.
                            scaled_dot_product_attention(
                                qt, kg[i % n_layers], vg[i % n_layers],
                                attn_mask=cmask, enable_gqa=True), iters)
    del kg, vg, kpool, vpool
    pairs = int(cmask.sum())
    nbytes = (2 * qc.numel() * 2 + row.numel() * 4
              + 2 * s_ctx * hkv * d * 2)
    flops = 4 * pairs * hq * d
    rows.append(_row("paged_prefill",
                     "src/repro_torch/csrc/paged_prefill.cu",
                     "src/repro/kernels/attention/attention.py:172",
                     err_prefill, ms, eager_ms, plain_ms, library_ms, nbytes,
                     flops, dtype))
    return rows


def _row(name, source, replaces, err, ms, eager_ms, plain_ms, library_ms,
         nbytes, flops, dtype) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations",
            "bytes": nbytes, "flops": flops}


# ---------------------------------------------------------------------------
# phase 4: one chunk and 8 ticks at full width, kernels vs plain path
# ---------------------------------------------------------------------------

def margin_agrees(logits_plain: torch.Tensor, tok: torch.Tensor,
                  tol: float) -> bool:
    """Each row's token equals the plain argmax wherever the plain top-2
    margin exceeds ``tol``."""
    top2 = torch.topk(logits_plain.float(), 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    ok = (logits_plain.argmax(-1) == tok) | (margin <= tol)
    return bool(ok.all())


def full_width_parity(cfg, params, rng: np.random.Generator) -> dict:
    tol = MODEL_ATOL[cfg.dtype]
    from repro_torch.models import (decode_step_paged,
                                    paged_cache_leaf_specs, prefill_chunk)
    from repro_torch.serve.paging import init_pool

    slots, page, c = 8, 64, 64
    pools = {uk: init_pool(paged_cache_leaf_specs(cfg, page), 2 * slots,
                           page, "cuda").pools for uk in (True, False)}
    bt = torch.arange(2 * slots, dtype=torch.int32,
                      device="cuda").reshape(slots, 2)
    prompts = rng.integers(0, cfg.vocab, size=(slots, c))
    worst = 0.0
    first = []
    for s in range(slots):
        toks = torch.tensor(prompts[s:s + 1], dtype=torch.int32,
                            device="cuda")
        out = {uk: prefill_chunk(params, cfg, toks, 0, pools[uk], bt[s],
                                 use_kernel=uk)[0] for uk in (True, False)}
        worst = max(worst, max_err(out[True], out[False]))
        assert margin_agrees(out[False], out[True].argmax(-1), tol)
        first.append(int(out[False][c - 1].argmax()))
    cur = torch.tensor(first, dtype=torch.int32, device="cuda")
    lens = torch.full((slots,), c, dtype=torch.int32, device="cuda")
    for _ in range(8):
        out = {uk: decode_step_paged(params, cfg, cur[:, None], pools[uk],
                                     bt, lens, use_kernel=uk)[0]
               for uk in (True, False)}
        worst = max(worst, max_err(out[True], out[False]))
        assert torch.isfinite(out[True]).all()
        assert margin_agrees(out[False], out[True].argmax(-1), tol)
        cur = out[False].argmax(-1).to(torch.int32)   # teacher-forced
        lens = lens + 1
    assert worst <= tol, ("full-width logits", cfg.dtype, worst)
    return {"dtype": str(cfg.dtype), "max_abs_logit_err": worst,
            "atol": tol, "slots": slots, "chunk": c, "ticks": 8}


# ---------------------------------------------------------------------------
# phase 5: serve
# ---------------------------------------------------------------------------

def replay_plain(engine, params, cfg, req) -> None:
    """Teacher-force ``req``'s prompt and served tokens through the plain
    path (``use_kernel=False``) on a fresh pool: every served token must be
    the plain argmax wherever the plain top-2 margin exceeds the
    tolerance."""
    from repro_torch.models import (decode_step_paged,
                                    paged_cache_leaf_specs, prefill_chunk)
    from repro_torch.serve.paging import init_pool

    page, chunk = engine.page, engine.chunk
    ctx = list(req.prompt)
    n_pages = engine.pages_per_seq
    pages = init_pool(paged_cache_leaf_specs(cfg, page), n_pages, page,
                      "cuda").pools
    row = torch.arange(n_pages, dtype=torch.int32, device="cuda")
    logits = None
    for i in range(0, len(ctx), chunk):
        toks = ctx[i:i + chunk] + [0] * max(0, i + chunk - len(ctx))
        logits, pages = prefill_chunk(
            params, cfg, torch.tensor([toks], dtype=torch.int32,
                                      device="cuda"),
            i, pages, row, use_kernel=False)
    step = logits[(len(ctx) - 1) % chunk][None]
    lens = torch.tensor([len(ctx)], dtype=torch.int32, device="cuda")
    for t, tok in enumerate(req.out):
        tok_t = torch.tensor([tok], dtype=torch.int32, device="cuda")
        assert margin_agrees(step, tok_t, MODEL_ATOL[cfg.dtype]), \
            (req.uid, t)
        if t + 1 < len(req.out):
            step, pages = decode_step_paged(params, cfg, tok_t[:, None],
                                            pages, row[None], lens,
                                            use_kernel=False)
            lens = lens + 1


def serve(cfg, params, rng: np.random.Generator, seed: int) -> dict:
    from repro_torch.kernels.attention import attention as K
    from repro_torch.serve import Request, ServeEngine

    engine = ServeEngine(params, cfg, slots=8, max_seq=2048,
                         ticks_per_dispatch=8, seed=seed, device="cuda")
    assert (engine.page, engine.chunk, engine.pages_per_seq) == (64, 64, 32)
    lengths = rng.integers(48, 1001, size=16)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab,
                                               size=n).tolist(),
                    max_new_tokens=32) for i, n in enumerate(lengths)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.paged_flash_prefill.launches = 0
    K.paged_flash_decode.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_prefill": K.paged_flash_prefill.launches,
                "paged_decode": K.paged_flash_decode.launches}
    engine.check_page_invariants()
    st = engine.stats
    assert len(done) == 16, len(done)
    assert all(len(r.out) == 32 for r in done), [len(r.out) for r in done]
    assert all(0 <= t < cfg.vocab for r in done for t in r.out)
    assert launches["paged_prefill"] == st["prefill_calls"] * cfg.n_layers, \
        (launches, st["prefill_calls"])
    assert launches["paged_decode"] == st["decode_steps"] * cfg.n_layers, \
        (launches, st["decode_steps"])
    assert launches["paged_prefill"] > 0 and launches["paged_decode"] > 0
    gen_tokens = sum(len(r.out) for r in done)
    out = {"requests": len(done), "generated_tokens": gen_tokens,
           "prompt_tokens": int(lengths.sum()), "wall_s": wall,
           "tokens_per_s": gen_tokens / wall,
           "prefill_s": st["prefill_s"], "decode_s": st["decode_s"],
           "prefill_calls": st["prefill_calls"],
           "decode_steps": st["decode_steps"],
           "dispatches": st["dispatches"],
           "preemptions": st["preemptions"],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    replay_plain(engine, params, cfg,
                 max(done, key=lambda r: len(r.prompt)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.kernels.build import LIBS
    from repro_torch.models import init_params, param_count

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)

    # 2. build
    LIBS.build_all()
    log(f"[build] nvcc sm_90a, {len(LIBS.ptxas_log)} libraries in "
        f"{LIBS.build_seconds:.1f}s")
    for lib, text in sorted(LIBS.ptxas_log.items()):
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"[build] {lib}: {line.strip()}")

    # 3. kernels against their plain versions
    cfg = get_arch(ARCH)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    worst = check_small_geometries(gen)
    log(f"[kernels] small prime/window/softcap geometries ok: "
        f"max err {worst}")
    rows = bench_kernels(cfg, gen, ITERS)
    for r in rows:
        log(f"[kernels] {r['name']}: err {r['max_abs_err']:.3g} kernel "
            f"{r['ms']:.4f} ms (eager call {r['eager_ms']:.4f} ms) plain "
            f"{r['plain_ms']:.4f} ms library "
            f"{r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}); {smi}")

    # 4. one chunk and 8 ticks at full width, float32 then bf16
    rng = np.random.default_rng(args.seed)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    parity = full_width_parity(
        cfg32, init_params(cfg32, seed=args.seed, device="cuda"), rng)
    log(f"[model] kernel path vs plain path: {json.dumps(parity)}")
    params = init_params(cfg, seed=args.seed, device="cuda")
    log(f"[model] {cfg.name} full width, {param_count(params)} params "
        f"{cfg.dtype}")
    parity = full_width_parity(cfg, params, rng)
    log(f"[model] kernel path vs plain path: {json.dumps(parity)}")

    # 5. serve
    result = serve(cfg, params, rng, args.seed)
    log(f"[serve] {json.dumps(result)}; card: {smi}")
    for r in rows:
        r["launches"] = result["launches"][r["name"]]
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
