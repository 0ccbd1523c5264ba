"""The dense flash kernels on the card, in one short call: build, check,
time and profile them, for iterating on ``csrc/flash_wgmma.cuh``.

  PYTHONPATH=src python -m repro_torch.launch.flash_bench [--seed N]
      [--ablate]

1. The balance of the wgmma kernels' persistent grid at the training shape
   (no card needed): for each pass, the busiest CTA's work over the mean,
   counting key (or query) tiles per item, for the snake order the kernels
   use and for a plain stride of the grid.
2. Build every kernel (``kernels.build``), print each wgmma kernel's
   registers and spills from ``-Xptxas -v`` and the HGMMA and UTMALDG
   counts of the two flash libraries; stop if a wgmma kernel did not get
   168 registers (its ``setmaxnreg`` split assumes them).
3. Fifteen small bf16 geometries (G 1 to 8, D 64, 112, 128 and 256, S 77
   to 2048, causal or not, windows, softcaps): forward and backward against
   the plain versions (relative to max(1, max |plain|), as
   ``chip_smoke.py``'s FLASH_TOL), the backward bitwise equal over two
   calls, and the launches counted by variant; then the key-block entries
   at D 256 (three blocks at their offsets, rows that see no key of a
   block among them) against ``ref.attention_block_ref`` and its gradient.
4. The training shape of qwen3-0.6b (B 2, Hq 16, Hkv 8, S 4096, D 128,
   causal) and gemma2-2b's (B 2, Hq 8, Hkv 4, S 4096, D 256, causal,
   without and with its softcap of 50):
   forward and backward times from CUDA events over 20 calls, and each
   kernel's device time per call from ``torch.profiler``; then the key
   block of rank 0 at gemma2-2b's train_4k cut (256 keys at offset 0 of
   S 4096, softcap 50) at B 1 and B 16, both entries.
5. The split family (rows 5x, 5bx, 5t, 5bt): seamless-m4t-medium's
   cross-attention (B 2, Hq = Hkv = 16, Sq 256 against Sk 1024, D 64, no
   mask), its decoder self-attention (S 256, causal) and the cross shape
   of its 32-token teacher-forced forward (Sq 32), each call at the
   rank count the library picks and at 1 and 2 ranks
   (``flash_fwd_split``, ``flash_bwd_split``) from CUDA graphs, each
   launch of the backward timed alone by ``torch.profiler``.
6. The float32 family (``csrc/flash_tf32.cuh``, variant
   ``wgmma_tf32x3``: f32 at D 64 and 128 as three TF32 products): small
   geometries (G 1 to 8, Sq != Sk, masks, softcaps, both entries) against
   the plain versions within FLASH_TOL_F32 (O over max(1, max |plain|),
   each gradient over its own max), the backward bitwise equal over two
   calls; then rows 5f and 5bf (row 5's shape and seamless's cross
   shape in float32) from CUDA graphs, each launch of the pair (the
   pre-passes, the forward's walk; Delta, the dQ, dV and dK passes) timed
   alone by ``torch.profiler``.
7. With ``--ablate``: copies of the two flash libraries built into
   ``build/flash_bench/`` and called through their split entries: one
   with clusters of 4 (``FLASH_MAX_RANKS`` 4), at each split shape
   against the unchanged copy at 2 ranks (O and dQ within FLASH_TOL of
   it); and one for each of ``csrc/flash_wgmma.cuh``'s ablation macros
   (a part taken out), at the cross shape at 2 ranks: the walk without
   products (every wgmma product skipped), without loads (no TMA load;
   the barriers complete by a plain arrival), without the ranks' merge
   (partials staged, the cluster's barriers kept, nothing read or
   stored) and without the walk (every rank's share of the key tiles
   empty).  The ablated copies compute garbage and are not checked.
   And copies for each of ``csrc/flash_tf32.cuh``'s macros
   (``TF32_ABLATIONS``), called through ``flash_fwd_tf32x3`` and
   ``flash_bwd_tf32x3`` at rows 5f's and 5bf's shapes beside the
   unchanged copy: one TF32 product a product (A_hi B_hi alone; its
   error printed), no products, no pre-passes.

Exits 1 if a check fails, 2 without a card.  ``chip_smoke.py`` holds the
kernels to the same bounds at more shapes and times them beside SDPA.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

FLASH_TOL = 2e-2   # bf16, relative to max(1, max |plain|)
FLASH_TOL_F32 = 1e-4   # float32 (chip_smoke.FLASH_TOL)
SMS = 132          # the H100's SMs: the persistent grid's size
CASES = [  # (B, G, D, S, options); Hkv 2
    (1, 1, 64, 128, {"causal": False}),
    (1, 1, 128, 128, {"causal": False}),
    (1, 2, 128, 256, {"causal": True}),
    (2, 2, 128, 77, {"causal": True}),
    (2, 3, 64, 77, {"causal": True, "window": 9}),
    (2, 6, 128, 300, {"causal": True, "logit_cap": 5.0}),
    (2, 8, 64, 200, {"causal": False, "window": 20, "logit_cap": 30.0}),
    (2, 1, 128, 1000, {"causal": True}),
    (1, 1, 112, 2048, {"causal": True}),      # zamba2's shared block
    (2, 2, 112, 77, {"causal": True, "window": 9}),
    (1, 1, 256, 128, {"causal": False}),      # gemma2-2b's head_dim
    (2, 2, 256, 77, {"causal": True, "window": 9}),
    (2, 8, 256, 300, {"causal": True, "logit_cap": 5.0}),
    (1, 3, 256, 333, {"causal": False, "window": 20, "logit_cap": 30.0}),
    (1, 2, 256, 1000, {"causal": True, "logit_cap": 50.0}),
]
BLOCK_CASES = [  # (B, G, Sq, Sk, the blocks' bounds, options) at D 256
    (1, 2, 300, 300, (0, 100, 217, 300), {"causal": True}),
    (2, 2, 300, 300, (0, 64, 200, 300),
     {"causal": True, "window": 40, "logit_cap": 50.0}),
    (1, 1, 200, 300, (0, 150, 300), {"causal": False}),
]



def cta_loads(lengths: list[int], sms: int, snake: bool) -> list[int]:
    """Work per CTA of a persistent grid of ``sms`` CTAs over items of
    these lengths (longest first): CTA c takes item c of every round of
    sms items, or, in the snake order of ``item_index`` in
    ``csrc/flash_wgmma.cuh``, item c of an even round and c from the end
    of an odd one."""
    loads = [0] * sms
    for it, n in enumerate(lengths):
        r, c = divmod(it, sms)
        loads[sms - 1 - c if snake and r % 2 else c] += n
    return loads


def balance(s: int = 4096, g: int = 2, hkv: int = 8, b: int = 2,
            sms: int = SMS) -> dict:
    """Busiest CTA over the mean, causal, per pass and order: the forward
    (128-key tiles) and dQ pass (64-key tiles) over query blocks of
    128 / G positions, longest first; the dK/dV pass (64-query tiles x G
    heads) over 128-key blocks."""
    bq = 128 // g
    blocks = range(-(-s // bq) - 1, -1, -1)          # longest first
    fwd = [-(-min(c * bq + bq, s) // 128) for c in blocks]
    dq = [-(-min(c * bq + bq, s) // 64) for c in blocks]
    dkv = [g * -(-(s - k * 128) // 64) for k in range(-(-s // 128))]
    out = {}
    for name, per_block in (("fwd", fwd), ("dq", dq), ("dkv", dkv)):
        lengths = [n for n in per_block for _ in range(hkv * b)]
        mean = sum(lengths) / sms
        out[name] = {order: max(cta_loads(lengths, sms, order == "snake"))
                     / mean for order in ("stride", "snake")}
    return out


def kernel_name(name: str) -> str:
    """A profiled kernel's name without return type, namespace noise and
    arguments: "void (anonymous namespace)::delta_kernel<__nv_bfloat16>(...)"
    -> "delta_kernel<__nv_bfloat16>"."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).abs().max()
            / max(1.0, b.float().abs().max().item())).item()


def _own_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative to max |b| itself (a gradient's own scale)."""
    return ((a.float() - b.float()).abs().max()
            / max(1e-30, b.float().abs().max().item())).item()


def _events_ms(fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def build_report() -> bool:
    """Registers and spills of the wgmma kernels, SASS counts; False if a
    wgmma kernel did not get 168 registers."""
    from repro_torch.kernels.build import LIBS, sass_counts

    LIBS.build_all()
    ok = True
    for lib in ("flash_fwd", "flash_bwd"):
        entry = None
        for line in LIBS.ptxas_log.get(lib, "").splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif entry and "flash_wgmma" in entry and (
                    "registers" in line or "spill" in line
                    or "serialized" in line):
                print(f"[build] {lib} {entry[:48]}: {line.strip()}")
                if "Used" in line and " 168 registers" not in line:
                    ok = False
    counts = sass_counts(("flash_fwd", "flash_bwd"))
    print(f"[build] sass {json.dumps(counts)}")
    return ok


def check_small(gen: torch.Generator) -> bool:
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ref

    ok = True
    for b, g, d, s, kw in CASES:
        hkv = 2
        q, k, v, d_o = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                        .to(torch.bfloat16) for h in (hkv * g, hkv, hkv,
                                                      hkv * g))
        o, lse = K._flash_fwd(q, k, v, causal=kw["causal"],
                              window=kw.get("window"),
                              logit_cap=kw.get("logit_cap"))
        grads = K.flash_attention_bwd(q, k, v, o, lse, d_o, **kw)
        again = K.flash_attention_bwd(q, k, v, o, lse, d_o, **kw)
        tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
        errs = [_rel(o, ref.attention_ref(*tr[:3], **kw).transpose(1, 2))]
        errs += [_rel(a, w.transpose(1, 2)) for a, w in
                 zip(grads, ref.attention_ref_grad(*tr, **kw))]
        bitwise = all(torch.equal(a, c) for a, c in zip(grads, again))
        ok &= bitwise and max(errs) <= FLASH_TOL
        print(f"[check] B {b} G {g} D {d} S {s} {kw}: o/dq/dk/dv "
              f"{' '.join(f'{e:.3g}' for e in errs)} bitwise {bitwise}")
    print(f"[check] launches by variant: forward "
          f"{dict(K.flash_attention.variants)}, backward "
          f"{dict(K.flash_attention_bwd.variants)}")
    for b, g, sq, sk, bounds, kw in BLOCK_CASES:
        hkv, d = 2, 256
        q, d_o = (torch.randn(b, sq, hkv * g, d, generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        k, v = (torch.randn(b, sk, hkv, d, generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        o, lse = K._flash_fwd(q, k, v, causal=kw["causal"],
                              window=kw.get("window"),
                              logit_cap=kw.get("logit_cap"))
        for a, c in zip(bounds, bounds[1:]):
            kb, vb = k[:, a:c].contiguous(), v[:, a:c].contiguous()
            ob, lb = K.flash_attention_block(q, kb, vb, k_off=a, **kw)
            want_o, want_l = ref.attention_block_ref(q, kb, vb, k_off=a,
                                                     **kw)
            errs = [_rel(ob, want_o)]
            same_inf = torch.equal(torch.isinf(lb), torch.isinf(want_l))
            grads = K.flash_attention_block_bwd(q, kb, vb, o, lse, d_o,
                                                k_off=a, **kw)
            again = K.flash_attention_block_bwd(q, kb, vb, o, lse, d_o,
                                                k_off=a, **kw)
            want_g = ref.attention_block_ref_grad(q, kb, vb, o, lse, d_o,
                                                  k_off=a, **kw)
            errs += [_own_rel(x, w) for x, w in zip(grads, want_g)]
            bitwise = all(torch.equal(x, y) for x, y in zip(grads, again))
            ok &= bitwise and same_inf and max(errs) <= FLASH_TOL
            print(f"[check] key block {a}-{c} of B {b} G {g} Sq {sq} Sk {sk}"
                  f" {kw}: o/dq/dk/dv {' '.join(f'{e:.3g}' for e in errs)}"
                  f" -inf rows {same_inf} bitwise {bitwise}")
    print(f"[check] key-block launches by variant: forward "
          f"{dict(K.flash_attention_block.variants)}, backward "
          f"{dict(K.flash_attention_block_bwd.variants)}")
    return ok


def time_training_shape(gen: torch.Generator, b: int = 2, hq: int = 16,
                        hkv: int = 8, d: int = 128,
                        logit_cap: float | None = None) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.attention import attention as K

    s = 4096
    print(f"[time] B {b} Hq {hq} Hkv {hkv} S {s} D {d}, causal, softcap "
          f"{logit_cap}")
    q, d_o = (torch.randn(b, s, hq, d, generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))

    def fwd():
        return K._flash_fwd(q, k, v, causal=True, window=None,
                            logit_cap=logit_cap)

    o, lse = fwd()

    def bwd():
        return K.flash_attention_bwd(q, k, v, o, lse, d_o, causal=True,
                                     logit_cap=logit_cap)

    flops = 4 * b * hq * s * (s + 1) / 2 * d
    tf, tb = _events_ms(fwd), _events_ms(bwd)
    print(f"[time] forward {tf:.4f} ms ({flops / tf / 1e9:.1f} TFLOP/s), "
          f"backward {tb:.4f} ms ({2.5 * flops / tb / 1e9:.1f} TFLOP/s as "
          f"2.5 forwards)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fwd()
            bwd()
        torch.cuda.synchronize()
    per: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = kernel_name(e.name)
            per[name] = per.get(name, 0.0) + e.device_time_total / 1e3 / 5
    for name, ms in sorted(per.items(), key=lambda x: -x[1]):
        print(f"[profile] {name}: {ms:.4f} ms per call")


def time_key_block(gen: torch.Generator, b: int) -> None:
    """Both key-block entries on rank 0's block of gemma2-2b's train_4k cut
    (keys 0-255 of S 4096, Hq 8, Hkv 4, D 256, causal, softcap 50) at
    batch b, at the merged O and log-sum-exp of the whole sequence."""
    from repro_torch.kernels.attention import attention as K

    s, hq, hkv, d, n = 4096, 8, 4, 256, 256
    kw = {"causal": True, "logit_cap": 50.0}
    q, d_o = (torch.randn(b, s, hq, d, generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    o, lse = K._flash_fwd(q, k, v, window=None, **kw)
    kb, vb = k[:, :n].contiguous(), v[:, :n].contiguous()
    tf = _events_ms(lambda: K.flash_attention_block(q, kb, vb, k_off=0,
                                                    **kw))
    tb = _events_ms(lambda: K.flash_attention_block_bwd(
        q, kb, vb, o, lse, d_o, k_off=0, **kw))
    print(f"[time] key block 0-{n} of S {s} at B {b}: forward {tf:.4f} ms, "
          f"backward {tb:.4f} ms")


# The split family's shapes: (B, Hq, Hkv, Sq, Sk, D, causal)
SPLIT_SHAPES = {"cross": (2, 16, 16, 256, 1024, 64, False),
                "decoder_self": (2, 16, 16, 256, 256, 64, True),
                "cross_32": (2, 16, 16, 32, 1024, 64, False)}
# The macros of csrc/flash_wgmma.cuh's ablated copies ("kernel": none)
ABLATIONS = {"no_products": "FLASH_ABLATE_NO_PRODUCTS",
             "no_loads": "FLASH_ABLATE_NO_LOADS",
             "no_merge": "FLASH_ABLATE_NO_MERGE",
             "no_walk": "FLASH_ABLATE_NO_WALK"}
# ... and of csrc/flash_tf32.cuh's (the float32 family)
TF32_ABLATIONS = {"tf32_one_pass": "FLASH_ABLATE_ONE_PASS",
                  "tf32_no_products": "FLASH_ABLATE_NO_PRODUCTS",
                  "tf32_no_prepass": "FLASH_ABLATE_NO_PREPASS"}
# Rows 5f and 5bf: (B, Hq, Hkv, Sq, Sk, D, causal)
F32_SHAPES = {"row5": (2, 16, 8, 4096, 4096, 128, True),
              "cross": (2, 16, 16, 256, 1024, 64, False)}
F32_CASES = [  # (B, Hq, Hkv, Sq, Sk, D, options)
    (2, 4, 2, 77, 77, 64, {"causal": True}),
    (2, 4, 2, 200, 200, 128, {"causal": True}),
    (1, 8, 1, 300, 300, 128, {"causal": False, "window": 60,
                              "logit_cap": 30.0}),
    (2, 6, 2, 130, 333, 64, {"causal": True}),
    (2, 6, 2, 333, 130, 128, {"causal": False, "logit_cap": 20.0}),
    (2, 16, 16, 256, 1024, 64, {"causal": False}),
    (1, 4, 4, 1000, 1000, 128, {"causal": True, "window": 100}),
]


def _graph_ms(fn, n: int = 100) -> float:
    """ms a call over a CUDA graph of n calls (after warm-up)."""
    for _ in range(3):
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    return _events_ms(graph.replay, 5) / n


def _split_inputs(gen: torch.Generator, shape):
    from repro_torch.kernels.attention import attention as K

    b, hq, hkv, sq, sk, d, causal = shape
    q, d_o = (torch.randn(b, sq, hq, d, generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(b, sk, hkv, d, generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    o, lse = K._flash_fwd(q, k, v, causal=causal, window=None,
                          logit_cap=None)
    return q, k, v, o, lse, d_o


def time_split(gen: torch.Generator) -> None:
    """Rows 5x, 5bx, 5t and 5bt (and the 32-token cross) at the chooser's
    rank count and at 1 and 2 ranks, two turns each, and the backward's
    launches alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.attention import attention as K

    for tag, shape in SPLIT_SHAPES.items():
        b, hq, hkv, sq, sk, d, causal = shape
        q, k, v, o, lse, d_o = _split_inputs(gen, shape)
        chosen = [K._flash_ranks(lib, torch.bfloat16, b, sq, sk, hq, hkv, d,
                                 causal, 2 ** 31 - 1)
                  for lib in ("flash_fwd", "flash_bwd")]
        times = {}
        for turn in range(2):
            for r in (None, 1, *K.SPLIT_RANKS):
                times.setdefault(r, []).append((
                    _graph_ms(lambda: K._flash_fwd(
                        q, k, v, causal=causal, window=None, logit_cap=None,
                        ranks=r)),
                    _graph_ms(lambda: K.flash_attention_bwd(
                        q, k, v, o, lse, d_o, causal=causal, ranks=r))))
        for r, t in times.items():
            print(f"[split] {tag} {shape} ranks "
                  f"{'chosen ' + str(chosen) if r is None else r}: forward "
                  f"{' '.join(f'{x[0]:.4f}' for x in t)} ms, backward "
                  f"{' '.join(f'{x[1]:.4f}' for x in t)} ms")
        for r in (1, 2):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    K.flash_attention_bwd(q, k, v, o, lse, d_o,
                                          causal=causal, ranks=r)
                torch.cuda.synchronize()
            per: dict[str, float] = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    name = kernel_name(e.name)
                    per[name] = per.get(name, 0.0) + \
                        e.device_time_total / 1e3 / 20
            print(f"[split] {tag} backward at ranks {r}, each launch: "
                  + ", ".join(f"{n} {ms:.4f} ms" for n, ms in per.items()))


def _f32_inputs(gen: torch.Generator, b, hq, hkv, sq, sk, d):
    q, d_o = (torch.randn(b, sq, hq, d, generator=gen, device="cuda")
              for _ in range(2))
    k, v = (torch.randn(b, sk, hkv, d, generator=gen, device="cuda")
            for _ in range(2))
    return q, k, v, d_o


def check_f32(gen: torch.Generator) -> bool:
    """The float32 family on F32_CASES, both entries (the key block from a
    third of Sk on), against the plain versions."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ref

    ok = True
    for b, hq, hkv, sq, sk, d, kw in F32_CASES:
        q, k, v, d_o = _f32_inputs(gen, b, hq, hkv, sq, sk, d)
        o, lse = K._flash_fwd(q, k, v, causal=kw["causal"],
                              window=kw.get("window"),
                              logit_cap=kw.get("logit_cap"))
        grads = K.flash_attention_bwd(q, k, v, o, lse, d_o, **kw)
        again = K.flash_attention_bwd(q, k, v, o, lse, d_o, **kw)
        tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
        errs = [_rel(o, ref.attention_ref(*tr[:3], **kw).transpose(1, 2))]
        errs += [_own_rel(a, w.transpose(1, 2)) for a, w in
                 zip(grads, ref.attention_ref_grad(*tr, **kw))]
        bitwise = all(torch.equal(a, c) for a, c in zip(grads, again))
        off = sk // 3
        kb, vb = k[:, off:].contiguous(), v[:, off:].contiguous()
        ob, lb = K.flash_attention_block(q, kb, vb, k_off=off, **kw)
        want_o, want_l = ref.attention_block_ref(q, kb, vb, k_off=off, **kw)
        same_inf = torch.equal(torch.isinf(lb), torch.isinf(want_l))
        gb = K.flash_attention_block_bwd(q, kb, vb, o, lse, d_o, k_off=off,
                                         **kw)
        want_g = ref.attention_block_ref_grad(q, kb, vb, o, lse, d_o,
                                              k_off=off, **kw)
        berrs = [_rel(ob, want_o)] + [_own_rel(x, w)
                                      for x, w in zip(gb, want_g)]
        ok &= bitwise and same_inf and max(errs + berrs) <= FLASH_TOL_F32
        print(f"[f32] B {b} Hq {hq} Hkv {hkv} Sq {sq} Sk {sk} D {d} {kw}: "
              f"o/dq/dk/dv {' '.join(f'{e:.3g}' for e in errs)} bitwise "
              f"{bitwise}; key block from {off}: "
              f"{' '.join(f'{e:.3g}' for e in berrs)} -inf rows {same_inf}")
    print(f"[f32] launches by variant: forward "
          f"{dict(K.flash_attention.variants)}, backward "
          f"{dict(K.flash_attention_bwd.variants)}")
    return ok


def time_f32(gen: torch.Generator) -> None:
    """Rows 5f and 5bf: the pair from CUDA graphs, two turns, and each
    launch alone (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.attention import attention as K

    for tag, (b, hq, hkv, sq, sk, d, causal) in F32_SHAPES.items():
        q, k, v, d_o = _f32_inputs(gen, b, hq, hkv, sq, sk, d)
        o, lse = K._flash_fwd(q, k, v, causal=causal, window=None,
                              logit_cap=None)

        def fwd():
            K._flash_fwd(q, k, v, causal=causal, window=None,
                         logit_cap=None)

        def bwd():
            K.flash_attention_bwd(q, k, v, o, lse, d_o, causal=causal)

        n = 5 if tag == "row5" else 50
        t = [(_graph_ms(fwd, n), _graph_ms(bwd, n)) for _ in range(2)]
        print(f"[f32] {tag} B {b} Hq {hq} Hkv {hkv} Sq {sq} Sk {sk} D {d} "
              f"causal {causal}: forward "
              f"{' '.join(f'{x[0]:.4f}' for x in t)} ms, backward "
              f"{' '.join(f'{x[1]:.4f}' for x in t)} ms")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fwd()
                bwd()
            torch.cuda.synchronize()
        per: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = kernel_name(e.name)
                per[name] = per.get(name, 0.0) + e.device_time_total / 1e3 / 5
        print(f"[f32] {tag} each launch a call: " + ", ".join(
            f"{nm} {ms:.4f} ms" for nm, ms in per.items()))


def ablate(gen: torch.Generator) -> bool:
    """Copies of the two flash libraries: clusters of 4 (FLASH_MAX_RANKS
    4) at each split shape against the kernel at 2 ranks, checked against
    it within FLASH_TOL; the ablated copies (ABLATIONS) beside the kernel
    at the cross shape at 2 ranks.  Two turns each."""
    from repro_torch.kernels import build

    out = build.BUILD_DIR.parent / "flash_bench"
    out.mkdir(parents=True, exist_ok=True)
    copies = {"kernel": [], "ranks4": ["-DFLASH_MAX_RANKS=4"],
              **{n: [f"-D{m}"] for n, m in ABLATIONS.items()},
              **{n: [f"-D{m}"] for n, m in TF32_ABLATIONS.items()}}
    procs = []
    for name, defs in copies.items():
        defs = defs + [f"-D{ns}={name}_{ns}" for ns in (
            "paged", "flash_mma", "flash_wgmma", "flash_tf32", "tf32x3")]
        for lib in ("flash_fwd", "flash_bwd"):
            procs.append((name, lib, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, *defs, f"-I{build.CSRC}",
                 "-o", str(out / f"lib{lib}_{name}.so"),
                 str(build.CSRC / f"{lib}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns, tf32_fns = {}, {}
    for name, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"copy {name} did not build:\n{text}")
        so = ctypes.CDLL(str(out / f"lib{lib}_{name}.so"))
        tf32_fns[name, lib] = so
        fn = getattr(so, f"{lib}_split")
        fn.argtypes = ([I, I, P, P, P, P, P, I, I, I, I, I, I, F, I, I, F, P]
                       if lib == "flash_fwd" else
                       [I, I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                        F, I, I, F, P])
        fn.restype = I
        fns[name, lib] = fn

    def runner(shape):
        """call(name, lib, ranks) on the shape's inputs, into outputs of
        its own; returns (call, the outputs, the forward's o and dq)."""
        b, hq, hkv, sq, sk, d, causal = shape
        q, k, v, o, lse, d_o = _split_inputs(gen, shape)
        o2, lse2, delta = (torch.empty_like(o), torch.empty_like(lse),
                           torch.empty_like(lse))
        grads = [torch.empty_like(t) for t in (q, k, v)]
        scale, w = d ** -0.5, 2 ** 31 - 1

        def call(name, lib, ranks):
            st = torch.cuda.current_stream().cuda_stream
            if lib == "flash_fwd":
                err = fns[name, lib](ranks, 1, q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), o2.data_ptr(),
                                     lse2.data_ptr(), b, sq, sk, hq, hkv, d,
                                     scale, int(causal), w, 0.0, st)
            else:
                err = fns[name, lib](ranks, 1, q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), o.data_ptr(),
                                     d_o.data_ptr(), lse.data_ptr(),
                                     delta.data_ptr(),
                                     *(g.data_ptr() for g in grads), b, sq,
                                     sk, hq, hkv, d, scale, int(causal), w,
                                     0.0, st)
            if err:
                raise RuntimeError(f"copy {name} {lib}: CUDA error {err}")
        return call, o2, grads[0]

    def turns(call, runs):
        """{label: [ms of two turns]}, the runs in order, then reversed."""
        got: dict[str, list[float]] = {}
        for turn in range(2):
            for label, args in (runs if turn == 0 else reversed(runs)):
                got.setdefault(label, []).append(
                    _graph_ms(lambda: call(*args)))
        return ", ".join(f"{n} {' '.join(f'{t:.4f}' for t in ts)} ms"
                         for n, ts in got.items())

    ok = True
    for tag, shape in SPLIT_SHAPES.items():
        call, o_out, dq_out = runner(shape)
        want = []
        for name, r in (("kernel", 2), ("ranks4", 4)):
            call(name, "flash_fwd", r)
            call(name, "flash_bwd", r)
            want.append((o_out.clone(), dq_out.clone()))
        err = max(_rel(want[1][0], want[0][0]),
                  _own_rel(want[1][1], want[0][1]))
        ok &= err <= FLASH_TOL
        for lib in ("flash_fwd", "flash_bwd"):
            print(f"[ranks4] {tag} {shape} {lib}: " + turns(call, [
                ("2 ranks", ("kernel", lib, 2)),
                ("4 ranks", ("ranks4", lib, 4))])
                + f"; O and dQ at 4 ranks against 2: {err:.2e}")
    call, _, _ = runner(SPLIT_SHAPES["cross"])
    for lib in ("flash_fwd", "flash_bwd"):
        print(f"[ablate] {lib} at the cross shape, 2 ranks: " + turns(
            call, [(n, (n, lib, 2)) for n in ("kernel", *ABLATIONS)]))
    ablate_f32(gen, tf32_fns, turns)
    return ok


def ablate_f32(gen: torch.Generator, libs: dict, turns) -> None:
    """The float32 family's copies (TF32_ABLATIONS) beside the unchanged
    one at rows 5f's and 5bf's shapes, through the tf32x3 entries; the
    one-pass copy's error against the plain versions."""
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ref

    for tag, (b, hq, hkv, sq, sk, d, causal) in F32_SHAPES.items():
        q, k, v, d_o = _f32_inputs(gen, b, hq, hkv, sq, sk, d)
        o, lse = K._flash_fwd(q, k, v, causal=causal, window=None,
                              logit_cap=None)
        o2, lse2, delta = (torch.empty_like(o), torch.empty_like(lse),
                           torch.empty_like(lse))
        grads = [torch.empty_like(t) for t in (q, k, v)]
        w = 2 ** 31 - 1
        ws = {lib: K._tf32x3_ws(lib, q, k) for lib in ("flash_fwd",
                                                       "flash_bwd")}

        def call(name, lib):
            fn = getattr(libs[name, lib], f"{lib}_tf32x3")
            fn.restype = ctypes.c_int
            if lib == "flash_fwd":
                fn.argtypes = list(K._FWD_TF32X3)
                err = K._fwd_tf32x3(q, k, v, o2, lse2, ws[lib], 0, causal, w,
                                    0.0, 0, fn=fn)
            else:
                fn.argtypes = list(K._BWD_TF32X3)
                err = K._bwd_tf32x3(q, k, v, o, lse, d_o, delta, *grads,
                                    ws[lib], 0, causal, w, 0.0, 0, fn=fn)
            if err:
                raise RuntimeError(f"copy {name} {lib}: CUDA error {err}")

        call("tf32_one_pass", "flash_fwd")
        call("tf32_one_pass", "flash_bwd")
        tr = [t.transpose(1, 2) for t in (q, k, v, d_o)]
        errs = [_rel(o2, ref.attention_ref(*tr[:3], causal=causal)
                     .transpose(1, 2))]
        errs += [_own_rel(x, wt.transpose(1, 2)) for x, wt in zip(
            grads, ref.attention_ref_grad(*tr, causal=causal))]
        print(f"[ablate f32] {tag}: one TF32 product a product errs "
              f"o/dq/dk/dv {' '.join(f'{e:.3g}' for e in errs)}")
        for lib in ("flash_fwd", "flash_bwd"):
            print(f"[ablate f32] {lib} {tag}: " + turns(
                call, [(n, (n, lib)) for n in ("kernel", *TF32_ABLATIONS)]))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ablate", action="store_true",
                    help="also build and time the ablated copies")
    args = ap.parse_args(argv)
    for name, ratio in balance().items():
        print(f"[balance] {name}: busiest CTA over the mean, stride "
              f"{ratio['stride']:.4f}, snake {ratio['snake']:.4f}")
    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 2
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    if not build_report():
        print("[build] a wgmma kernel did not get 168 registers: not "
              "launching it", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    ok = check_small(gen)
    time_training_shape(gen)
    for cap in (None, 50.0):   # gemma2-2b caps its scores at 50
        time_training_shape(gen, hq=8, hkv=4, d=256, logit_cap=cap)
    for b in (1, 16):
        time_key_block(gen, b)
    time_split(gen)
    ok &= check_f32(gen)
    time_f32(gen)
    if args.ablate:
        ok &= ablate(gen)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
