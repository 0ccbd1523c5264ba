"""The dense flash kernels on the card, in one short call: build, check,
time and profile them, for iterating on ``csrc/flash_wgmma.cuh``.

  PYTHONPATH=src python -m repro_torch.launch.flash_bench [--seed N]

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

Exits 1 if a check fails, 2 without a card.  ``chip_smoke.py`` holds the
kernels to the same bounds at more shapes and times them beside SDPA.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

FLASH_TOL = 2e-2   # bf16, relative to max(1, max |plain|)
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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
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
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
