"""The PACO matmul plan kernel on the card, in one short call: build,
check, time and profile it, for iterating on ``csrc/matmul.cu``.

  PYTHONPATH=src python -m repro_torch.launch.matmul_bench [--seed N]
      [--ablate]

1. Build every kernel (``kernels.build``) and print the plan kernels'
   registers and spills from ``-Xptxas -v``.
2. ``plan_mm_1piece(8192, 8192, 8192, p)`` for p = 132 (one CTA per SM)
   and 131, in bf16 and float32, and the float32 plan of 65536 x 8192 x
   512 at p = 132: one ``matmul_plan_kernel`` call against
   ``matmul_plan_ref`` (relative to max(1, max |plain|), ``chip_smoke.py``'s
   MM_TOL), bitwise equal over two calls, and the variant it took; the
   time per call from CUDA events over 3 calls, and each kernel's device
   time per call from ``torch.profiler`` (float32: the pre-pass
   ``split_bt_kernel``, the walk ``plan_tf32x3_kernel``, the k-cut sums
   ``plan_sum_kernel``; bf16: the walk and the sums).
3. With ``--ablate``: copies of ``csrc/matmul.cu`` built into
   ``build/matmul_bench/`` and timed the same way at 8192^3, p = 132,
   through their own plan entry (their results are wrong by design and
   not checked): what bounds the walk.  bf16: the walk's output stores,
   its products, or both taken out.  float32 (``tf32_*``): one TF32
   product a slice instead of three (``tf32_one_pass``: what the two
   small-term products cost), no products (``tf32_no_products``: the
   loads, the split and the stores alone), and A passed to the tensor
   cores unsplit (``tf32_no_split``: what splitting A costs on the CUDA
   cores).

Exits 1 if a check fails, 2 without a card.  ``chip_smoke.py`` holds the
kernel to the same bounds at more shapes and times it beside
``torch.matmul`` and the parent commit's kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import torch

MM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
N = 8192
# Source edits of each ablated copy: (text of csrc/matmul.cu, replacement)
_EPILOGUE = ("      const int rt = (t / tm) * kWM, "
             "ct = m_al - q.m0 + (t % tm) * kWN;")
_PRODUCTS = ("#pragma unroll\n"
             "        for (int ks = 0; ks < kWK / 16; ++ks)\n"
             "          mma_ss_n256_tb(acc, desc_k(sa, kWM, 64 * wg, ks),\n"
             "                         desc_mn(sa + kWAStage, kWK, ks));\n")
_NO_STORES = (_EPILOGUE, "      if (acc[0] == 12345.f) d.p[0] = "
              "__float2bfloat16(acc[1]);\n      continue;\n" + _EPILOGUE)
_TF32_PRODUCTS = ("          mma_tf32_n128(acc, f + 4, dhi, s > 0 || steps > 0);"
                  "   // A_lo B_hi\n"
                  "          mma_tf32_n128(acc, f, dlo, 1);           "
                  "// A_hi B_lo\n"
                  "          mma_tf32_n128(acc, f, dhi, 1);           "
                  "// A_hi B_hi\n")
_TF32_SPLIT = "            split_tf32(x, f[e], f[4 + e]);\n"
# name -> edits; a copy named tf32_* is timed in float32 (its
# matmul_plan_tf32x3), the others in bf16 (matmul_plan)
ABLATIONS = {"no_stores": [_NO_STORES], "no_products": [(_PRODUCTS, "")],
             "no_stores_no_products": [_NO_STORES, (_PRODUCTS, "")],
             "tf32_one_pass": [(_TF32_PRODUCTS, (
                 "          mma_tf32_n128(acc, f, dhi, s > 0 || steps > 0);\n"))],
             "tf32_no_products": [(_TF32_PRODUCTS, "")],
             "tf32_no_split": [(_TF32_SPLIT, (
                 "            f[e] = __float_as_uint(x);\n"
                 "            f[4 + e] = 0u;\n"))]}


def build_report() -> None:
    from repro_torch.kernels.build import LIBS
    LIBS.build_all()
    entry = None
    for line in LIBS.ptxas_log.get("matmul", "").splitlines():
        if "Compiling entry" in line:
            entry = re.search(r"(plan|split|pad)_\w+?kernel", line)
        elif entry and ("registers" in line or "spill" in line):
            print(f"[build] {entry.group(0)}: "
                  f"{line.split('ptxas info    :')[-1].strip()}")


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got.float() - want.float()).abs().max().item()
    return err / max(1.0, want.float().abs().max().item())


def _time(call) -> tuple[float, dict[str, float]]:
    """ms per call over 3 calls (CUDA events), and device ms per call by
    kernel name from one profiled call."""
    call()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        call()
    e1.record()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.search(r"\w+_kernel", e.key)
            by_kernel[name.group(0) if name else e.key[:40]] = (
                e.device_time_total / 1e3)
    return e0.elapsed_time(e1) / 3, by_kernel


def check_and_time(gen: torch.Generator) -> bool:
    from repro_torch.core.matmul import plan
    from repro_torch.kernels.matmul import matmul_plan_kernel, matmul_plan_ref
    ok = True
    for dtype, (n, m, k), ps in ((torch.bfloat16, (N, N, N), (132, 131)),
                                 (torch.float32, (N, N, N), (132, 131)),
                                 (torch.float32, (65536, 8192, 512), (132,))):
        a = torch.randn(n, k, generator=gen, device="cuda").to(dtype)
        b = torch.randn(k, m, generator=gen, device="cuda").to(dtype)
        for p in ps:
            pl = plan(n, m, k, p)
            before = matmul_plan_kernel.variants.copy()
            got = matmul_plan_kernel(a, b, pl)
            (variant,) = matmul_plan_kernel.variants - before
            same = torch.equal(got, matmul_plan_kernel(a, b, pl))
            err = _rel(got, matmul_plan_ref(a, b, pl))
            del got
            ms, by_kernel = _time(lambda: matmul_plan_kernel(a, b, pl))
            good = same and err <= MM_TOL[dtype]
            ok &= good
            row = {"dtype": str(dtype)[6:], "shape": [n, m, k], "p": p,
                   "variant": variant,
                   "ms": ms, "kernels_ms": by_kernel, "rel_err": err,
                   "bitwise_repeat": same, "ok": good}
            print(f"[plan] {json.dumps(row)}")
        del a, b
        torch.cuda.empty_cache()
    return ok


def ablate(gen: torch.Generator) -> None:
    from repro_torch.core.matmul import plan
    from repro_torch.kernels import build
    from repro_torch.kernels.matmul.matmul import _device_table
    out_dir = build.BUILD_DIR.parent / "matmul_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / "matmul.cu").read_text()
    procs = []
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ablation {name}: csrc/matmul.cu no "
                                   f"longer holds {old.strip()[:60]!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        # the headers' namespaces renamed, so that no weak C++ symbol of a
        # copy binds to the loaded library's of the same name
        rename = [f"-D{ns}=ablated_{ns}"
                  for ns in ("paged", "flash_mma", "flash_wgmma")]
        procs.append((name, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *rename, f"-I{build.CSRC}",
             "-o", str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    pl = plan(N, N, N, 132)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ops = {}
    for dtype in (torch.bfloat16, torch.float32):
        a = torch.randn(N, N, generator=gen, device="cuda").to(dtype)
        b = torch.randn(N, N, generator=gen, device="cuda").to(dtype)
        table = _device_table(pl, a.device)
        ops[dtype] = (a, b, table, torch.empty((N, N), dtype=dtype,
                                               device=a.device),
                      torch.empty(table.host.ws_elems, dtype=dtype,
                                  device=a.device))
    for name, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation {name} did not build:\n{text}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        f32 = name.startswith("tf32_")
        a, b, table, out, ws = ops[torch.float32 if f32 else torch.bfloat16]
        p_off, p_cub, p_cell, p_mem = table.ptrs
        tables = (p_off, p_cub, table.ws_off.data_ptr(), p_cell, p_mem,
                  table.host.n_ctas, len(table.host.cell), N, N, N, N, N,
                  torch.cuda.current_stream().cuda_stream)
        if f32:
            lib.matmul_tf32x3_ws_floats.argtypes = [I, I, I, L, P]
            lib.matmul_tf32x3_ws_floats.restype = L
            split = torch.empty(lib.matmul_tf32x3_ws_floats(
                N, N, N, N, a.data_ptr()), dtype=torch.float32,
                device=a.device)
            fn = lib.matmul_plan_tf32x3
            fn.argtypes = [P, P, P, P, P, L, P, P, P, P, P, I, I, I, I, I, L,
                           L, P]
            args = (a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    ws.data_ptr(), split.data_ptr(), split.numel(), *tables)
        else:
            fn = lib.matmul_plan
            fn.argtypes = [I, I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, L,
                           L, P]
            args = (1, 2, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    ws.data_ptr(), *tables)
        fn.restype = I

        def call():
            err = fn(*args)
            if err:
                raise RuntimeError(f"ablation {name}: CUDA error {err}")
        ms, by_kernel = _time(call)
        row = {"copy": name, "dtype": "float32" if f32 else "bfloat16",
               "ms": ms, "kernels_ms": by_kernel}
        print(f"[ablate] {json.dumps(row)}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ablate", action="store_true",
                    help="also time copies of the plan walk with its stores, "
                    "products or split taken out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("matmul_bench: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    build_report()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    ok = check_and_time(gen)
    if args.ablate:
        ablate(gen)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
