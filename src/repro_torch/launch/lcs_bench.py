"""The LCS table kernel on the card, in one short call: build, check, time
and ablate it, for iterating on ``csrc/lcs_tile.cu``.

  PYTHONPATH=src python -m repro_torch.launch.lcs_bench [--seed N]
      [--ablate]

1. Build every kernel (``kernels.build``) and print the LCS kernels'
   registers and spills from ``-Xptxas -v``; build and run a one-thread
   probe of Hopper's DPX intrinsics (does ``__viaddmax_s32``'s add wrap,
   as the kernel's int32 sums must?).
2. The whole table of two 65,536-symbol DNA sequences from the seed, as
   ``paco_lcs`` runs it: p = 132 and 131 (tiles of 256), PO (p = 1, tile
   128) and PA (p = 8, tile 8192) as ``benchmarks/bench_lcs.py`` defines
   them: one launch a call, exactly ``lcs_reference`` (the plain row
   scan, computed once) and bitwise the same over two calls; ms per call
   from CUDA events over 3 calls after a warm-up, beside the bound
   (LCS_OPS_PER_CELL int32 operations a cell at the card's INT32 rate).
3. With ``--ablate``: copies of ``csrc/lcs_tile.cu`` built into
   ``build/lcs_bench/`` and timed the same way.  The other run of columns
   a lane (``run4``: 4 wherever 32 warps of 4 cover the tile; ``run8``: 8
   everywhere), checked like the kernel at every tiling.  At p = 132,
   with results wrong by design and not checked: without the cells (each
   cell one xor in place of its compare, add and three-way max: the
   sweep's shuffles, hand-offs and loads alone), and without the
   neighbour waits (each tile runs as soon as it is claimed: the tiles'
   work without the chain of ti + tj - 1 tiles).  What bounds the
   table.

Exits 1 if a check fails, 2 without a card.  ``chip_smoke.py`` holds the
kernel to the same results on more shapes and times it beside the parent
commit's kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys

import torch

from repro_torch.card import PEAK_FLOPS
from repro_torch.kernels import work

N = 65536
INT32_OPS_PER_S = PEAK_FLOPS[torch.int32]
LCS_OPS_PER_CELL = work.LCS_OPS_PER_CELL
# (label, p, tile or None for the PACO rule)
TILINGS = [("p=132", 132, None), ("p=131", 131, None),
           ("PO p=1 tile=128", 1, 128), ("PA p=8 tile=8192", 8, 8192)]
_CELL = ("    cur = __vimax3_s32(cur, p, wrap_add(dg, tv[q] == si ? 1 : 0));"
         "\n")
_WAITS = ("      if (i > 0) wait_flag(colprog + j, i);\n"
          "      if (j > 0) wait_flag(rowprog + i, j);\n")
_RUN = "int run_of(int tn) { return tn <= 128 ? 4 : 8; }\n"
# Source edits of each ablated copy: [(text of csrc/lcs_tile.cu,
# replacement)]
ABLATIONS = {
    "run4": [(_RUN, _RUN.replace("128", "4 * kMaxThreads"))],
    "run8": [(_RUN, _RUN.replace("tn <= 128 ? 4 : 8", "8"))],
    "no_cells": [(_CELL, "    cur ^= p;\n")],
    "no_waits": [(_WAITS, "")]}
# the copies that compute the kernel's function, checked at every tiling
EXACT = ("run4", "run8")
# one thread: __viaddmax_s32(a, b, c) = max(a + b, c), does the add wrap?
DPX_PROBE = r"""
#include <climits>
#include <cuda_runtime.h>
__global__ void probe(int* out) {
  out[0] = __viaddmax_s32(INT_MAX, 1, INT_MIN + 5);
  out[1] = __vimax3_s32(INT_MIN, -1, INT_MAX);
}
extern "C" int dpx_probe(int* out) {
  probe<<<1, 1>>>(out);
  return (int)cudaGetLastError();
}
"""


def ablated_sources(csrc) -> dict[str, str]:
    """name -> the edited text of csrc/lcs_tile.cu; raises if an edit no
    longer applies."""
    src = (csrc / "lcs_tile.cu").read_text()
    out = {}
    for name, edits in ABLATIONS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ablation {name}: csrc/lcs_tile.cu no "
                                   f"longer holds {old.strip()[:60]!r}")
            text = text.replace(old, new)
        out[name] = text
    return out


def _out_dir():
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR.parent / "lcs_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    return out_dir


def _nvcc(cu, lib) -> subprocess.Popen:
    from repro_torch.kernels import build
    return subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o",
                             str(lib), str(cu)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def dpx_probe() -> tuple[int, int]:
    """(__viaddmax_s32(INT_MAX, 1, INT_MIN + 5), __vimax3_s32(INT_MIN,
    -1, INT_MAX)) on the card: the first is INT_MIN + 5 if the add wraps,
    INT_MAX if it saturates."""
    cu, lib = _out_dir() / "dpx_probe.cu", _out_dir() / "libdpx_probe.so"
    cu.write_text(DPX_PROBE)
    text, _ = (proc := _nvcc(cu, lib)).communicate()
    if proc.returncode:
        raise RuntimeError(f"dpx_probe did not build:\n{text}")
    fn = ctypes.CDLL(str(lib)).dpx_probe
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    out = torch.zeros(2, dtype=torch.int32, device="cuda")
    if fn(out.data_ptr()):
        raise RuntimeError("dpx_probe did not launch")
    return tuple(int(x) for x in out.cpu())


def build_report() -> None:
    from repro_torch.kernels.build import LIBS
    LIBS.build_all()
    entry = None
    for line in LIBS.ptxas_log.get("lcs_tile", "").splitlines():
        if "Compiling entry" in line:
            entry = re.search(r"lcs_kernelILi\d+E", line)
        elif entry and ("registers" in line or "spill" in line):
            print(f"[build] {entry.group(0)}: "
                  f"{line.split('ptxas info    :')[-1].strip()}")
    added, three = dpx_probe()
    print(f"[build] dpx probe: __viaddmax_s32(INT_MAX, 1, INT_MIN + 5) = "
          f"{added} ({'wraps' if added == -2 ** 31 + 5 else 'saturates'}); "
          f"__vimax3_s32(INT_MIN, -1, INT_MAX) = {three}")


def _time(call) -> float:
    """ms per call over 3 calls (CUDA events), after a warm-up call."""
    call()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(3):
        call()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / 3


def bound_ms(n: int = N) -> float:
    return LCS_OPS_PER_CELL * n * n / INT32_OPS_PER_S * 1e3


def sequences(seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randint(0, 4, (N,), generator=gen, device="cuda",
                               dtype=torch.int32) for _ in range(2))


def check_and_time(s: torch.Tensor, t: torch.Tensor, smi: str) -> bool:
    from repro_torch.core import lcs_reference
    from repro_torch.kernels.lcs.lcs import lcs_table_kernel
    from repro_torch.kernels.lcs.ops import default_tile, lcs_wavefront
    want = int(lcs_reference(s, t))
    ok = True
    for label, p, tile in TILINGS:
        tile = tile or default_tile(N, p)
        before = (lcs_table_kernel.launches,
                  lcs_table_kernel.variants.copy())
        got = int(lcs_wavefront(s, t, p, tile=tile))
        launches = lcs_table_kernel.launches - before[0]
        variants = dict(lcs_table_kernel.variants - before[1])
        again = int(lcs_wavefront(s, t, p, tile=tile))
        ms = _time(lambda: lcs_wavefront(s, t, p, tile=tile))
        good = got == want == again and launches == 1
        ok &= good
        row = {"tiling": label, "tile": tile, "variants": variants,
               "launches": launches, "ms": ms, "bound_ms": bound_ms(),
               "lcs": got, "reference": want, "ok": good, "card": smi}
        print(f"[lcs] {json.dumps(row)}")
    return ok, want


def ablate(s: torch.Tensor, t: torch.Tensor, want: int, smi: str) -> bool:
    from repro_torch.kernels import build
    from repro_torch.kernels.lcs.ops import default_tile
    out_dir = _out_dir()
    procs = []
    for name, text in ablated_sources(build.CSRC).items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs.append((name, _nvcc(cu, out_dir / f"lib{name}.so")))
    P, I = ctypes.c_void_p, ctypes.c_int
    ok = True
    for name, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation {name} did not build:\n{text}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        fn = lib.lcs_table
        fn.argtypes = [P, P, P, I, I, I, I, P]
        fn.restype = I
        lib.lcs_run.argtypes, lib.lcs_run.restype = [I], I
        for label, p, tile in TILINGS if name in EXACT else TILINGS[:1]:
            tile = tile or default_tile(N, p)

            def call(fn=fn, tile=tile, name=name):
                ti = N // tile
                state = torch.zeros(2 * N + 3 * ti + 1, dtype=torch.int32,
                                    device="cuda")
                err = fn(s.data_ptr(), t.data_ptr(), state.data_ptr(), N, N,
                         tile, tile, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"ablation {name}: CUDA error {err}")
                return state[N - 1]
            row = {"copy": name, "tiling": label, "tile": tile,
                   "run": lib.lcs_run(tile), "ms": _time(call), "card": smi}
            if name in EXACT:
                got, again = int(call()), int(call())
                row.update(lcs=got, ok=got == want == again)
                ok &= row["ok"]
            print(f"[ablate] {json.dumps(row)}")
    return ok


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ablate", action="store_true",
                    help="also time copies of the kernel with the other "
                    "run of columns a lane, without its cells or without "
                    "its neighbour waits")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lcs_bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    build_report()
    s, t = sequences(args.seed)
    ok, want = check_and_time(s, t, smi)
    if args.ablate:
        ok &= ablate(s, t, want, smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
