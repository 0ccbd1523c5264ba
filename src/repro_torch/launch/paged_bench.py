"""The paged decode kernel, the MLA latent prefill and decode kernels and
the two speculative-verify entries on the card, in one short call: build,
check, time and ablate them, for iterating on ``csrc/paged_decode.cu`` and
``csrc/paged_latent_wgmma.cuh``.

  PYTHONPATH=src python -m repro_torch.launch.paged_bench [--seed N]
      [--ablate]

1. Build every kernel (``kernels.build``) and print the three libraries'
   kernels' registers and spills from ``-Xptxas -v``.
2. Paged decode at qwen3-0.6b's serving shape (8 slots of 48..1032
   positions drawn from the seed, Hkv 8, G 2, D 128, pages of 64, bf16),
   the latent prefill at deepseek-v2's (one 128-token chunk at start 896,
   H 128, kv_lora 512, qk_rope 64, pages of 128, bf16) and the latent
   decode at deepseek-v2's (8 slots of 48..1032 positions, H 128, pages of
   128, clusters of 4 ranks), the GQA verify entry at qwen3-0.6b's
   speculative serving (the decode's slots and pools, W 8 windows at the
   decode's lengths, tables of 32 pages as the engine's width bucket
   gives them) and the latent verify entry at deepseek-v2's (the latent
   decode's slots, tables and pools, W 8 windows at its lengths), both of
   the one-launch cluster family: each against
   its plain version (``chip_smoke.py``'s bf16 ATOL, 2e-2), bitwise equal
   over two calls, with the variant it took; device ms per call from one
   CUDA-graph replay of ITERS calls cycling over LAYERS layers' pools (so
   each call finds its keys outside the 50 MB L2, as serving does), and
   the bound (bytes at 3.35 TB/s or flops at 989 TFLOP/s).
3. With ``--ablate``: copies of the two sources with parts taken out,
   built into ``build/paged_bench/`` and timed the same way through their
   own C functions (their results are wrong by design and not checked):
   decode without its K/V loads, without its products (scores, softmax
   and weighted sums) or without both (the launch, the page ids and the
   merges); latent prefill without its loads (its barriers completed by a
   plain arrival), without its output stores or without its products
   (both wgmma loops, behind a condition that never holds); latent decode
   without its loads, its products or its merge (the ranks' states left
   unread, no output written); both verify entries without their loads or
   their products, and the latent one without its merge (the walks they
   share with kernels 1 and 3: the same edits, timed through the verify
   entries).  What bounds each kernel.
   And copies that compute the kernel's function, checked like it: the
   latent decode in clusters of 8 ranks (``ranks8``); the GQA verify in
   clusters of 2 or 8 ranks instead of 4 (``verify_ranks2``,
   ``verify_ranks8``); the latent
   verify in clusters of 1, 4 or 8 instead of 2 (``latent_verify_ranks1``,
   ``latent_verify_ranks4``, ``latent_verify_ranks8``) and with its
   clusters in the grid's order instead of the slots longest first
   (``latent_verify_grid_order``).

Exits 1 if a check fails, 2 without a card.  ``chip_smoke.py`` holds the
kernels to the same bounds at more shapes and times them beside SDPA and
the parent commit's kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys

import torch

from repro_torch import card

ATOL = 2e-2
ITERS = 100
LAYERS = 16
HBM_BYTES_PER_S = card.HBM_BYTES_PER_S
BF16_FLOPS = card.PEAK_FLOPS[torch.bfloat16]

# Source edits of each ablated copy: (file in csrc/, [(text, replacement)])
_DECODE_ISSUE = ("  for (int s = 0; s < kStages && s < n_stages; ++s) "
                 "issue(s);\n")
_DECODE_NEXT = "    if (s + kStages < n_stages) issue(s + kStages);\n"
_DECODE_LOOP = ("    for (int j0 = warp * kBatch; j0 < nk; "
                "j0 += kWarps * kBatch) {\n")
_DECODE_MMA_LOOP = _DECODE_LOOP.replace("kBatch", "kMmaKeys")
_DECODE_NO_PRODUCTS = [(loop, loop.replace("j0 = warp * ", "j0 = nk + 0 * "))
                       for loop in (_DECODE_LOOP, _DECODE_MMA_LOOP)]
_LATENT_S = ("#pragma unroll\n"
             "    for (int ks = 0; ks < kBoxes * 4; ++ks)\n"
             "      mma_ss_n32(s, desc_k(base + kQ, kRowsW, 0, ks),\n"
             "                 desc_k(kt, kTk, 32 * wg, ks), ks > 0);\n")
_LATENT_PV = ("#pragma unroll\n"
              "    for (int ks = 0; ks < kTk / 16; ++ks)\n"
              "      mma_ss_n256_tb(acc, desc_k(base + kP, kRowsW, 0, ks),\n"
              "                     desc_mn(kt + 4 * wg * kBlockBytes, kTk, "
              "ks));\n")
_LATENT_STORE = ("      if (orow < n_rows)\n"
                 "        *reinterpret_cast<uint4*>(out")
_LATENT_Q_LOAD = ("    mbar_expect_tx(q_full, kTileBytes);\n"
                  "#pragma unroll\n"
                  "    for (int c = 0; c < kBoxes - 1; ++c)\n"
                  "      tma_load_2d(base + kQ + c * kBlockBytes, ql_map, "
                  "q_full, c * 64,\n"
                  "                  q_row0);\n"
                  "    tma_load_2d(base + kQ + (kBoxes - 1) * kBlockBytes, "
                  "qr_map, q_full, 0,\n"
                  "                q_row0);\n")
_LATENT_TILE_LOAD = ("    mbar_expect_tx(full + 8 * stage, kTileBytes);\n"
                     "#pragma unroll\n"
                     "    for (int c = 0; c < kBoxes - 1; ++c)\n"
                     "      tma_load_2d(kt + c * kBlockBytes, ckv_map, "
                     "full + 8 * stage, c * 64,\n"
                     "                  krow);\n"
                     "    tma_load_2d(kt + (kBoxes - 1) * kBlockBytes, "
                     "kr_map, full + 8 * stage,\n"
                     "                0, krow);\n")
_LATENT_NO_LOADS = [
    (_LATENT_Q_LOAD, "    mbar_arrive(q_full);\n"),
    (_LATENT_TILE_LOAD, "    mbar_arrive(full + 8 * stage);\n"
                        "    (void)kt;\n    (void)krow;\n")]
# the products guarded by a condition that never holds, so that the copy
# keeps its registers and code shape
_LATENT_NO_PRODUCTS = [
    (_LATENT_S, "    if (page < 0) {\n" + _LATENT_S + "    }\n"),
    (_LATENT_PV, "    if (page < 0) {\n" + _LATENT_PV + "    }\n")]
_LATENT_MERGE = ("  for (int u = threadIdx.x; u < kRowsW * kUnits; "
                 "u += kThreadsW) {\n")
_LATENT_RANKS = "constexpr int kRanks = 4;\n"
_VERIFY_RANKS = "constexpr int kVerifyRanks = 4;\n"
_LATENT_VERIFY_RANKS = "constexpr int kVerifyRanks = 2;\n"
_LATENT_ORDER = ("  const int rb = VERIFY ? gridDim.y - 1 - blockIdx.y : "
                 "blockIdx.y;\n"
                 "  const int b =\n"
                 "      VERIFY ? slot_by_length(lengths, gridDim.z, "
                 "blockIdx.z) : blockIdx.z;\n")
_DECODE_NO_LOADS = [(_DECODE_ISSUE, ""), (_DECODE_NEXT, "")]
ABLATIONS = {
    "decode_no_loads": ("paged_decode.cu", _DECODE_NO_LOADS),
    "decode_no_products": ("paged_decode.cu", _DECODE_NO_PRODUCTS),
    "decode_no_loads_no_products": ("paged_decode.cu",
                                    _DECODE_NO_LOADS + _DECODE_NO_PRODUCTS),
    "latent_no_stores": ("paged_latent_wgmma.cuh", [
        (_LATENT_STORE, _LATENT_STORE.replace("orow < n_rows",
                                              "orow < 0"))]),
    # the barriers complete by a plain arrival, no TMA load issued
    "latent_no_loads": ("paged_latent_wgmma.cuh", _LATENT_NO_LOADS),
    "latent_no_products": ("paged_latent_wgmma.cuh", _LATENT_NO_PRODUCTS),
    # the latent decode (kernel 3) shares the walk: the same edits, built
    # from paged_latent_decode.cu; without its merge, the ranks leave their
    # states in shared memory and nobody reads them or writes the output
    "latent_decode_no_loads": ("paged_latent_wgmma.cuh", _LATENT_NO_LOADS),
    "latent_decode_no_products": ("paged_latent_wgmma.cuh",
                                  _LATENT_NO_PRODUCTS),
    "latent_decode_no_merge": ("paged_latent_wgmma.cuh", [
        (_LATENT_MERGE, _LATENT_MERGE.replace("u < kRowsW * kUnits",
                                              "u < kRowsW * kUnits && "
                                              "page < 0"))]),
    # clusters of 8 ranks: the kernel's function, a different split
    "latent_decode_ranks8": ("paged_latent_wgmma.cuh", [
        (_LATENT_RANKS, _LATENT_RANKS.replace("4", "8"))]),
    # the GQA verify's cluster walk (kernel 1's copies and stages, its own
    # 16-row steps): the same edits, timed through paged_verify_cluster;
    # clusters of 2 or 8 ranks instead of 4
    "verify_no_loads": ("paged_decode.cu", _DECODE_NO_LOADS),
    "verify_no_products": ("paged_decode.cu", _DECODE_NO_PRODUCTS),
    **{f"verify_ranks{r}": ("paged_decode.cu", [
        (_VERIFY_RANKS, _VERIFY_RANKS.replace("4", str(r)))])
       for r in (2, 8)},
    # the latent verify's walk (kernel 3's cluster kernel at W x H rows):
    # without loads or products, and clusters of 1, 4 or 8 instead of 2
    "latent_verify_no_loads": ("paged_latent_wgmma.cuh", _LATENT_NO_LOADS),
    "latent_verify_no_products": ("paged_latent_wgmma.cuh",
                                  _LATENT_NO_PRODUCTS),
    "latent_verify_no_merge": ("paged_latent_wgmma.cuh", [
        (_LATENT_MERGE, _LATENT_MERGE.replace("u < kRowsW * kUnits",
                                              "u < kRowsW * kUnits && "
                                              "page < 0"))]),
    # the clusters in the grid's order, not the slots longest first
    "latent_verify_grid_order": ("paged_latent_wgmma.cuh", [
        (_LATENT_ORDER, "  const int rb = blockIdx.y;\n"
                        "  const int b = blockIdx.z;\n")]),
    **{f"latent_verify_ranks{r}": ("paged_latent_wgmma.cuh", [
        (_LATENT_VERIFY_RANKS, _LATENT_VERIFY_RANKS.replace("2", str(r)))])
       for r in (1, 4, 8)},
}
# the copies that compute the kernel's function, checked like it
EXACT = ("latent_decode_ranks8", "verify_ranks2", "verify_ranks8",
         "latent_verify_grid_order", "latent_verify_ranks1",
         "latent_verify_ranks4", "latent_verify_ranks8")


def ablated_sources(csrc) -> dict[str, tuple[str, str]]:
    """name -> (file name, its edited text), from the sources in csrc;
    raises if an edit no longer applies."""
    out = {}
    for name, (fname, edits) in ABLATIONS.items():
        text = (csrc / fname).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"ablation {name}: csrc/{fname} no longer "
                                   f"holds {old.strip()[:60]!r}")
            text = text.replace(old, new)
        out[name] = (fname, text)
    return out


def build_report() -> None:
    """Each paged library's kernels' registers and spills from ``-Xptxas
    -v``, the kernel names demangled by ``c++filt`` where there is one."""
    from repro_torch.kernels.build import LIBS
    LIBS.build_all()
    filt = shutil.which("c++filt")
    for lib in ("paged_decode", "paged_latent_prefill",
                "paged_latent_decode", "paged_prefill"):
        entry = None
        for line in LIBS.ptxas_log.get(lib, "").splitlines():
            found = re.search(r"Compiling entry function '(\w+)'", line)
            if found:
                entry = found.group(1)
                if filt:
                    entry = subprocess.run([filt, entry], capture_output=True,
                                           text=True).stdout.strip()
                entry = re.sub(r"\(anonymous namespace\)::|__nv_", "",
                               entry)[:110]
            elif entry and ("registers" in line or "spill" in line
                            or "C75" in line):
                print(f"[build] {lib} {entry}: "
                      f"{line.split('ptxas info    :')[-1].strip()}")


def _graph_ms(call, iters: int = ITERS) -> float:
    """Device ms per call(i) from one replay of a CUDA graph of ``iters``
    calls, after a warm-up."""
    for i in range(3):
        call(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            call(i)
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


class Shapes:
    """The serving inputs of the kernels, from the seed: decode q, K/V
    pools (LAYERS, n_pool, 64, 8, 128), tables and lengths; latent q_lat,
    q_rope, pools (LAYERS, n_pool, 128, 512 | 64) and the chunk's block
    row; the latent decode's q, tables and lengths; both verify entries'
    W 8 windows."""

    def __init__(self, gen: torch.Generator):
        dev, bf = "cuda", torch.bfloat16
        slots, page, pps, hkv, self.hq, self.d = 8, 64, 32, 8, 16, 128
        n_pool = slots * pps + 1

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=dev).to(bf)

        self.lens = torch.randint(48, 1000 + 32 + 1, (slots,), generator=gen,
                                  device=dev, dtype=torch.int32)
        perm = torch.randperm(n_pool - 1, generator=gen, device=dev)
        self.bt = perm[:slots * pps].reshape(slots, pps).to(torch.int32)
        self.q = rnd(slots, 1, self.hq, self.d)
        self.kp = rnd(LAYERS, n_pool, page, hkv, self.d)
        self.vp = rnd(LAYERS, n_pool, page, hkv, self.d)
        self.h, self.kv, self.rope, self.c, self.start = 128, 512, 64, 128, 896
        lpage, width, n_lpool = 128, 8, 129
        self.ql = rnd(1, self.c, self.h, self.kv)
        self.qr = rnd(1, self.c, self.h, self.rope)
        self.ck = rnd(LAYERS, n_lpool, lpage, self.kv)
        self.kr = rnd(LAYERS, n_lpool, lpage, self.rope)
        self.row = torch.randperm(n_lpool - 1, generator=gen, device=dev)[
            :width].to(torch.int32)
        self.scale = 1 / math.sqrt(192)   # deepseek-v2: qk_nope + qk_rope
        # the latent decode: 8 slots of 16 pages of 128 over the same pools
        self.llens = torch.randint(48, 1000 + 32 + 1, (slots,), generator=gen,
                                   device=dev, dtype=torch.int32)
        self.lbt = torch.randperm(n_lpool - 1, generator=gen, device=dev)[
            :slots * 16].reshape(slots, 16).to(torch.int32)
        self.dql = rnd(slots, 1, self.h, self.kv)
        self.dqr = rnd(slots, 1, self.h, self.rope)
        # the verify: W 8 windows at the decode's lengths, its pools; the
        # latent verify: W 8 windows over the latent decode's pools
        self.w = 8
        self.vq = rnd(slots, self.w, self.hq, self.d)
        self.vql = rnd(slots, self.w, self.h, self.kv)
        self.vqr = rnd(slots, self.w, self.h, self.rope)
        # ... at chip_smoke.py's verify lengths over its tables of 8 pages
        # of 128 (the kernel table's row 4v)
        self.vlens = torch.tensor([0, 124, 1016, 1000, 300, 777, 48, 555],
                                  dtype=torch.int32, device=dev)
        self.vlbt = self.lbt[:, :8].contiguous()

    def decode_bound_ms(self) -> float:
        n_keys = int(self.lens.sum())
        nbytes = (4 * self.q.numel() + 4 * (self.bt.numel() + 8)
                  + 2 * n_keys * 8 * self.d * 2)
        return max(nbytes / HBM_BYTES_PER_S,
                   4 * n_keys * self.hq * self.d / BF16_FLOPS) * 1e3

    def latent_decode_bound_ms(self) -> float:
        n_keys = int(self.llens.sum())
        flops = n_keys * self.h * (2 * (self.kv + self.rope) + 2 * self.kv)
        nbytes = (2 * (2 * self.dql.numel() + self.dqr.numel())
                  + 4 * (self.lbt.numel() + 8)
                  + n_keys * (self.kv + self.rope) * 2)
        return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3

    def verify_bound_ms(self) -> float:
        keys = int((self.lens + self.w).sum())
        pairs = int((self.lens[:, None] + torch.arange(
            1, self.w + 1, device=self.lens.device)).sum())
        nbytes = (4 * self.vq.numel() + 4 * (self.bt.numel() + 8)
                  + 2 * keys * 8 * self.d * 2)
        return max(nbytes / HBM_BYTES_PER_S,
                   4 * pairs * self.hq * self.d / BF16_FLOPS) * 1e3

    def latent_verify_bound_ms(self) -> float:
        keys = int((self.vlens + self.w).sum())
        pairs = int((self.vlens[:, None] + torch.arange(
            1, self.w + 1, device=self.vlens.device)).sum())
        flops = pairs * self.h * (2 * (self.kv + self.rope) + 2 * self.kv)
        nbytes = (2 * (2 * self.vql.numel() + self.vqr.numel())
                  + 4 * (self.vlbt.numel() + 8)
                  + keys * (self.kv + self.rope) * 2)
        return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3

    def latent_bound_ms(self) -> float:
        pairs = sum(self.start + i + 1 for i in range(self.c))
        flops = pairs * self.h * (2 * (self.kv + self.rope) + 2 * self.kv)
        nbytes = (2 * (2 * self.ql.numel() + self.qr.numel())
                  + (self.start + self.c) * (self.kv + self.rope) * 2)
        return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3


def check_and_time(sh: Shapes, smi: str) -> bool:
    from repro_torch.kernels.attention import attention as K
    from repro_torch.kernels.attention import ops
    ok = True
    cases = [
        ("paged_decode", K.paged_flash_decode,
         lambda i: K.paged_flash_decode(sh.q, sh.kp[i % LAYERS],
                                        sh.vp[i % LAYERS], sh.bt, sh.lens,
                                        scale=1 / math.sqrt(sh.d)),
         lambda: ops.paged_decode_attention(sh.q, sh.kp[0], sh.vp[0], sh.bt,
                                            sh.lens, use_kernel=False),
         sh.decode_bound_ms()),
        ("paged_latent_prefill", K.paged_latent_prefill,
         lambda i: K.paged_latent_prefill(sh.ql, sh.qr, sh.ck[i % LAYERS],
                                          sh.kr[i % LAYERS], sh.row,
                                          sh.start, scale=sh.scale),
         lambda: ops.paged_latent_prefill_attention(
             sh.ql, sh.qr, sh.ck[0], sh.kr[0], sh.row, sh.start,
             scale=sh.scale, use_kernel=False),
         sh.latent_bound_ms()),
        ("paged_latent_decode", K.paged_latent_decode,
         lambda i: K.paged_latent_decode(
             sh.dql, sh.dqr, sh.ck[i % LAYERS], sh.kr[i % LAYERS], sh.lbt,
             sh.llens, scale=sh.scale),
         lambda: latent_decode_plain(sh), sh.latent_decode_bound_ms()),
        ("paged_verify", K.paged_flash_verify,
         lambda i: K.paged_flash_verify(sh.vq, sh.kp[i % LAYERS],
                                        sh.vp[i % LAYERS], sh.bt, sh.lens,
                                        scale=1 / math.sqrt(sh.d)),
         lambda: verify_plain(sh), sh.verify_bound_ms()),
        ("paged_latent_verify", K.paged_latent_verify,
         lambda i: K.paged_latent_verify(
             sh.vql, sh.vqr, sh.ck[i % LAYERS], sh.kr[i % LAYERS], sh.vlbt,
             sh.vlens, scale=sh.scale),
         lambda: latent_verify_plain(sh), sh.latent_verify_bound_ms())]
    for name, wrapper, call, plain, bound in cases:
        before = wrapper.variants.copy()
        got = call(0)
        (variant,) = wrapper.variants - before
        same = torch.equal(got, call(0))
        err = (got.float() - plain().float()).abs().max().item()
        good = same and err <= ATOL
        ok &= good
        row = {"kernel": name, "variant": variant, "ms": _graph_ms(call),
               "bound_ms": bound, "max_abs_err": err, "bitwise_repeat": same,
               "ok": good, "card": smi}
        print(f"[time] {json.dumps(row)}")
    return ok


def latent_decode_plain(sh: Shapes) -> torch.Tensor:
    """The plain latent decode on the first layer's pools."""
    from repro_torch.kernels.attention import ops
    return ops.paged_latent_decode_attention(
        sh.dql, sh.dqr, sh.ck[0], sh.kr[0], sh.lbt, sh.llens, scale=sh.scale,
        use_kernel=False)


def verify_plain(sh: Shapes) -> torch.Tensor:
    """The plain verify on the first layer's pools."""
    from repro_torch.kernels.attention import ops
    return ops.paged_verify_attention(sh.vq, sh.kp[0], sh.vp[0], sh.bt,
                                      sh.lens, use_kernel=False)


def latent_verify_plain(sh: Shapes) -> torch.Tensor:
    """The plain latent verify on the first layer's pools."""
    from repro_torch.kernels.attention import ops
    return ops.paged_latent_verify_attention(
        sh.vql, sh.vqr, sh.ck[0], sh.kr[0], sh.vlbt, sh.vlens, scale=sh.scale,
        use_kernel=False)


def _entry(name: str) -> str:
    """The entry an ablated copy is timed through, from its name."""
    for prefix in ("latent_verify", "latent_decode", "verify", "decode"):
        if name.startswith(prefix):
            return prefix
    return "latent_prefill"


# the library source each entry's copies are built from
_LIB_SOURCE = {"decode": "paged_decode.cu", "verify": "paged_decode.cu",
               "latent_decode": "paged_latent_decode.cu",
               "latent_prefill": "paged_latent_prefill.cu",
               "latent_verify": "paged_latent_prefill.cu"}


def ablate(sh: Shapes, smi: str) -> bool:
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR.parent / "paged_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, (fname, text) in ablated_sources(build.CSRC).items():
        # the copy of a header goes beside a copy of the library's .cu that
        # includes it from the copy's directory first
        lib_src = _LIB_SOURCE[_entry(name)]
        cu_dir = out_dir / name
        cu_dir.mkdir(exist_ok=True)
        (cu_dir / fname).write_text(text)
        if fname != lib_src:
            (cu_dir / lib_src).write_text((build.CSRC / lib_src).read_text())
        # the headers' namespaces renamed for each copy, so that no weak
        # C++ symbol of a copy (the latent kernel's host stub among them)
        # binds to the loaded library's, or another copy's, of the same name
        rename = [f"-D{ns}={name}_{ns}" for ns in (
            "paged", "flash_mma", "flash_wgmma", "latent", "latent_wgmma")]
        procs.append((name, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *rename, f"-I{cu_dir}",
             f"-I{build.CSRC}", "-o", str(out_dir / f"lib{name}.so"),
             str(cu_dir / lib_src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    out_d = torch.empty_like(sh.q)
    out_l = torch.empty_like(sh.ql)
    out_ld = torch.empty_like(sh.dql)
    out_v = torch.empty_like(sh.vq)
    out_lv = torch.empty_like(sh.vql)
    plains = {"latent_decode": latent_decode_plain, "verify": verify_plain,
              "latent_verify": latent_verify_plain}
    ok = True
    for name, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"ablation {name} did not build:\n{text}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        entry = _entry(name)
        if entry == "decode":
            fn = lib.paged_decode
            fn.argtypes = [I, P, P, P, P, P, P, I, I, I, I, I, I, I, F, I, F,
                           P]
            fn.restype = I
            n_pool, page = sh.kp.shape[1:3]
            out = out_d

            def call(i, fn=fn, name=name, n_pool=n_pool, page=page):
                err = fn(1, sh.q.data_ptr(), sh.kp[i % LAYERS].data_ptr(),
                         sh.vp[i % LAYERS].data_ptr(), sh.bt.data_ptr(),
                         sh.lens.data_ptr(), out_d.data_ptr(), 8, 8, 2,
                         sh.d, page, sh.bt.shape[1], n_pool,
                         1 / math.sqrt(sh.d), 2 ** 31 - 1, 0.0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"ablation {name}: CUDA error {err}")
        elif entry == "verify":
            fn = lib.paged_verify_cluster
            fn.argtypes = [P] * 6 + [I] * 8 + [F, I, F, P]
            fn.restype = I
            n_pool, page = sh.kp.shape[1:3]
            out = out_v

            def call(i, fn=fn, name=name, n_pool=n_pool, page=page):
                err = fn(sh.vq.data_ptr(), sh.kp[i % LAYERS].data_ptr(),
                         sh.vp[i % LAYERS].data_ptr(), sh.bt.data_ptr(),
                         sh.lens.data_ptr(), out_v.data_ptr(), 8, sh.w,
                         sh.hq, 8, sh.d, page, sh.bt.shape[1], n_pool,
                         1 / math.sqrt(sh.d), 2 ** 31 - 1, 0.0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"ablation {name}: CUDA error {err}")
        elif entry == "latent_verify":
            fn = lib.paged_latent_verify
            fn.argtypes = [I] + [P] * 9 + [I] * 8 + [F, P]
            fn.restype = I
            n_pool, page = sh.ck.shape[1:3]
            out = out_lv

            def call(i, fn=fn, name=name, n_pool=n_pool, page=page):
                err = fn(1, sh.vql.data_ptr(), sh.vqr.data_ptr(),
                         sh.ck[i % LAYERS].data_ptr(),
                         sh.kr[i % LAYERS].data_ptr(), sh.vlbt.data_ptr(),
                         sh.vlens.data_ptr(), out_lv.data_ptr(), None, None,
                         sh.vlbt.shape[0], sh.w, sh.h, sh.kv, sh.rope, page,
                         sh.vlbt.shape[1], n_pool, sh.scale,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"ablation {name}: CUDA error {err}")
        elif entry == "latent_decode":
            fn = lib.paged_latent_decode
            fn.argtypes = [I, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                           F, P]
            fn.restype = I
            n_pool, page = sh.ck.shape[1:3]
            out = out_ld

            def call(i, fn=fn, name=name, n_pool=n_pool, page=page):
                err = fn(1, sh.dql.data_ptr(), sh.dqr.data_ptr(),
                         sh.ck[i % LAYERS].data_ptr(),
                         sh.kr[i % LAYERS].data_ptr(), sh.lbt.data_ptr(),
                         sh.llens.data_ptr(), out_ld.data_ptr(), None, None,
                         sh.lbt.shape[0], sh.h, sh.kv, sh.rope, page,
                         sh.lbt.shape[1], n_pool, sh.scale,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"ablation {name}: CUDA error {err}")
        else:
            fn = lib.paged_latent_prefill
            fn.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                           F, P]
            fn.restype = I
            n_pool, page = sh.ck.shape[1:3]
            out = out_l

            def call(i, fn=fn, name=name, n_pool=n_pool, page=page):
                err = fn(1, sh.ql.data_ptr(), sh.qr.data_ptr(),
                         sh.ck[i % LAYERS].data_ptr(),
                         sh.kr[i % LAYERS].data_ptr(), sh.row.data_ptr(),
                         out_l.data_ptr(), None, None, sh.c, sh.h, sh.kv,
                         sh.rope, page, sh.row.shape[0], n_pool, sh.start,
                         sh.scale, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"ablation {name}: CUDA error {err}")
        row = {"copy": name, "ms": _graph_ms(call), "card": smi}
        if name in EXACT:
            call(0)
            got = out.clone()
            call(0)
            want = plains[entry](sh)
            err = (got.float() - want.float()).abs().max()
            row.update(max_abs_err=err.item(),
                       bitwise_repeat=torch.equal(got, out))
            row["ok"] = row["bitwise_repeat"] and row["max_abs_err"] <= ATOL
            ok &= row["ok"]
        print(f"[ablate] {json.dumps(row)}")
    return ok


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ablate", action="store_true",
                    help="also time copies of the kernels with their "
                    "loads, stores, products or merge taken out, and the "
                    "latent decode in clusters of 8 ranks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("paged_bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    build_report()
    sh = Shapes(torch.Generator(device="cuda").manual_seed(args.seed))
    ok = check_and_time(sh, smi)
    if args.ablate:
        ok &= ablate(sh, smi)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
