// Dense flash attention in float32 for Hopper: kernels 5 and 5b's float32
// family at D 64 and 128 ("wgmma_tf32x3"), every product three TF32
// products on wgmma (tf32_wgmma.cuh), with TMA loads, a producer warp and a
// persistent grid.  flash_fwd.cu and flash_bwd.cu give the function, the
// layouts and the masks; this family takes both entries (the whole
// sequence, and the key block at k_off through the flag KB) and Sq != Sk.
//
// Replaces src/repro/kernels/attention/attention.py:72
// flash_attention_pallas in float32 (the backward is the port's own
// gradient, as in flash_wgmma.cuh).  What bounds it: operations.  The
// tensor cores have no f32 mode, so an f32-accurate product is three TF32
// products at 495 TFLOP/s: the causal forward at B 2, Hq 16, S 4096, D 128
// does 3 x 137 GFLOP (0.833 ms), the backward below 3 x 5 products of the
// forward's size (2.08 ms), against 67 TFLOP/s of true f32 on the CUDA
// cores (2.05 and 5.13 ms for one pass).  On an H100 the loads of the
// TF32 parts, the splits and the softmax and gradient steps take about
// half of the time and barely overlap the products (PERF.md: copies
// without products).
//
// One kernel body (pass_kernel) runs four passes.  Each holds 128 rows of
// one or two f32 "row operands" (A) in shared memory, walks column tiles
// of TK, forms one or two score products X = A1 B1^T (Y = A2 B2^T) over D,
// an elementwise step W, and adds W C into its rows' output:
//
//   pass  rows                     A1, A2   B1, B2     W         C
//   fwd   G heads x bq queries     Q        K          softmax   V
//   dq    G heads x bq queries     Q, dO    K, V       dS        K
//   dv    128 keys of a kv head    K        Q          P^T       dO
//   dk    128 keys of a kv head    K, V     Q, dO      dS^T      Q
//
// The dK/dV work is two passes, not one: dK and dV with their f32 totals
// (below) are 256 registers a thread at D 128, more than a warpgroup's 232.
// Splitting recomputes S^T, so the backward does 3 (dq) + 2 (dv) + 3 (dk)
// products of the forward's size where a fused pass would do 7.
//
// Operands, per product (wgmma reads a TF32 operand from shared memory
// K-major only, and A from registers in any layout a thread can load):
//  * X and Y: A from the f32 row operand in shared memory (TMA from the
//    tensor itself, 128-byte swizzle), split into TF32 hi and lo in
//    registers each k8 slice; B1 and B2 K-major as stored (K, V rows
//    against D; Q, dO rows against D), so no transposed copy: their hi
//    part is the tensor itself (TMA from it; wgmma reads an f32 bit
//    pattern truncated to TF32) and their lo part, (x - x truncated)
//    rounded to TF32, comes from a pre-pass into the workspace
//    (split_kernel);
//  * W C: A is X's (or Y's) accumulator, split in registers; C must be
//    K-major along the tile's columns, so the pre-pass writes C^T (V^T,
//    K^T, dO^T, Q^T: D rows x positions) hi and lo (split_t_kernel).  The
//    f32 accumulator holds columns 2 t4 and 2 t4 + 1 of each 8, the TF32
//    A fragment columns t4 and t4 + 4: so C^T's positions are permuted
//    within each 8 (column c of a group holds position 2 (c % 4) + c / 4),
//    and accumulator column 2 t4 + j meets fragment slot t4 + 4 j with no
//    shuffle (a sum does not care about the order of its terms).  Tiles
//    start on a multiple of 8, the first rounded down (its extra positions
//    masked).
// The pre-passes write K's lo and V^T's hi and lo for the forward, and
// K's, V's, Q's and dO's lo and K^T's, Q^T's and dO^T's hi and lo for the
// backward: K + 2 V^T and 2 K + 2 K^T + 2 Q + 4 Q^T floats (0.10 and
// 0.54 GB at B 2, Hq 16, Hkv 8, S 4096, D 128; ~0.03 and ~0.16 ms at
// 3.35 TB/s).  A transposed operand stays a copy in shared memory, not a
// register operand with the roles swapped (dV^T = dO^T P): B would then
// be P, which lives in the two warpgroups' registers and would go through
// shared memory split in hi and lo each tile, with a barrier between the
// warpgroups, and the dV tile's rows would be D's, not the CTA's keys.
//
// The tensor cores' accumulator truncates, so no product sums more than
// TK of its k (32 at D 128, 64 at D 64) in one wgmma chain: each column
// tile's W C is summed from zero and added into an f32 total with rounded
// adds (the forward rescales the total by the online softmax's alpha
// first).  The score products sum D <= 128 in one chain.
//
// A CTA is two consumer warpgroups of 64 rows and a producer warp (as
// flash_wgmma.cuh): full and empty mbarriers guard the row operands (once
// an item) and, per stage, the column tile's score operands (X group: B1,
// B2) and its C^T (C group) apart, so the next tile's B loads as soon as
// the scores have landed.  (Freeing B1 and B2 apart, and the two groups
// taking turns to issue their products, measured no faster: PERF.md.)
// Shared memory (227 KB a CTA; TK keys or queries a tile, a part = TK x D
// x 4 bytes = 16 KB at both widths):
//
//   pass   row operands       stage (X + C)        stages   total
//   fwd    Q: 64 / 32 KB      2 + 2 parts, 64 KB   2        192 / 160 KB
//   dv     K: 64 / 32 KB      2 + 2 parts, 64 KB   2        192 / 160 KB
//   dq     Q, dO: 128 / 64    4 + 2 parts, 96 KB   1        224 / 160 KB
//   dk     K, V: 128 / 64     4 + 2 parts, 96 KB   1        224 / 160 KB
//   (D 128 / D 64)
//
// Registers (232 a consumer thread): the output total and one tile's sum,
// D / 2 each, the score accumulators, TK / 2 each, three k8 slices' A
// fragments (24): 184-216 at D 128.  The grid is persistent (one CTA per
// SM walking (block, kv head, batch) items longest first, in rounds taken
// in alternating directions, as flash_wgmma.cuh).  128 rows a CTA: the
// cross shape (B 2, Hq = Hkv = 16, Sq 256, Sk 1024) has 64 items for 132
// SMs; 64-row CTAs would fill the card there, but two of them do not fit
// one SM beside each other (registers), so the CTA keeps 128 rows.
//
// Masks, softcap (tanhf, score_log2), GQA rows (position-major: row r is
// head r % G at position c0 + r / G, as the TMA box brings them), the
// finite -1e30 initial max and the key-block flag KB (positions shifted by
// k_off; O and dQ in f32 as always here; lse -inf and O = 0 on rows that
// see no key of the block; an item with no tile touches no stage and
// stores zeros) are those of flash_wgmma.cuh.  No atomics: every sum has
// a fixed order, and the backward is bitwise equal over repeats.
//
// Ablations (launch.flash_bench --ablate builds copies with one defined;
// they compute garbage or, ONE_PASS, f32 at TF32's accuracy):
// FLASH_ABLATE_ONE_PASS issues A_hi B_hi alone, FLASH_ABLATE_NO_PRODUCTS
// no product, FLASH_ABLATE_NO_PREPASS no pre-pass (the workspace is read
// as it is).

#pragma once

#include <initializer_list>

#include "flash_wgmma.cuh"
#include "tf32_wgmma.cuh"

namespace flash_tf32 {

using namespace flash_wgmma;
using tf32x3::mma_tf32;
using tf32x3::lo_of_raw;
using tf32x3::split_tf32;
using tf32x3::split_tf32_fast;

// The head_dims the family takes.
inline bool takes(int d) { return d == 64 || d == 128; }

// Rows (query rows or keys) a CTA: flash_wgmma.cuh's, named apart so that
// no source's constant of the same name makes it ambiguous.
constexpr int kCtaRows = flash_wgmma::kRows;

enum Pass : int { kFwd = 0, kDq = 1, kDv = 2, kDk = 3 };

// The shared-memory layout of a pass at width D (the table above).
template <int P, int D>
struct Geo {
  static constexpr int kTk = 4096 / D;   // columns a tile: 32 / 64
  static constexpr bool kTwo = P == kDq || P == kDk;   // X and Y
  static constexpr bool kKeys = P == kDv || P == kDk;  // rows are keys
  static constexpr int kStages = kTwo ? 1 : 2;
  static constexpr int kA = kCtaRows * D * 4;      // one f32 row operand
  static constexpr int kPart = kTk * D * 4;       // a TF32 part of a tile
  static constexpr int kX = (kTwo ? 4 : 2) * kPart;   // B1 hi, lo, B2 ..
  static constexpr int kStage = kX + 2 * kPart;       // + C^T hi, lo
  static constexpr int kA1 = 0;
  static constexpr int kA2 = kA1 + kA;
  static constexpr int kStage0 = kA2 + (kTwo ? kA : 0);
  static constexpr int kBar = kStage0 + kStages * kStage;
  // a_full, a_empty, then x_full, x_empty, c_full, c_empty per stage
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kStages) + 1024;
  static_assert(kBytes <= 232448, "a CTA's shared memory");
};

// The tensor maps of a pass: the row operands (A1, A2), the score
// products' B operands in TF32 parts (B1, B2: hi, lo) and C^T's parts.  A
// pass without A2 / B2 repeats A1 / B1 there (never read).
struct Maps {
  CUtensorMap a1, a2, b1h, b1l, b2h, b2l, ch, cl;
};

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// The column tiles of an item: [lo, hi) (lo a multiple of 8), `per`
// tiles of TK over it for each of `heads` heads (the dV and dK passes walk
// the G query heads of the kv head; the forward and the dQ pass one
// range).  per 0: no column of the range is seen.
struct Cols {
  int lo, hi, per;
};

template <int TK>
__device__ __forceinline__ Cols cols_over(int lo, int hi) {
  const int lo8 = lo & ~7;
  return {lo8, hi, hi > lo ? (hi - lo8 + TK - 1) / TK : 0};
}

// Keys of the query block at c0 (rows compared at c0 - shift), as
// key_range takes them; queries that may see the key block at k0 (keys at
// k0 + shift ..), as query_range takes them.
template <int TK>
__device__ __forceinline__ Cols key_cols(int c0, int shift, int bq,
                                         int k_lim, int causal, int window) {
  int lo, hi, n;
  key_range(c0 - shift, bq, k_lim, causal, window, TK, &lo, &hi, &n);
  return cols_over<TK>(lo, hi);
}

template <int TK>
__device__ __forceinline__ Cols query_cols(int k0, int sq, int sk,
                                           int causal, int window,
                                           int shift) {
  const int k_last = min(k0 + kCtaRows, sk) - 1 + shift;
  const long long hi = (long long)k_last + (long long)window;
  return cols_over<TK>(causal ? k0 + shift : 0, hi < sq ? (int)hi : sq);
}

// s (64 x TK) = this warpgroup's rows of the f32 row operand at `a` (128
// rows, column blocks of 32, TMA's 128-byte swizzle: 16-byte unit u of row
// r at u ^ (r % 8)) times the natural tile's TK rows (its TF32 parts at hi
// and lo) transposed, over D: per k8 slice the A fragment is split in
// registers and the three products issued.  A slice's three products are
// little tensor work (3 x 16 cycles at N 32), so the next slice's floats
// are loaded before this slice's products issue, and three slices'
// fragments rotate through fr (slice `seq` + ks takes fr[(seq + ks) % 3]),
// two groups in flight.  The caller waits for the last groups.
template <int D, int TK>
__device__ __forceinline__ void score_product(float* s, const float* a,
                                              uint32_t hi, uint32_t lo,
                                              int r0, int t4, int seq,
                                              uint32_t (*fr)[8]) {
  // this thread's four A elements of slice ks: rows r0 and r0 + 8,
  // columns 8 ks + t4 and 8 ks + t4 + 4
  auto load = [&](int ks, float* x) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e & 1);
      const int col = 8 * ks + t4 + 4 * (e >> 1);
      x[e] = a[(col >> 5) * (kCtaRows * 32) + r * 32 +
               ((((col & 31) >> 2) ^ (r & 7)) << 2) + (col & 3)];
    }
  };
  float raw[2][4];
  load(0, raw[0]);
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    uint32_t* f = fr[(seq + ks) % 3];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32_fast(raw[ks & 1][e], f[e], f[4 + e]);
    if (ks + 1 < D / 8) load(ks + 1, raw[(ks + 1) & 1]);
    wg_fence();
    const uint64_t dh = desc_k(hi, TK, 0, ks), dl = desc_k(lo, TK, 0, ks);
#ifdef FLASH_ABLATE_NO_PRODUCTS
    if (r0 < 0)
#endif
    {
#ifdef FLASH_ABLATE_ONE_PASS   // A_hi B_hi alone
      if (ks == 0)
        mma_tf32<TK, false>(s, f, dh);
      else
        mma_tf32<TK, true>(s, f, dh);
#else
      if (ks == 0)
        mma_tf32<TK, false>(s, f + 4, dh);   // A_lo B_hi
      else
        mma_tf32<TK, true>(s, f + 4, dh);
      mma_tf32<TK, true>(s, f, dl);          // A_hi B_lo
      mma_tf32<TK, true>(s, f, dh);          // A_hi B_hi
#endif
    }
    wg_commit();
    wg_wait<2>();   // slice ks - 2's products have landed
  }
}

// acc (64 x D) = W (64 x TK: the f32 accumulator w of a score product)
// times the C^T tile (D rows x TK permuted positions, its TF32 parts at hi
// and lo), summed from zero.  Accumulator column 2 t4 + j of slice ks goes
// to fragment slot t4 + 4 j: a0 (g, 2 t4), a1 (g + 8, 2 t4), a2 (g,
// 2 t4 + 1), a3 (g + 8, 2 t4 + 1), which C^T's permutation matches.
// Fragments rotate through fr as in score_product (the caller has waited
// for every earlier product).
template <int D, int TK>
__device__ __forceinline__ void out_product(float* acc, const float* w,
                                            uint32_t hi, uint32_t lo,
                                            uint32_t (*fr)[8]) {
#pragma unroll
  for (int ks = 0; ks < TK / 8; ++ks) {
    uint32_t* f = fr[ks % 3];
    split_tf32_fast(w[4 * ks + 0], f[0], f[4]);
    split_tf32_fast(w[4 * ks + 2], f[1], f[5]);
    split_tf32_fast(w[4 * ks + 1], f[2], f[6]);
    split_tf32_fast(w[4 * ks + 3], f[3], f[7]);
    wg_fence();
    const uint64_t dh = desc_k(hi, D, 0, ks), dl = desc_k(lo, D, 0, ks);
#ifdef FLASH_ABLATE_NO_PRODUCTS
    if (hi == 0u)
#endif
    {
#ifdef FLASH_ABLATE_ONE_PASS
      if (ks == 0)
        mma_tf32<D, false>(acc, f, dh);
      else
        mma_tf32<D, true>(acc, f, dh);
#else
      if (ks == 0)
        mma_tf32<D, false>(acc, f + 4, dh);
      else
        mma_tf32<D, true>(acc, f + 4, dh);
      mma_tf32<D, true>(acc, f, dl);
      mma_tf32<D, true>(acc, f, dh);
#endif
    }
    wg_commit();
    wg_wait<2>();
  }
}

// The dV and dK passes' tile for a thread's two keys (rows) against the
// tile's queries t0 + col of one head, lc / dc their log-sum-exp (log2
// domain) and Delta: x (S^T) leaves with P^T and, for DK, y (dP^T) with
// dS^T = P^T (dP^T - Delta) times the softcap's slope.  MASKED applies
// the ragged, causal and window masks element by element; a tile whose
// pairs are all visible skips them (as flash_mma's online_softmax).
template <bool DK, bool MASKED, int ST>
__device__ __forceinline__ void key_tile(float (*x)[4], float (*y)[4],
                                         const float (*lc)[2],
                                         const float (*dc)[2],
                                         const int* kpos, const bool* key_ok,
                                         int t0, int n, float scale,
                                         float softcap, int causal,
                                         int window, int t4) {
#pragma unroll
  for (int nt = 0; nt < ST; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1, col = 8 * nt + 2 * t4 + (e & 1);
      float cg;
      const float s = flash_mma::score_log2(x[nt][e], scale, softcap, &cg);
      float p = exp2f(s - lc[nt][e & 1]);
      if (MASKED && !(col < n && key_ok[hh] &&
                      flash_mma::visible(t0 + col, kpos[hh], causal,
                                         window)))
        p = 0.f;
      x[nt][e] = p;
      if constexpr (DK) y[nt][e] = p * (y[nt][e] - dc[nt][e & 1]) * cg;
    }
}

// One pass (P) at width D.  out: O (fwd), dQ, dV or dK, f32, in the
// tensors' layout; lse_out the forward's log-sum-exp; lse and delta the
// backward's (B, Hq, Sq).  k_lim: key_limit's bound (fwd, dq).
template <int P, int D, bool KB>
__global__ void __launch_bounds__(flash_wgmma::kThreads, 1)
pass_kernel(const __grid_constant__ Maps mp, float* __restrict__ out,
            float* __restrict__ lse_out, const float* __restrict__ lse,
            const float* __restrict__ delta, int batch, int sq, int sk,
            int k_lim, int hq, int hkv, int bq, float scale, int causal,
            int window, float softcap, int k_off) {
  using L = Geo<P, D>;
  constexpr int TK = L::kTk;
  constexpr bool TWO = L::kTwo, KEYS = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t a_full = base + L::kBar, a_empty = a_full + 8;
  const uint32_t x_full = a_empty + 8, x_empty = x_full + 8 * L::kStages;
  const uint32_t c_full = x_empty + 8 * L::kStages;
  const uint32_t c_empty = c_full + 8 * L::kStages;
  if (threadIdx.x == 0) {
    mbar_init(a_full, 1);
    mbar_init(a_empty, kArrivals);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(x_full + 8 * s, 1);
      mbar_init(x_empty + 8 * s, kArrivals);
      mbar_init(c_full + 8 * s, 1);
      mbar_init(c_empty + 8 * s, kArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int g_n = hq / hkv, hb = hkv * batch;
  const int n_blk =
      KEYS ? (sk + kCtaRows - 1) / kCtaRows : (sq + bq - 1) / bq;
  const int n_items = n_blk * hb;
  const int shift = KB ? k_off : 0;
  // longest first: causal, the last query blocks see the most keys and
  // the first key blocks the most queries
  const bool descending = KEYS ? !causal : causal;
  // the tile's columns: the kv head's keys, or the G query heads' queries
  const int col_heads = KEYS ? g_n : 1;
  auto cols_of = [&](const Item& w) {
    if constexpr (KEYS)
      return query_cols<TK>(w.blk * kCtaRows, sq, sk, causal,
                            window, shift);
    else
      return key_cols<TK>(w.blk * bq, shift, bq, k_lim, causal, window);
  };
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // ---- producer: one thread issues every load
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    prefetch_map(&mp.a1);
    prefetch_map(&mp.b1h);
    prefetch_map(&mp.b1l);
    prefetch_map(&mp.ch);
    prefetch_map(&mp.cl);
    if constexpr (TWO) {
      prefetch_map(&mp.a2);
      prefetch_map(&mp.b2h);
      prefetch_map(&mp.b2l);
    }
    constexpr int n_a = TWO ? 2 : 1;
    int stage = 0;
    uint32_t phase = 0, a_phase = 0;
    for (int r = 0, it; (it = item_index(r)) < n_items; ++r) {
      const Item w = item_at(it, n_blk, hkv, hb, descending);
      const Cols c = cols_of(w);
      if (c.per == 0) continue;   // no column seen: no loads
      mbar_wait(a_empty, a_phase ^ 1);
      a_phase ^= 1;
      // the row operands: 128 keys of kv head h, or the G heads x bq
      // positions of the query block
      const int a_rows = KEYS ? kCtaRows : g_n * bq;
      mbar_expect_tx(a_full, n_a * (D / 32) * a_rows * 128);
#pragma unroll
      for (int cb = 0; cb < D / 32; ++cb) {
        const int ah = KEYS ? w.h : w.h * g_n;
        const int ar = KEYS ? w.blk * kCtaRows : w.blk * bq;
        tma_load_4d(base + L::kA1 + cb * kCtaRows * 128, &mp.a1, a_full,
                    cb * 32, ah, ar, w.b);
        if constexpr (TWO)
          tma_load_4d(base + L::kA2 + cb * kCtaRows * 128, &mp.a2, a_full,
                      cb * 32, ah, ar, w.b);
      }
      for (int j = 0; j < col_heads * c.per; ++j) {
        const int gi = j / c.per;
        const int t0 = c.lo + (j - gi * c.per) * TK;
        const int head = KEYS ? w.h * g_n + gi : w.h;   // the columns' head
        const int heads = KEYS ? hq : hkv;
        const uint32_t st = base + L::kStage0 + stage * L::kStage;
        mbar_wait(x_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(x_full + 8 * stage, L::kX);
#pragma unroll
        for (int cb = 0; cb < D / 32; ++cb) {
          const uint32_t o = cb * TK * 128;
          tma_load_4d(st + o, &mp.b1h, x_full + 8 * stage, cb * 32, head, t0,
                      w.b);
          tma_load_4d(st + L::kPart + o, &mp.b1l, x_full + 8 * stage,
                      cb * 32, head, t0, w.b);
          if constexpr (TWO) {
            tma_load_4d(st + 2 * L::kPart + o, &mp.b2h, x_full + 8 * stage,
                        cb * 32, head, t0, w.b);
            tma_load_4d(st + 3 * L::kPart + o, &mp.b2l, x_full + 8 * stage,
                        cb * 32, head, t0, w.b);
          }
        }
        mbar_wait(c_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(c_full + 8 * stage, 2 * L::kPart);
#pragma unroll
        for (int j2 = 0; j2 < TK / 32; ++j2) {
          const uint32_t o = L::kX + j2 * D * 128;
          tma_load_3d(st + o, &mp.ch, c_full + 8 * stage, t0 + 32 * j2, 0,
                      w.b * heads + head);
          tma_load_3d(st + L::kPart + o, &mp.cl, c_full + 8 * stage,
                      t0 + 32 * j2, 0, w.b * heads + head);
        }
        if (++stage == L::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg holds rows 64 wg .. 64 wg + 63
  regs_alloc<kConsumerRegs>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int t4 = lane & 3;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  const float* a1s = reinterpret_cast<const float*>(gen + L::kA1);
  const float* a2s = reinterpret_cast<const float*>(gen + L::kA2);
  int stage = 0;
  uint32_t phase = 0, a_phase = 0;
  uint32_t fr[3][8];   // three k8 slices' A fragments: hi 0-3, lo 4-7
  for (int r = 0, it; (it = item_index(r)) < n_items; ++r) {
    const Item w = item_at(it, n_blk, hkv, hb, descending);
    const Cols c = cols_of(w);
    // rows: queries (fwd, dq) or keys (dv, dk)
    Rows rw;
    int kp[2], kpos[2];
    bool key_ok[2];
    float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    if constexpr (KEYS) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        kp[hh] = w.blk * kCtaRows + r0 + 8 * hh;
        kpos[hh] = kp[hh] + shift;
        key_ok[hh] = kp[hh] < sk;
      }
    } else {
      rw = rows_of(r0, w.blk * bq, g_n, bq, sq, shift);
      if constexpr (P == kDq) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long li =
              ((long long)w.b * hq + w.h * g_n + rw.r[hh] % g_n) * sq +
              rw.pos[hh] + shift;
          lse2[hh] = rw.live[hh] ? lse[li] * flash_mma::kLog2e : 0.f;
          dl[hh] = rw.live[hh] ? delta[li] : 0.f;
        }
      }
    }
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float tot[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) tot[i] = 0.f;
    const int n_t = col_heads * c.per;
    if (n_t > 0) {
      mbar_wait(a_full, a_phase);
      a_phase ^= 1;
    }
    for (int j = 0; j < n_t; ++j) {
      const int gi = j / c.per;
      const int t0 = c.lo + (j - gi * c.per) * TK;
      const int n = min(TK, c.hi - t0);   // columns in range
      // the columns' log-sum-exp (log2 domain) and Delta, loaded before
      // the wait
      float lc[TK / 8][2], dc[TK / 8][2];
      if constexpr (KEYS) {
        const long long crow =
            ((long long)w.b * hq + w.h * g_n + gi) * sq + t0;
#pragma unroll
        for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int col = 8 * nt + 2 * t4 + e2;
            const bool ok = col < n;
            lc[nt][e2] = ok ? lse[crow + col] * flash_mma::kLog2e : 0.f;
            if constexpr (P == kDk) dc[nt][e2] = ok ? delta[crow + col] : 0.f;
          }
      }
      const uint32_t st = base + L::kStage0 + stage * L::kStage;
      mbar_wait(x_full + 8 * stage, phase);
      float x[TK / 2], y[TWO ? TK / 2 : 1];
      score_product<D, TK>(x, a1s, st, st + L::kPart, r0, t4, 0, fr);
      if constexpr (TWO)   // its slices follow x's in the rotation
        score_product<D, TK>(y, a2s, st + 2 * L::kPart, st + 3 * L::kPart,
                             r0, t4, D / 8, fr);
      wg_wait<0>();
      fence_regs<TK / 2>(x);
      if constexpr (TWO) fence_regs<TK / 2>(y);
      if (lane == 0) {
        mbar_arrive(x_empty + 8 * stage);
        if (j == n_t - 1) mbar_arrive(a_empty);
      }
      auto sx = reinterpret_cast<float(*)[4]>(x);
      auto sy = reinterpret_cast<float(*)[4]>(y);
      float alpha[2] = {1.f, 1.f};
      if constexpr (P == kFwd) {
        float rs[2] = {0.f, 0.f};
        if (n == TK && flash_mma::all_visible(rw.p_min, rw.p_max, t0,
                                              t0 + TK - 1, causal, window))
          flash_mma::online_softmax<false, TK / 8>(
              sx, m, alpha, rs, rw.pos, t0, n, scale, softcap, causal,
              window, t4);
        else
          flash_mma::online_softmax<true, TK / 8>(
              sx, m, alpha, rs, rw.pos, t0, n, scale, softcap, causal,
              window, t4);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          l[hh] = l[hh] * alpha[hh] + flash_mma::quad_sum(rs[hh]);
      } else if constexpr (P == kDq) {
        if (n == TK && flash_mma::all_visible(rw.p_min, rw.p_max, t0,
                                              t0 + TK - 1, causal, window))
          flash_mma::grad_tile<false, TK / 8>(sx, sy, lse2, dl, rw.pos, t0,
                                              n, scale, softcap, causal,
                                              window, t4);
        else
          flash_mma::grad_tile<true, TK / 8>(sx, sy, lse2, dl, rw.pos, t0,
                                             n, scale, softcap, causal,
                                             window, t4);
      } else {
        // every key of the block against every query of the tile
        const int k_min = w.blk * kCtaRows + shift;
        if (n == TK && w.blk * kCtaRows + kCtaRows <= sk &&
            flash_mma::all_visible(t0, t0 + TK - 1, k_min,
                                   k_min + kCtaRows - 1, causal,
                                   window))
          key_tile<P == kDk, false, TK / 8>(sx, sy, lc, dc, kpos, key_ok,
                                            t0, n, scale, softcap, causal,
                                            window, t4);
        else
          key_tile<P == kDk, true, TK / 8>(sx, sy, lc, dc, kpos, key_ok, t0,
                                           n, scale, softcap, causal, window,
                                           t4);
      }
      mbar_wait(c_full + 8 * stage, phase);
      float acc[D / 2];
      out_product<D, TK>(acc, P == kDk ? y : x, st + L::kX,
                         st + L::kX + L::kPart, fr);
      wg_wait<0>();
      fence_regs<D / 2>(acc);
      if (lane == 0) mbar_arrive(c_empty + 8 * stage);
      // the tile's sum into the f32 total (the forward rescales it first)
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        tot[i] = (P == kFwd ? tot[i] * alpha[(i >> 1) & 1] : tot[i]) + acc[i];
      if (++stage == L::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- epilogue: f32 pairs straight from the totals
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      long long orow;
      float mul = 1.f;
      if constexpr (KEYS) {
        if (!key_ok[hh]) continue;
        orow = ((long long)w.b * sk + kp[hh]) * hkv + w.h;
        if constexpr (P == kDk) mul = scale;
      } else {
        if (!rw.live[hh]) continue;
        const int head = w.h * g_n + rw.r[hh] % g_n;
        const int pos = rw.pos[hh] + shift;
        orow = ((long long)w.b * sq + pos) * hq + head;
        if constexpr (P == kFwd) {
          mul = 1.f / fmaxf(l[hh], 1e-30f);
          if (t4 == 0)   // m is in the log2 domain
            lse_out[((long long)w.b * hq + head) * sq + pos] =
                KB && l[hh] == 0.f
                    ? -INFINITY
                    : (m[hh] + log2f(fmaxf(l[hh], 1e-30f))) *
                          flash_mma::kLn2;
        } else {
          mul = scale;
        }
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        store2(out + orow * D + nt * 8 + 2 * t4, tot[4 * nt + 2 * hh] * mul,
               tot[4 * nt + 2 * hh + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// pre-passes: the TF32 parts of the B and C operands
// ---------------------------------------------------------------------------

// The pre-passes of one call, each a single launch over every array it
// splits (four natural ones and three transposed in the backward), so
// that small shapes do not pay a launch an array.
constexpr int kMaxSplits = 4;

// Arrays whose lo part is made in place of layout (their hi part is the
// array itself): job j's float4s of x[j] -> lo[j]; end[j] the running sum
// of the jobs' float4s.
struct Splits {
  const float4* x[kMaxSplits];
  float4* lo[kMaxSplits];
  long long end[kMaxSplits];
  int n;
};

// Arrays split transposed: job j's x[j] (B, S, H, D) -> hi[j], lo[j] (B,
// H, D, sp[j]), column 8 i + c of a row holding position 8 i + 2 (c % 4)
// + c / 4 (the permutation out_product's fragments take), zero past S;
// blocks [first[j], first[j + 1]) of 32 x 32 elements are job j's.
struct SplitsT {
  const float* x[kMaxSplits];
  float* hi[kMaxSplits];
  float* lo[kMaxSplits];
  int s_len[kMaxSplits], sp[kMaxSplits], heads[kMaxSplits];
  int first[kMaxSplits + 1];
  int n, d;
};

// Job j of the n whose range [end[j - 1], end[j]) (or blocks
// [first[j], first[j + 1])) holds i.
__device__ __forceinline__ int job_of(const long long* end, int n,
                                      long long i) {
  int j = 0;
#pragma unroll
  for (int t = 0; t < kMaxSplits - 1; ++t) j += t + 1 < n && i >= end[t];
  return j;
}

template <class T>
__device__ __forceinline__ T pick(const T (&a)[kMaxSplits], int j) {
  return j == 0 ? a[0] : j == 1 ? a[1] : j == 2 ? a[2] : a[3];
}

__global__ void __launch_bounds__(256) split_kernel(const Splits jobs) {
  const long long total = pick(jobs.end, jobs.n - 1);
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < total;
       i += (long long)gridDim.x * 256) {
    const int j = job_of(jobs.end, jobs.n, i);
    const long long k = i - (j ? pick(jobs.end, j - 1) : 0);
    const float4 v = pick(jobs.x, j)[k];
    pick(jobs.lo, j)[k] = make_float4(
        __uint_as_float(lo_of_raw(v.x)), __uint_as_float(lo_of_raw(v.y)),
        __uint_as_float(lo_of_raw(v.z)), __uint_as_float(lo_of_raw(v.w)));
  }
}

// One 32 x 32 block a CTA, through shared memory so that reads and writes
// are whole rows of 128 bytes.
__global__ void __launch_bounds__(256) split_t_kernel(const SplitsT jobs) {
  __shared__ float blk[32][33];
  long long first[kMaxSplits];
#pragma unroll
  for (int t = 0; t < kMaxSplits; ++t) first[t] = jobs.first[t + 1];
  const int j = job_of(first, jobs.n, blockIdx.x);
  const int s_len = pick(jobs.s_len, j), sp = pick(jobs.sp, j);
  const int heads = pick(jobs.heads, j), d = jobs.d;
  const int sb = (sp + 31) / 32, db = d / 32;
  const int id = blockIdx.x - (j ? jobs.first[j] : 0);
  const int bh = id / (sb * db), rest = id - bh * sb * db;
  const int s0 = (rest / db) * 32, d0 = (rest % db) * 32;
  const int b = bh / heads, h = bh - b * heads;
  const float* x = pick(jobs.x, j);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int pos = s0 + r;
    blk[r][tx] = pos < s_len
                     ? x[(((long long)b * s_len + pos) * heads + h) * d + d0 +
                         tx]
                     : 0.f;
  }
  __syncthreads();
  const int src = (tx & ~7) + 2 * (tx & 3) + ((tx >> 2) & 1);
  if (s0 + tx >= sp) return;
  float* hi = pick(jobs.hi, j);
  float* lo = pick(jobs.lo, j);
  for (int r = ty; r < 32; r += 8) {
    uint32_t hv, lv;
    split_tf32(blk[src][r], hv, lv);
    const long long o = ((long long)bh * d + d0 + r) * sp + s0 + tx;
    hi[o] = __uint_as_float(hv);
    lo[o] = __uint_as_float(lv);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Positions of a transposed part, a multiple of 8 (the permutation's
// groups; TMA's 16-byte row pitch).
inline long long t_len(int s_len) { return (s_len + 7) / 8 * 8; }

// A (B, S, H, D) f32 tensor as the 4-D map (D, H, S, B), boxes of 32
// features (128 bytes) x box_heads heads x box_rows positions.
inline bool map_bshd_f32(CUtensorMap* m, const void* p, int batch, int s_len,
                         int heads, int d, int box_heads, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s_len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 4,
                                 (cuuint64_t)heads * d * 4,
                                 (cuuint64_t)s_len * heads * d * 4};
  const cuuint32_t box[4] = {32, (cuuint32_t)box_heads, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A transposed part (B H, D, Sp) as the 3-D map (Sp, D, B H), boxes of 32
// positions x D rows.
inline bool map_t_f32(CUtensorMap* m, const void* p, int bh, int d,
                      long long sp) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)sp, (cuuint64_t)d, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)sp * 4, (cuuint64_t)sp * d * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)d, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One array of n floats (a multiple of 4) for split(), with its lo part
// (hi unused), or a (B, S, H, D) one for split_t(), with its hi and lo
// parts.
struct Part {
  const void* x;
  float* hi;
  float* lo;
  long long n;            // split: floats
  int batch, s_len, heads;   // split_t
};

// The arrays' TF32 lo parts in their layout, one launch.
inline int split(std::initializer_list<Part> parts, cudaStream_t st) {
  Splits jobs{};
  long long total = 0;
  for (const Part& p : parts) {
    total += p.n / 4;
    jobs.x[jobs.n] = static_cast<const float4*>(p.x);
    jobs.lo[jobs.n] = reinterpret_cast<float4*>(p.lo);
    jobs.end[jobs.n++] = total;
  }
  const long long blocks = (total + 255) / 256;
  split_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(jobs);
  return (int)cudaGetLastError();
}

// The arrays' TF32 parts transposed and permuted (B, H, D, t_len(S)), one
// launch.
inline int split_t(std::initializer_list<Part> parts, int d,
                   cudaStream_t st) {
  SplitsT jobs{};
  jobs.d = d;
  for (const Part& p : parts) {
    const int j = jobs.n++;
    jobs.x[j] = static_cast<const float*>(p.x);
    jobs.hi[j] = p.hi;
    jobs.lo[j] = p.lo;
    jobs.s_len[j] = p.s_len;
    jobs.sp[j] = (int)t_len(p.s_len);
    jobs.heads[j] = p.heads;
    jobs.first[j + 1] = jobs.first[j] + (jobs.sp[j] + 31) / 32 * (d / 32) *
                                            p.batch * p.heads;
  }
  split_t_kernel<<<jobs.first[jobs.n], 256, 0, st>>>(jobs);
  return (int)cudaGetLastError();
}

// Launches pass P at width D over its items.
template <int P, int D, bool KB>
int launch_pass(const Maps& mp, float* out, float* lse_out, const float* lse,
                const float* delta, int batch, int sq, int sk, int hq,
                int hkv, float scale, int causal, int window, float softcap,
                int k_off, cudaStream_t st) {
  using L = Geo<P, D>;
  auto kernel = pass_kernel<P, D, KB>;
  // setmaxnreg moves registers from the producer to the consumers on the
  // assumption that each of the 384 threads got 168
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return (int)e;
    regs = fa.numRegs;
  }
  if (regs != 168) return (int)cudaErrorInvalidConfiguration;
  static size_t opted = 48 * 1024;
  const cudaError_t e = allow_smem(kernel, L::kBytes, &opted);
  if (e != cudaSuccess) return (int)e;
  const int g_n = hq / hkv, bq = kCtaRows / g_n;
  const long long n_blk =
      L::kKeys ? (sk + kCtaRows - 1) / kCtaRows : (sq + bq - 1) / bq;
  kernel<<<grid_size(n_blk * hkv * batch), flash_wgmma::kThreads, L::kBytes,
           st>>>(
      mp, out, lse_out, lse, delta, batch, sq, sk,
      key_limit(sq, sk, causal, k_off), hq, hkv, bq, scale, causal, window,
      softcap, k_off);
  return (int)cudaGetLastError();
}

template <class F>
int dispatch_width(int d, F&& f) {
  if (d == 64) return f(std::integral_constant<int, 64>{});
  if (d == 128) return f(std::integral_constant<int, 128>{});
  return (int)cudaErrorInvalidValue;
}

// The workspace (floats) of the forward: K's TF32 lo part, V^T's hi and
// lo.
inline long long fwd_ws_floats(int d, int batch, int sk, int hkv) {
  const long long nk = (long long)batch * sk * hkv * d;
  return nk + 2 * (long long)batch * hkv * d * t_len(sk);
}

// ... of the backward: K's and V's lo parts, K^T's hi and lo, Q's and
// dO's lo, Q^T's and dO^T's hi and lo.
inline long long bwd_ws_floats(int d, int batch, int sq, int sk, int hq,
                               int hkv) {
  const long long nk = (long long)batch * sk * hkv * d;
  const long long nq = (long long)batch * sq * hq * d;
  return 2 * nk + 2 * (long long)batch * hkv * d * t_len(sk) + 2 * nq +
         4 * (long long)batch * hq * d * t_len(sq);
}

inline bool ws_ok(const float* ws, long long have, long long need) {
  return ws != nullptr && have >= need && (uintptr_t)ws % 16 == 0;
}

// The forward: the pre-passes (K's lo part, V^T's parts: two launches),
// then the pass.  q, k, v f32 (B, S, H, D); o f32; lse (B, Hq, Sq).
template <bool KB>
int run_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
            float* ws, long long ws_floats, int batch, int sq, int sk, int hq,
            int hkv, int d, float scale, int causal, int window,
            float softcap, int k_off, cudaStream_t st) {
  if (!takes(d) || !ws_ok(ws, ws_floats, fwd_ws_floats(d, batch, sk, hkv)))
    return (int)cudaErrorInvalidValue;
  const long long nk = (long long)batch * sk * hkv * d;
  const long long nt = (long long)batch * hkv * d * t_len(sk);
  float* kl = ws;
  float* vth = kl + nk;
  float* vtl = vth + nt;
  int err = 0;
#ifndef FLASH_ABLATE_NO_PREPASS
  err = split({{k, nullptr, kl, nk}}, st);
  if (!err) err = split_t({{v, vth, vtl, 0, batch, sk, hkv}}, d, st);
#endif
  if (err) return err;
  return dispatch_width(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    constexpr int TK = Geo<kFwd, D>::kTk;
    const int g_n = hq / hkv, bq = kCtaRows / g_n;
    Maps mp;
    if (!map_bshd_f32(&mp.a1, q, batch, sq, hq, D, g_n, bq) ||
        !map_bshd_f32(&mp.b1h, k, batch, sk, hkv, D, 1, TK) ||
        !map_bshd_f32(&mp.b1l, kl, batch, sk, hkv, D, 1, TK) ||
        !map_t_f32(&mp.ch, vth, batch * hkv, D, t_len(sk)) ||
        !map_t_f32(&mp.cl, vtl, batch * hkv, D, t_len(sk)))
      return (int)cudaErrorInvalidValue;
    mp.a2 = mp.a1;
    mp.b2h = mp.b1h;
    mp.b2l = mp.b1l;
    return launch_pass<kFwd, D, KB>(mp, static_cast<float*>(o), lse,
                                    nullptr, nullptr, batch, sq, sk, hq, hkv,
                                    scale, causal, window, softcap, k_off,
                                    st);
  });
}

// The backward after Delta (in `delta`): the pre-passes (K's, V's, Q's
// and dO's lo parts, then K^T's, Q^T's and dO^T's hi and lo: two
// launches), then the dQ, dV and dK passes.  q, k, v, d_o f32 (B, S, H,
// D); dq, dk, dv f32.
template <bool KB>
int run_bwd(const void* q, const void* k, const void* v, const void* d_o,
            const float* lse, const float* delta, float* ws,
            long long ws_floats, void* dq, void* dk, void* dv, int batch,
            int sq, int sk, int hq, int hkv, int d, float scale, int causal,
            int window, float softcap, int k_off, cudaStream_t st) {
  if (!takes(d) ||
      !ws_ok(ws, ws_floats, bwd_ws_floats(d, batch, sq, sk, hq, hkv)))
    return (int)cudaErrorInvalidValue;
  const long long nk = (long long)batch * sk * hkv * d;
  const long long nq = (long long)batch * sq * hq * d;
  const long long ntk = (long long)batch * hkv * d * t_len(sk);
  const long long ntq = (long long)batch * hq * d * t_len(sq);
  float* p = ws;
  auto take = [&](long long n) {
    float* r = p;
    p += n;
    return r;
  };
  float* kl = take(nk);
  float* vl = take(nk);
  float* kth = take(ntk);
  float* ktl = take(ntk);
  float* ql = take(nq);
  float* gl = take(nq);
  float* qth = take(ntq);
  float* qtl = take(ntq);
  float* gth = take(ntq);
  float* gtl = take(ntq);
  int err = 0;
#ifndef FLASH_ABLATE_NO_PREPASS
  err = split({{k, nullptr, kl, nk}, {v, nullptr, vl, nk},
               {q, nullptr, ql, nq}, {d_o, nullptr, gl, nq}},
              st);
  if (!err)
    err = split_t({{k, kth, ktl, 0, batch, sk, hkv},
                   {q, qth, qtl, 0, batch, sq, hq},
                   {d_o, gth, gtl, 0, batch, sq, hq}},
                  d, st);
#endif
  if (err) return err;
  return dispatch_width(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    constexpr int TK = Geo<kDq, D>::kTk;
    static_assert(TK == Geo<kDv, D>::kTk && TK == Geo<kDk, D>::kTk,
                  "one tile width");
    const int g_n = hq / hkv, bq = kCtaRows / g_n;
    Maps mq, mv, mk;
    // dQ: rows Q, dO; scores against K, V; output through K^T
    if (!map_bshd_f32(&mq.a1, q, batch, sq, hq, D, g_n, bq) ||
        !map_bshd_f32(&mq.a2, d_o, batch, sq, hq, D, g_n, bq) ||
        !map_bshd_f32(&mq.b1h, k, batch, sk, hkv, D, 1, TK) ||
        !map_bshd_f32(&mq.b1l, kl, batch, sk, hkv, D, 1, TK) ||
        !map_bshd_f32(&mq.b2h, v, batch, sk, hkv, D, 1, TK) ||
        !map_bshd_f32(&mq.b2l, vl, batch, sk, hkv, D, 1, TK) ||
        !map_t_f32(&mq.ch, kth, batch * hkv, D, t_len(sk)) ||
        !map_t_f32(&mq.cl, ktl, batch * hkv, D, t_len(sk)))
      return (int)cudaErrorInvalidValue;
    // dK: rows K, V; scores against Q, dO; output through Q^T
    if (!map_bshd_f32(&mk.a1, k, batch, sk, hkv, D, 1, kCtaRows) ||
        !map_bshd_f32(&mk.a2, v, batch, sk, hkv, D, 1, kCtaRows) ||
        !map_bshd_f32(&mk.b1h, q, batch, sq, hq, D, 1, TK) ||
        !map_bshd_f32(&mk.b1l, ql, batch, sq, hq, D, 1, TK) ||
        !map_bshd_f32(&mk.b2h, d_o, batch, sq, hq, D, 1, TK) ||
        !map_bshd_f32(&mk.b2l, gl, batch, sq, hq, D, 1, TK) ||
        !map_t_f32(&mk.ch, qth, batch * hq, D, t_len(sq)) ||
        !map_t_f32(&mk.cl, qtl, batch * hq, D, t_len(sq)))
      return (int)cudaErrorInvalidValue;
    // dV: rows K; scores against Q; output through dO^T
    mv = mk;
    mv.a2 = mk.a1;
    mv.b2h = mk.b1h;
    mv.b2l = mk.b1l;
    if (!map_t_f32(&mv.ch, gth, batch * hq, D, t_len(sq)) ||
        !map_t_f32(&mv.cl, gtl, batch * hq, D, t_len(sq)))
      return (int)cudaErrorInvalidValue;
    int e = launch_pass<kDq, D, KB>(mq, static_cast<float*>(dq), nullptr,
                                    lse, delta, batch, sq, sk, hq, hkv, scale,
                                    causal, window, softcap, k_off, st);
    if (!e)
      e = launch_pass<kDv, D, KB>(mv, static_cast<float*>(dv), nullptr, lse,
                                  delta, batch, sq, sk, hq, hkv, scale,
                                  causal, window, softcap, k_off, st);
    if (!e)
      e = launch_pass<kDk, D, KB>(mk, static_cast<float*>(dk), nullptr, lse,
                                  delta, batch, sq, sk, hq, hkv, scale,
                                  causal, window, softcap, k_off, st);
    return e;
  });
}

}  // namespace flash_tf32
