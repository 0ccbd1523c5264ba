// Dense flash attention's backward for Hopper at head_dim 256 (gemma2-2b):
// the two bf16 passes on wgmma, with TMA loads into rings of stages
// guarded by mbarriers, a producer warp whose registers setmaxnreg hands to
// the consumers, and a persistent grid that takes the longest items first.
// The forward at D 256 is flash_wgmma.cuh's fwd_kernel with tiles of its
// own (FwdTraits<256> there).
//
// Replaces, at D 256, the gradient of src/repro/kernels/attention/
// attention.py:72 flash_attention_pallas (dq256_kernel and dkv256_kernel:
// the JAX package has no backward kernel, XLA differentiates its jnp
// attention).  flash_bwd.cu gives the function, the layouts and the
// masks; flash_wgmma.cuh's header the pieces these kernels share with the
// D 64/112/128 ones (the persistent item order, the position-major query
// blocks of G heads, the key-block flag KB and its shifted masks, the
// softmax in the log2 domain with a finite -1e30 initial max, the two-pass
// backward without atomics).  The D-128 tiles do not fit at D 256: the
// dQ pass's Q, dO and three stages of 64 keys' K + V, and the dK/dV
// pass's 128 keys' dK and dV a CTA, need 320 KB of shared memory and 256
// accumulator registers a thread, against 227 KB and 232.  So the work is
// divided anew.
//
// What bounds them: operations, as at D 128, or bytes for a short key
// block.  At gemma2-2b's whole-sequence shape (B 2, Hq 8, S 4096, causal)
// the two passes do 3.5 times the forward's 4 B Hq S (S + 1) / 2 D = 137
// GFLOP: 481 GFLOP, 0.49 ms at 989 TFLOP/s bf16.  A rank's key block of
// 256 keys at train_4k's B 16 moves more than it multiplies: the f32 dQ
// partial and the read of Q, O and dO bound it at 0.411 ms
// (kernels/work.py).
//
// What the design does about it:
//  * the 128-byte swizzle caps a TMA box at 64 columns, so a D-256 row
//    comes in four boxes, stored as four column blocks of R rows x 128
//    bytes (flash_wgmma.cuh's descriptors step through them);
//  * the dQ pass's epilogue goes through shared-memory pieces, as the
//    forward's at D 256 does (flash_wgmma.cuh's epilogue staging), in the
//    warpgroup's own 64 rows of Q and dO (eight pieces: the whole f32 dQ
//    at once), which it frees for the next item's loads only after its
//    copies;
//  * dq256_kernel: two warpgroups of 64 query rows, each holding its
//    64 x 256 f32 dQ (128 registers), over 32-key tiles: S and dP are
//    m64n32k16 (16 registers each), dS 8 registers as bf16, dQ += dS K
//    m64n256k16.  Q and dO are resident (128 KB), so 64-key tiles (64 KB
//    a K + V stage) would leave room for one stage, and nothing could load
//    while a tile is in use; at 32 keys three stages fit (96 KB: 224 KB in
//    all) and keep the next K a full iteration ahead, as at D 128.  As
//    there, tile i's S and dP are issued with tile i - 1's dQ += dS K;
//  * dkv256_kernel: a CTA holds 64 keys (K and V resident, 64 KB) and
//    streams 64-query tiles of Q and dO (64 KB a stage, two stages).  Its
//    two warpgroups split the four products: warpgroup 0 computes
//    S^T = K Q^T, forms P^T and keeps dV += P^T dO; warpgroup 1 computes
//    dP^T = V dO^T and keeps dK += dS^T Q.  dS^T = P^T (dP^T - Delta)
//    times the softcap's slope needs P and that slope, which warpgroup 0
//    hands over as their f32 product through a 16 KB tile in shared
//    memory, double-buffered: thread t of warpgroup 1 holds dP^T in the
//    accumulator layout in which thread t of warpgroup 0 holds S^T, so
//    the tile mirrors the registers (float4 i of thread t at (128 i + t)
//    x 16 bytes, conflict-free both ways) and no transpose is needed.  Full
//    and empty mbarriers (128 arrivals each) guard each buffer.  Each
//    warpgroup does two of the four products and holds 128 registers of
//    accumulator plus 32 of the tile's scores; no product is recomputed.
//    Shared memory: 64 + 128 + 1 (the stages' log-sum-exp and Delta) + 32
//    KB: 225 KB.  Registers: 232 a consumer thread, 40 the producer's;
//  * the dK/dV grid has ceil(Sk / 64) x Hkv x B items (twice D 128's), so
//    a key block of 256 keys at B 1 still spreads over 16 CTAs;
//  * gemma2-2b caps every score (tanh, cap 50).  With tanhf and a division
//    a score, the cap cost these kernels and the D-256 forward about as
//    much as their products (PERF.md section 6); they take the tanh from
//    one exp2 and one fast division instead (flash_mma::score_log2_fast,
//    within 1e-6 of tanh).
//
// The masks, the key offset (KB), the zero dK and dV of keys no query
// sees and the zero rows of a query block that sees no key of a key block
// are those of flash_wgmma.cuh, computed by the same helpers.
#pragma once

#include "flash_wgmma.cuh"

namespace flash_wgmma {

constexpr int kTkDq256 = 32;     // keys per tile, dQ pass
constexpr int kDq256Stages = 3;
constexpr int kKeys256 = 64;     // keys per CTA, dK/dV pass
constexpr int kTq256 = 64;       // queries per tile, dK/dV pass
constexpr int kDkv256Stages = 2;

// The dK/dV pass's P^T tile: 16 bytes of f32 into shared memory.
__device__ __forceinline__ void st_shared16(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// ---------------------------------------------------------------------------
// backward, pass 1: dQ
// ---------------------------------------------------------------------------

struct Dq256Smem {
  static constexpr int kQ = 0;                         // kRows x 256
  static constexpr int kG = kQ + kRows * kD256 * 2;    // dO, kRows x 256
  static constexpr int kTile = kTkDq256 * kD256 * 2;
  static constexpr int kK = kG + kRows * kD256 * 2;    // kDq256Stages K tiles
  static constexpr int kV = kK + kDq256Stages * kTile;
  static constexpr int kBar = kV + kDq256Stages * kTile;
  // q_full, q_empty, then k_full, v_full, k_empty, v_empty per stage
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kDq256Stages) + 1024;
};

// Piece p (of 8) of warpgroup wg's rows in the Q (p < 4) and dO areas:
// column block p % 4's 64 rows of the group.
__device__ __forceinline__ uint32_t dq_piece(uint32_t base, int wg, int p) {
  return base + (p < 4 ? Dq256Smem::kQ : Dq256Smem::kG) +
         (p & 3) * kRows * 128 + wg * kPiece;
}

template <bool KB>
__global__ void __launch_bounds__(kThreads, 1)
dq256_kernel(const __grid_constant__ CUtensorMap q_map,
             const __grid_constant__ CUtensorMap g_map,
             const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map,
             const float* __restrict__ lse, const float* __restrict__ delta,
             OutT<KB>* __restrict__ dq, int batch, int sq, int k_lim, int hq,
             int hkv, int bq, float scale, int causal, int window,
             float softcap, int k_off) {
  using L = Dq256Smem;
  using T = OutT<KB>;
  constexpr int D = kD256, TK = kTkDq256, NS = kDq256Stages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, v_full = k_full + 8 * NS;
  // V of a stage is free once its dP has landed, K once its dQ has (an
  // iteration later)
  const uint32_t k_empty = v_full + 8 * NS;
  const uint32_t v_empty = k_empty + 8 * NS;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kArrivals);
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kArrivals);
      mbar_init(v_empty + 8 * s, kArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int g_n = hq / hkv, hb = hkv * batch;
  const int n_blk = (sq + bq - 1) / bq, n_items = n_blk * hb;
  const int shift = KB ? k_off : 0;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    prefetch_map(&q_map);
    prefetch_map(&g_map);
    prefetch_map(&k_map);
    prefetch_map(&v_map);
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int r = 0, it; (it = item_index(r)) < n_items; ++r) {
      const Item w = item_at(it, n_blk, hkv, hb, causal);
      const int c0 = w.blk * bq;
      int k_lo, k_hi, n_tiles;
      block_key_range<KB>(c0, shift, bq, k_lim, causal, window, TK, &k_lo,
                          &k_hi, &n_tiles);
      if (KB && n_tiles == 0) continue;   // no key of the block: no loads
      // Q and dO are also the epilogue's staging: free once the consumers
      // have copied dQ out
      mbar_wait(q_empty, q_phase ^ 1);
      q_phase ^= 1;
      mbar_expect_tx(q_full, 2 * (D / 64) * g_n * bq * 128);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(base + L::kQ + c * kRows * 128, &q_map, q_full, c * 64,
                    w.h * g_n, c0, w.b);
        tma_load_4d(base + L::kG + c * kRows * 128, &g_map, q_full, c * 64,
                    w.h * g_n, c0, w.b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int t0 = k_lo + i * TK;
        const uint32_t kt = base + L::kK + stage * L::kTile;
        const uint32_t vt = base + L::kV + stage * L::kTile;
        mbar_wait(k_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(k_full + 8 * stage, L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(kt + c * TK * 128, &k_map, k_full + 8 * stage, c * 64,
                      w.h, t0, w.b);
        mbar_wait(v_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(v_full + 8 * stage, L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(vt + c * TK * 128, &v_map, v_full + 8 * stage, c * 64,
                      w.h, t0, w.b);
        if (++stage == NS) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int t4 = lane & 3, tid = threadIdx.x & 127;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  int stage = 0;
  uint32_t phase = 0, q_phase = 0;
  for (int r = 0, it; (it = item_index(r)) < n_items; ++r) {
    const Item w = item_at(it, n_blk, hkv, hb, causal);
    const int c0 = w.blk * bq;
    int k_lo, k_hi, n_tiles;
    block_key_range<KB>(c0, shift, bq, k_lim, causal, window, TK, &k_lo,
                        &k_hi, &n_tiles);
    const Rows rw = rows_of(r0, c0, g_n, bq, sq, shift);
    long long orow[4];
    out_rows(orow, wg, tid, c0, g_n, bq, sq, hq, w);
    if (KB && n_tiles == 0) {   // the rows saw no key: a zero dQ
#pragma unroll
      for (int p = 0; p < kD256 / kPieceCols<T>; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (orow[i] >= 0)
            store_unit(dq, orow[i], p * kPieceCols<T>, tid & 7,
                       make_uint4(0, 0, 0, 0));
      continue;
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float lse2[2], dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long li =
          ((long long)w.b * hq + w.h * g_n + rw.r[hh] % g_n) * sq +
          rw.pos[hh] + shift;
      lse2[hh] = rw.live[hh] ? lse[li] * flash_mma::kLog2e : 0.f;
      dl[hh] = rw.live[hh] ? delta[li] : 0.f;
    }
    float s[TK / 2], dp[TK / 2];
    unsigned ds_prev[TK / 16][4];   // tile i - 1's dS, bf16
    mbar_wait(q_full, q_phase);
    q_phase ^= 1;
    // As in flash_wgmma.cuh's dq_kernel: tile i's S and dP are issued with
    // tile i - 1's dQ += dS K, tile 0 on its own.
    auto issue_s_dp = [&]() {   // S and dP of the tile in `stage`
      mbar_wait(k_full + 8 * stage, phase);
      wg_fence();
      product_abt<D, TK>(s, base + L::kQ, kRows, wg * 64,
                         base + L::kK + stage * L::kTile);
      mbar_wait(v_full + 8 * stage, phase);
      product_abt<D, TK>(dp, base + L::kG, kRows, wg * 64,
                         base + L::kV + stage * L::kTile);
      wg_commit();
    };
    auto grad = [&](int i) {   // s <- tile i's dS (times the softcap's slope)
      const int t0 = k_lo + i * TK;
      const int n = min(TK, k_hi - t0);
      auto sc = reinterpret_cast<float(*)[4]>(s);
      auto dpc = reinterpret_cast<float(*)[4]>(dp);
      if (n == TK && flash_mma::all_visible(rw.p_min, rw.p_max, t0,
                                            t0 + TK - 1, causal, window))
        flash_mma::grad_tile<false, TK / 8, true>(sc, dpc, lse2, dl, rw.pos,
                                                  t0, n, scale, softcap,
                                                  causal, window, t4);
      else
        flash_mma::grad_tile<true, TK / 8, true>(sc, dpc, lse2, dl, rw.pos,
                                                 t0, n, scale, softcap,
                                                 causal, window, t4);
    };
    issue_s_dp();
    wg_wait<0>();
    fence_regs<TK / 2>(s);
    fence_regs<TK / 2>(dp);
    if (lane == 0) mbar_arrive(v_empty + 8 * stage);
    grad(0);
    pack_a<TK>(s, ds_prev);
    int k_stage = stage;
    if (++stage == NS) {
      stage = 0;
      phase ^= 1;
    }
    for (int i = 1; i < n_tiles; ++i) {
      issue_s_dp();
      product_ab<D, TK>(acc, ds_prev, base + L::kK + k_stage * L::kTile);
      wg_commit();
      wg_wait<1>();   // S and dP have landed; dQ may still run
      fence_regs<TK / 2>(s);
      fence_regs<TK / 2>(dp);
      if (lane == 0) mbar_arrive(v_empty + 8 * stage);
      grad(i);
      wg_wait<0>();
      fence_regs<D / 2>(acc);
      if (lane == 0) mbar_arrive(k_empty + 8 * k_stage);
      pack_a<TK>(s, ds_prev);
      k_stage = stage;
      if (++stage == NS) {
        stage = 0;
        phase ^= 1;
      }
    }
    wg_fence();
    product_ab<D, TK>(acc, ds_prev, base + L::kK + k_stage * L::kTile);
    wg_commit();
    wg_wait<0>();
    fence_regs<D / 2>(acc);
    if (lane == 0) mbar_arrive(k_empty + 8 * k_stage);

    // dQ through the group's own rows of Q and dO (every product reading
    // them has landed), then those rows go back to the producer
    const float mul[2] = {scale, scale};
    constexpr int NP = kD256 / kPieceCols<T>;   // 8 f32 pieces, 4 bf16
    fence_proxy_async();
#pragma unroll
    for (int p = 0; p < NP; ++p)
      stage_piece<T>(dq_piece(base, wg, p), acc, p, mul, warp, lane);
    bar_sync(1 + wg, 128);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      copy_piece<T>(dq_piece(base, wg, p), dq, p, orow, tid);
    fence_proxy_async();   // the next TMA loads overwrite these rows
    bar_sync(1 + wg, 128);
    if (lane == 0) mbar_arrive(q_empty);
  }
}

// ---------------------------------------------------------------------------
// backward, pass 2: dK and dV
// ---------------------------------------------------------------------------

struct Dkv256Smem {
  static constexpr int kTile = 64 * kD256 * 2;   // K, V, a Q or a dO tile
  static constexpr int kK = 0, kV = kTile;
  static constexpr int kStage = 2 * kTile;       // a Q tile, a dO tile
  static constexpr int kStages0 = 2 * kTile;
  // the stages' log-sum-exp and Delta: 64 + 64 floats a stage
  static constexpr int kLse = kStages0 + kDkv256Stages * kStage;
  static constexpr int kP = kLse + 512 * kDkv256Stages;
  static constexpr int kPBuf = 128 * 32 * 4;     // 128 threads x 32 floats
  static constexpr int kBar = kP + 2 * kPBuf;
  // kv_full, kv_empty, full and empty per stage, p_full and p_empty per
  // P buffer
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kDkv256Stages + 4) + 1024;
};

// query_range for a block of kKeys256 keys at k0.
__device__ __forceinline__ void query_range256(int k0, int sq, int sk,
                                               int causal, int window,
                                               int shift, int* q_lo,
                                               int* q_hi, int* n_tiles) {
  const int k_last = min(k0 + kKeys256, sk) - 1 + shift;
  const long long hi = (long long)k_last + (long long)window;
  *q_lo = causal ? k0 + shift : 0;
  *q_hi = hi < sq ? (int)hi : sq;
  *n_tiles = *q_hi > *q_lo ? (*q_hi - *q_lo + kTq256 - 1) / kTq256 : 0;
}

// Warpgroup 0's half of the dK/dV pass's tile (keys in rows, the tile's
// queries t0 + col in columns, their log-sum-exp in shared memory): s
// holds S^T and leaves with P^T; pc gets P^T times the softcap's slope,
// which warpgroup 1 needs for dS^T.  MASKED as in grad_tile_t.  (Storing
// each float4 of pc as soon as it is formed saves the registers of which
// ptxas spills a few here, but measured 8% slower on an H100.)
template <bool MASKED>
__device__ __forceinline__ void p_tile_t(float* s, float* pc,
                                         const float* lse_t, const int* kp,
                                         const bool* key_ok, int t0, int n,
                                         float scale, float softcap,
                                         int causal, int window, int t4) {
#pragma unroll
  for (int i = 0; i < kTq256 / 2; ++i) {
    const int hh = (i >> 1) & 1;
    const int col = (i >> 2) * 8 + 2 * t4 + (i & 1);
    float cg;
    const float x =
        flash_mma::score_log2_fast(s[i], scale, softcap, &cg);
    float p = exp2f(x - lse_t[col] * flash_mma::kLog2e);
    if (MASKED && !(col < n && key_ok[hh] &&
                    flash_mma::visible(t0 + col, kp[hh], causal, window)))
      p = 0.f;
    s[i] = p;
    pc[i] = p * cg;
  }
}

template <bool KB>
__global__ void __launch_bounds__(kThreads, 1)
dkv256_kernel(const __grid_constant__ CUtensorMap q_map,
              const __grid_constant__ CUtensorMap g_map,
              const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int batch,
              int sq, int sk, int hq, int hkv, float scale, int causal,
              int window, float softcap, int k_off) {
  using L = Dkv256Smem;
  constexpr int D = kD256, TQ = kTq256, NS = kDkv256Stages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t kv_full = base + L::kBar, kv_empty = kv_full + 8;
  const uint32_t full = kv_empty + 8, empty = full + 8 * NS;
  const uint32_t p_full = empty + 8 * NS, p_empty = p_full + 16;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kArrivals);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + 8 * s, 32);   // the producer warp's lanes
      mbar_init(empty + 8 * s, kArrivals);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(p_full + 8 * b, 128);    // warpgroup 0's threads
      mbar_init(p_empty + 8 * b, 128);   // warpgroup 1's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int g_n = hq / hkv, hb = hkv * batch;
  const int n_blk = (sk + kKeys256 - 1) / kKeys256, n_items = n_blk * hb;
  const int shift = KB ? k_off : 0;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one warp.  Lane 0 issues the TMA loads of the tiles;
    // every lane copies its share of the tile's log-sum-exp and Delta (64
    // floats each, zero past Sq), then arrives on the stage's full barrier.
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      prefetch_map(&q_map);
      prefetch_map(&g_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
    }
    int stage = 0;
    uint32_t phase = 0, kv_phase = 0;
    for (int r = 0, it; (it = item_index(r)) < n_items; ++r) {
      // causal: the first key blocks see the most queries
      const Item w = item_at(it, n_blk, hkv, hb, !causal);
      const int k0 = w.blk * kKeys256;
      int q_lo, q_hi, n_qt;
      query_range256(k0, sq, sk, causal, window, shift, &q_lo, &q_hi,
                     &n_qt);
      if (n_qt == 0) continue;   // no query sees these keys: no K/V stage
      if (lane == 0) {
        mbar_wait(kv_empty, kv_phase ^ 1);
        mbar_expect_tx(kv_full, 2 * L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(base + L::kK + c * kKeys256 * 128, &k_map, kv_full,
                      c * 64, w.h, k0, w.b);
          tma_load_4d(base + L::kV + c * kKeys256 * 128, &v_map, kv_full,
                      c * 64, w.h, k0, w.b);
        }
      }
      kv_phase ^= 1;
      for (int j = 0; j < g_n * n_qt; ++j) {
        const int gi = j / n_qt, head = w.h * g_n + gi;
        const int t0 = q_lo + (j - gi * n_qt) * TQ;
        const uint32_t st = base + L::kStages0 + stage * L::kStage;
        const uint32_t bar = full + 8 * stage;
        // this lane's log-sum-exp and Delta, loaded before the wait
        const long long row = ((long long)w.b * hq + head) * sq;
        float lse_r[TQ / 32], delta_r[TQ / 32];
#pragma unroll
        for (int c = 0; c < TQ / 32; ++c) {
          const bool ok = t0 + lane + 32 * c < sq;
          lse_r[c] = ok ? lse[row + t0 + lane + 32 * c] : 0.f;
          delta_r[c] = ok ? delta[row + t0 + lane + 32 * c] : 0.f;
        }
        mbar_wait(empty + 8 * stage, phase ^ 1);
        if (lane == 0) {
          mbar_add_tx(bar, 2 * L::kTile);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(st + c * TQ * 128, &q_map, bar, c * 64, head, t0,
                        w.b);
            tma_load_4d(st + L::kTile + c * TQ * 128, &g_map, bar, c * 64,
                        head, t0, w.b);
          }
        }
        float* lse_s = reinterpret_cast<float*>(
            smem_raw + (base + L::kLse + 512 * stage - smem_u32(smem_raw)));
#pragma unroll
        for (int c = 0; c < TQ / 32; ++c) {
          lse_s[lane + 32 * c] = lse_r[c];
          lse_s[TQ + lane + 32 * c] = delta_r[c];
        }
        mbar_arrive(bar);   // after this lane's stores
        if (++stage == NS) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: both warpgroups hold the CTA's 64 keys; warpgroup 0
  // takes S^T, P^T and dV, warpgroup 1 dP^T, dS^T and dK
  regs_alloc<kConsumerRegs>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int t4 = lane & 3, tid = threadIdx.x & 127;
  const int row0 = warp * 16;   // this warp's first key
  // the A operand of this group's first product: K (S^T) or V (dP^T)
  const uint32_t a_tile = base + (wg == 0 ? L::kK : L::kV);
  int stage = 0, pt = 0;   // pt: P tiles handed over so far
  uint32_t phase = 0, kv_phase = 0;
  for (int r = 0, it; (it = item_index(r)) < n_items; ++r) {
    const Item w = item_at(it, n_blk, hkv, hb, !causal);
    const int k0 = w.blk * kKeys256;
    int q_lo, q_hi, n_qt;
    query_range256(k0, sq, sk, causal, window, shift, &q_lo, &q_hi, &n_qt);
    // kp: the two keys' rows; kpos: their positions, which the masks see
    int kp[2], kpos[2];
    bool key_ok[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      kp[hh] = k0 + row0 + (lane >> 2) + 8 * hh;
      kpos[hh] = kp[hh] + shift;
      key_ok[hh] = kp[hh] < sk;
    }
    const int k_min = k0 + row0 + shift, k_max = k_min + 15;
    const bool warp_keys_ok = k_max - shift < sk;
    float acc[D / 2];   // dV (group 0) or dK (group 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    if (n_qt > 0) {   // else the producer loaded nothing: store zeros
      mbar_wait(kv_full, kv_phase);
      kv_phase ^= 1;
    }
    const int n_tiles = g_n * n_qt;
    for (int j = 0; j < n_tiles; ++j) {
      const int gi = j / n_qt;
      const int t0 = q_lo + (j - gi * n_qt) * TQ;
      const int n = min(TQ, q_hi - t0);
      const uint32_t st = base + L::kStages0 + stage * L::kStage;
      const float* lse_t = reinterpret_cast<const float*>(
          smem_raw + (base + L::kLse + 512 * stage - smem_u32(smem_raw)));
      float s[TQ / 2];
      mbar_wait(full + 8 * stage, phase);
      wg_fence();
      // K Q^T (group 0) or V dO^T (group 1)
      product_abt<D, TQ>(s, a_tile, kKeys256, 0,
                         wg == 0 ? st : st + L::kTile);
      wg_commit();
      wg_wait<0>();
      fence_regs<TQ / 2>(s);
      if (j == n_tiles - 1 && lane == 0) mbar_arrive(kv_empty);

      const int buf = pt & 1;
      const uint32_t pbuf = base + L::kP + buf * L::kPBuf;
      const uint32_t par = (pt >> 1) & 1;
      ++pt;
      if (wg == 0) {   // P^T, and P^T cg into the tile
        float pc[TQ / 2];
        if (n == TQ && warp_keys_ok &&
            flash_mma::all_visible(t0, t0 + TQ - 1, k_min, k_max, causal,
                                   window))
          p_tile_t<false>(s, pc, lse_t, kpos, key_ok, t0, n, scale, softcap,
                          causal, window, t4);
        else
          p_tile_t<true>(s, pc, lse_t, kpos, key_ok, t0, n, scale, softcap,
                         causal, window, t4);
        mbar_wait(p_empty + 8 * buf, par ^ 1);
#pragma unroll
        for (int i4 = 0; i4 < TQ / 8; ++i4)
          st_shared16(pbuf + (i4 * 128 + tid) * 16,
                      make_float4(pc[4 * i4], pc[4 * i4 + 1], pc[4 * i4 + 2],
                                  pc[4 * i4 + 3]));
        mbar_arrive(p_full + 8 * buf);
      } else {         // dS^T = P^T cg (dP^T - Delta)
        mbar_wait(p_full + 8 * buf, par);
#pragma unroll
        for (int i4 = 0; i4 < TQ / 8; ++i4) {
          const uint4 v = ld_shared16(pbuf + (i4 * 128 + tid) * 16);
          const float pc[4] = {__uint_as_float(v.x), __uint_as_float(v.y),
                               __uint_as_float(v.z), __uint_as_float(v.w)};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = i4 * 8 + 2 * t4 + (e & 1);
            s[4 * i4 + e] = pc[e] * (s[4 * i4 + e] - lse_t[TQ + col]);
          }
        }
        mbar_arrive(p_empty + 8 * buf);
      }
      wg_fence();
      // dV += P^T dO (group 0) or dK += dS^T Q (group 1)
      product_pb<D, TQ>(acc, s, wg == 0 ? st + L::kTile : st);
      wg_commit();
      wg_wait<0>();
      fence_regs<D / 2>(acc);
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (++stage == NS) {
        stage = 0;
        phase ^= 1;
      }
    }

    bf16* out = wg == 0 ? dv : dk;
    const float mul = wg == 0 ? 1.f : scale;
    const long long kv_base = (long long)w.b * sk * hkv + w.h;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!key_ok[hh]) continue;
      const long long orow = kv_base + (long long)kp[hh] * hkv;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(out + orow * D + nt * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[4 * nt + 2 * hh] * mul,
                                  acc[4 * nt + 2 * hh + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The two passes; Delta (B, Hq, Sq) f32 is already in `delta`.  KB: the
// keys are a block at k_off, dQ is f32.
template <bool KB>
int launch_bwd256(const void* q, const void* k, const void* v,
                  const void* d_o, const float* lse, const float* delta,
                  void* dq, void* dk, void* dv, int batch, int sq, int sk,
                  int hq, int hkv, float scale, int causal, int window,
                  float softcap, int k_off, cudaStream_t stream) {
  static size_t opted_dq = 48 * 1024, opted_dkv = 48 * 1024;
  const size_t smem_dq = Dq256Smem::kBytes, smem_dkv = Dkv256Smem::kBytes;
  cudaError_t e = allow_smem(dq256_kernel<KB>, smem_dq, &opted_dq);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(dkv256_kernel<KB>, smem_dkv, &opted_dkv);
  if (e != cudaSuccess) return (int)e;
  const int g_n = hq / hkv, bq = kRows / g_n;
  CUtensorMap qm, gm, km, vm;
  if (!map_bshd(&qm, q, batch, sq, hq, kD256, g_n, bq) ||
      !map_bshd(&gm, d_o, batch, sq, hq, kD256, g_n, bq) ||
      !map_bshd(&km, k, batch, sk, hkv, kD256, 1, kTkDq256) ||
      !map_bshd(&vm, v, batch, sk, hkv, kD256, 1, kTkDq256))
    return (int)cudaErrorInvalidValue;
  const long long n_q = (long long)((sq + bq - 1) / bq) * hkv * batch;
  if (n_q == 0) return 0;
  dq256_kernel<KB><<<grid_size(n_q), kThreads, smem_dq, stream>>>(
      qm, gm, km, vm, lse, delta, static_cast<OutT<KB>*>(dq), batch, sq,
      key_limit(sq, sk, causal, k_off), hq, hkv, bq, scale, causal, window,
      softcap, k_off);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap qt, gt, kb, vb;
  if (!map_bshd(&qt, q, batch, sq, hq, kD256, 1, kTq256) ||
      !map_bshd(&gt, d_o, batch, sq, hq, kD256, 1, kTq256) ||
      !map_bshd(&kb, k, batch, sk, hkv, kD256, 1, kKeys256) ||
      !map_bshd(&vb, v, batch, sk, hkv, kD256, 1, kKeys256))
    return (int)cudaErrorInvalidValue;
  const long long n_k =
      (long long)((sk + kKeys256 - 1) / kKeys256) * hkv * batch;
  dkv256_kernel<KB><<<grid_size(n_k), kThreads, smem_dkv, stream>>>(
      qt, gt, kb, vb, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), batch, sq, sk, hq, hkv, scale, causal, window,
      softcap, k_off);
  return (int)cudaGetLastError();
}

}  // namespace flash_wgmma
