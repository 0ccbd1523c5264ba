// Dense flash attention on tensor cores: the bf16 kernels of flash_fwd.cu
// and flash_bwd.cu (see their headers for the function and the bound).
//
// Every product is mma.sync m16n8k16 (bf16 operands, f32 accumulation) on
// tiles staged in shared memory as bf16 with a row stride of D + 8
// elements (an odd number of 16-byte units), so ldmatrix reads them
// without bank conflicts.  A warp owns 16 rows of the M side of every
// product; the scores it produces stay in registers, and the softmax
// weights (or dS) are rounded to bf16 and fed back as the A operand of the
// next product without a trip through shared memory.
//
//  * forward (fwd_kernel, D in {64, 128, 256}): 4 warps x 16 query rows;
//    the rows are the G query heads of one kv head at 64 / G positions, so
//    each 64-key K/V tile serves all G heads.  Online softmax in registers
//    (a row's 16 scores per tile sit in the 4 lanes of a quad), P V into
//    D / 2 f32 accumulators per thread.
//  * dQ (dq_kernel, D in {64, 128}): the forward's rows; per key tile
//    S = Q K^T and dP = dO V^T, dS = P (dP - Delta), dQ += dS K.
//  * dK, dV (dkv_kernel, D in {64, 128}): 4 warps x 16 keys; per (query
//    head, 32-query tile) S^T = K Q^T and dP^T = V dO^T, then
//    dV += P^T dO and dK += dS^T Q, so dK and dV sum over the G heads in
//    registers, without atomics.
//
// Tiles stream through two shared-memory buffers with cp.async (16 bytes
// per copy, zero-filled past the ragged end): while the warps run the
// products of one tile, the next tile's copies are in flight, so a CTA
// pays a tile's load latency once, not once per 16-byte load.
#pragma once

#include "paged_common.cuh"

namespace flash_mma {

using namespace paged;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kRows = 64;  // query rows (forward, dq) or keys (dk, dv)
constexpr int kTk = 64;    // keys per tile (forward, dq)
constexpr int kTq = 32;    // queries per tile (dk, dv)

inline bool takes(int d) { return d == 64 || d == 128 || d == 256; }
inline bool takes_bwd(int d) { return d == 64 || d == 128; }

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// cp.async of 16 bytes (src_bytes 0: zero-fill, src not read) and of 4.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows r0 .. r0 + n of a (.., S, heads, D) tensor at one head (`base` =
// b * S * heads + head) -> shared memory with row stride D + 8; rows past
// n up to n_tile are zero, so the products never meet stale bits.
// The copies are asynchronous: the caller commits and waits.
template <int D>
__device__ __forceinline__ void stage(const bf16* __restrict__ src, bf16* dst,
                                      long long base, int r0, int n,
                                      int heads, int n_tile) {
  constexpr int chunks = D / 8;
  for (int i = threadIdx.x; i < n_tile * chunks; i += blockDim.x) {
    const int t = i / chunks;
    const int c = i - t * chunks;
    const bool ok = t < n;
    const bf16* p =
        ok ? src + (base + (long long)(r0 + t) * heads) * D + c * 8 : src;
    cp_async16(dst + t * (D + 8) + c * 8, p, ok ? 16 : 0);
  }
}

// The G heads x bq positions of a query block -> shared memory: row r is
// head h * G + r / bq at position c0 + r % bq.
template <int D>
__device__ __forceinline__ void stage_q_block(const bf16* __restrict__ src,
                                              bf16* dst, int b, int h,
                                              int c0, int bq, int rows,
                                              int s_len, int hq, int g_n) {
  constexpr int chunks = D / 8;
  for (int i = threadIdx.x; i < kRows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = i - r * chunks;
    const int pos = c0 + r % bq;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < rows && pos < s_len)
      x = *reinterpret_cast<const uint4*>(
          src + (((long long)b * s_len + pos) * hq + h * g_n + r / bq) * D +
          c * 8);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c * 8) = x;
  }
}

// acc[nt] (16 x 8 per n-tile, nt < 2 * NP) += A (16 rows from a_s at row
// stride D + 8) times B^T, B's n-tiles being rows of b_s: S = Q K^T over
// the D features.
template <int D, int NP>
__device__ __forceinline__ void mma_abt(float (*acc)[4], const bf16* a_s,
                                        const bf16* b_s, int lane) {
  constexpr int stride = D + 8;
  const bf16* pa = a_s + (lane & 15) * stride + (lane >> 4) * 8;
  const bf16* pb =
      b_s + ((lane & 7) + ((lane >> 4) << 3)) * stride + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    unsigned a[4];
    ldsm_x4(a, pa + k0);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      unsigned bb[4];
      ldsm_x4(bb, pb + np * 16 * stride + k0);
      mma_bf16(acc[2 * np], a, bb);
      mma_bf16(acc[2 * np + 1], a, bb + 2);
    }
  }
}

// acc[nt] (16 x D) += P B, P the bf16 A operand of KS k-steps of 16 held
// in registers as 16 x 8 f32 tiles p[2 * KS], B (16 KS rows x D) row-major
// in b_s at row stride D + 8.
template <int D, int KS>
__device__ __forceinline__ void mma_pb(float (*acc)[4], float (*p)[4],
                                       const bf16* b_s, int lane) {
  constexpr int stride = D + 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    unsigned a[4];
    a[0] = pack_bf16(p[2 * ks][0], p[2 * ks][1]);
    a[1] = pack_bf16(p[2 * ks][2], p[2 * ks][3]);
    a[2] = pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]);
    a[3] = pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3]);
    const bf16* pb = b_s + (ks * 16 + (lane & 15)) * stride + (lane >> 4) * 8;
#pragma unroll
    for (int nt = 0; nt < D / 8; nt += 2) {
      unsigned bb[4];
      ldsm_x4_trans(bb, pb + nt * 8);
      mma_bf16(acc[nt], a, bb);
      mma_bf16(acc[nt + 1], a, bb + 2);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int causal,
                                        int window) {
  return (!causal || k_pos <= q_pos) && (q_pos - k_pos) < window;
}

// The softmax runs in the log2 domain: exp(x - m) = exp2(x log2e - m log2e),
// and the score's scale folds into the same multiply, so a weight costs one
// FFMA and one MUFU.EX2.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The capped, scaled score times log2(e); *cap_grad gets d(capped)/d(scaled).
__device__ __forceinline__ float score_log2(float raw, float scale,
                                            float softcap, float* cap_grad) {
  if (softcap > 0.f) {
    const float t = tanhf(raw * scale / softcap);
    *cap_grad = 1.f - t * t;
    return t * (softcap * kLog2e);
  }
  *cap_grad = 1.f;
  return raw * (scale * kLog2e);
}

// True when every pair of queries [q_min, q_max] and keys [k_min, k_max]
// is visible: such a tile needs no per-element mask.  (Rows past the
// sequence only widen the ranges, which errs toward masking.)
__device__ __forceinline__ bool all_visible(int q_min, int q_max, int k_min,
                                            int k_max, int causal,
                                            int window) {
  return (!causal || k_max <= q_min) && (q_max - k_min) < window;
}

// One tile of the forward's online softmax for a thread's two rows (g and
// g + 8 of its warp's 16): sc holds the raw products Q K^T and leaves with
// the unnormalized weights exp2(x - m); m (log2 domain) and the row sums'
// rescale alpha are updated, rs gets this tile's partial row sums.  MASKED
// applies the ragged, causal and window masks element by element (a masked
// key weighs 0); a tile whose pairs are all visible skips them.
template <bool MASKED, int ST>
__device__ __forceinline__ void online_softmax(
    float (*sc)[4], float* m, float* alpha, float* rs, const int* pos,
    int t0, int n, float scale, float softcap, int causal, int window,
    int t4) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < ST; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      float cg;
      float x = score_log2(sc[nt][e], scale, softcap, &cg);
      if (MASKED) {
        const int key = nt * 8 + 2 * t4 + (e & 1);
        if (!(key < n && visible(pos[hh], t0 + key, causal, window)))
          x = kNegInf;
      }
      sc[nt][e] = x;
      mx[hh] = fmaxf(mx[hh], x);
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = quad_max(mx[hh]);
    alpha[hh] = exp2f(m[hh] - mx[hh]);
    m[hh] = mx[hh];
  }
#pragma unroll
  for (int nt = 0; nt < ST; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      float p = exp2f(sc[nt][e] - m[hh]);
      if (MASKED && sc[nt][e] <= kNegInf) p = 0.f;
      sc[nt][e] = p;
      rs[hh] += p;
    }
}

inline size_t fwd_smem_bytes(int d) {
  return sizeof(bf16) * (size_t)(kRows + 4 * kTk) * (d + 8);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int s_len, int hq, int hkv, int bq,
           float scale, int causal, int window, float softcap) {
  constexpr int stride = D + 8;
  constexpr int NT = D / 8;
  constexpr int ST = kTk / 8;
  // the last query blocks walk the most keys under the causal mask: start
  // them first, so that the short ones fill the tail of the grid
  const int qb = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g_n = hq / hkv, rows = g_n * bq, c0 = qb * bq;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kRows * stride;      // 2 buffers of kTk rows
  bf16* v_s = k_s + 2 * kTk * stride;    // 2 buffers of kTk rows
  stage_q_block<D>(q, q_s, b, h, c0, bq, rows, s_len, hq, g_n);

  const int g = lane >> 2, t4 = lane & 3;
  int pos[2];
  float m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    pos[hh] = c0 + (warp * 16 + g + 8 * hh) % bq;
    m[hh] = kNegInf;
    l[hh] = 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // the positions of this warp's 16 rows
  const int p_min = __reduce_min_sync(0xffffffffu, min(pos[0], pos[1]));
  const int p_max = __reduce_max_sync(0xffffffffu, max(pos[0], pos[1]));

  const int q_hi = min(c0 + bq, s_len) - 1;
  const long long k_lo64 = (long long)c0 - (long long)window + 1;
  const int k_lo = k_lo64 > 0 ? (int)k_lo64 : 0;
  const int k_hi = causal ? q_hi + 1 : s_len;
  const long long kv_base = (long long)b * s_len * hkv + h;

  const int n_tiles = (k_hi - k_lo + kTk - 1) / kTk;
  auto load_tile = [&](int i) {
    const int t0 = k_lo + i * kTk;
    const int n = min(kTk, k_hi - t0);
    stage<D>(k, k_s + (i & 1) * kTk * stride, kv_base, t0, n, hkv, kTk);
    stage<D>(v, v_s + (i & 1) * kTk * stride, kv_base, t0, n, hkv, kTk);
    cp_async_commit();
  };
  load_tile(0);
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = k_lo + i * kTk;
    const int n = min(kTk, k_hi - t0);
    if (i + 1 < n_tiles) {
      load_tile(i + 1);   // into the buffer the last tile's readers left
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();      // tile i (and Q) visible to every warp
    const bf16* kt = k_s + (i & 1) * kTk * stride;
    const bf16* vt = v_s + (i & 1) * kTk * stride;

    float sc[ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    mma_abt<D, ST / 2>(sc, q_s + warp * 16 * stride, kt, lane);

    float alpha[2], rs[2] = {0.f, 0.f};
    if (n == kTk && all_visible(p_min, p_max, t0, t0 + kTk - 1, causal,
                                window))
      online_softmax<false, ST>(sc, m, alpha, rs, pos, t0, n, scale, softcap,
                                causal, window, t4);
    else
      online_softmax<true, ST>(sc, m, alpha, rs, pos, t0, n, scale, softcap,
                               causal, window, t4);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      l[hh] = l[hh] * alpha[hh] + quad_sum(rs[hh]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    mma_pb<D, kTk / 16>(acc, sc, vt, lane);
    __syncthreads();      // every warp is done with tile i's buffer
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    if (r >= rows || pos[hh] >= s_len) continue;
    const int head = h * g_n + r / bq;
    const long long orow = ((long long)b * s_len + pos[hh]) * hq + head;
    const float inv = 1.f / fmaxf(l[hh], 1e-30f);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(o + orow * D + nt * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[nt][2 * hh] * inv,
                                acc[nt][2 * hh + 1] * inv);
    if (t4 == 0)   // m is in the log2 domain
      lse[((long long)b * hq + head) * s_len + pos[hh]] =
          (m[hh] + log2f(fmaxf(l[hh], 1e-30f))) * kLn2;
  }
}

// One key tile of the dQ pass for a thread's two rows: from the raw
// products sc = Q K^T and dp = dO V^T, sc leaves with dS = P (dP - Delta),
// times the softcap's derivative; P = exp2(x - lse2) from the forward's
// log-sum-exp (lse2 in the log2 domain).  MASKED as in online_softmax.
template <bool MASKED, int ST>
__device__ __forceinline__ void grad_tile(
    float (*sc)[4], float (*dp)[4], const float* lse2,
    const float* delta, const int* pos, int t0, int n, float scale,
    float softcap, int causal, int window, int t4) {
#pragma unroll
  for (int nt = 0; nt < ST; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      float cg;
      const float x = score_log2(sc[nt][e], scale, softcap, &cg);
      float p = exp2f(x - lse2[hh]);
      if (MASKED) {
        const int key = nt * 8 + 2 * t4 + (e & 1);
        if (!(key < n && visible(pos[hh], t0 + key, causal, window))) p = 0.f;
      }
      sc[nt][e] = p * (dp[nt][e] - delta[hh]) * cg;
    }
}

// The dK/dV pass's tile, transposed: rows are this thread's two keys kp,
// columns the tile's queries t0 + col with their log-sum-exp and Delta in
// shared memory.  st leaves with P^T, dpt with dS^T.
template <bool MASKED, int ST>
__device__ __forceinline__ void grad_tile_t(
    float (*st)[4], float (*dpt)[4], const float* lse_t,
    const float* delta_t, const int* kp, const bool* key_ok, int t0, int n,
    float scale, float softcap, int causal, int window, int t4) {
#pragma unroll
  for (int nt = 0; nt < ST; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hh = e >> 1;
      const int col = nt * 8 + 2 * t4 + (e & 1);
      float cg;
      const float x = score_log2(st[nt][e], scale, softcap, &cg);
      float p = exp2f(x - lse_t[col] * kLog2e);
      if (MASKED && !(col < n && key_ok[hh] &&
                      visible(t0 + col, kp[hh], causal, window)))
        p = 0.f;
      st[nt][e] = p;                                       // P^T
      dpt[nt][e] = p * (dpt[nt][e] - delta_t[col]) * cg;   // dS^T
    }
}

inline size_t dq_smem_bytes(int d) {
  return sizeof(bf16) * (size_t)(2 * kRows + 4 * kTk) * (d + 8);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ d_o,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int s_len, int hq, int hkv, int bq,
          float scale, int causal, int window, float softcap) {
  constexpr int stride = D + 8;
  constexpr int NT = D / 8;
  constexpr int ST = kTk / 8;
  // the last query blocks walk the most keys under the causal mask: start
  // them first, so that the short ones fill the tail of the grid
  const int qb = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g_n = hq / hkv, rows = g_n * bq, c0 = qb * bq;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* g_s = q_s + kRows * stride;
  bf16* k_s = g_s + kRows * stride;      // 2 buffers of kTk rows
  bf16* v_s = k_s + 2 * kTk * stride;    // 2 buffers of kTk rows
  stage_q_block<D>(q, q_s, b, h, c0, bq, rows, s_len, hq, g_n);
  stage_q_block<D>(d_o, g_s, b, h, c0, bq, rows, s_len, hq, g_n);

  const int g = lane >> 2, t4 = lane & 3;
  int pos[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    pos[hh] = c0 + r % bq;
    const bool live = r < rows && pos[hh] < s_len;
    const long long li =
        ((long long)b * hq + h * g_n + r / bq) * s_len + pos[hh];
    lse_r[hh] = live ? lse[li] * kLog2e : 0.f;   // log2 domain
    delta_r[hh] = live ? delta[li] : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const int p_min = __reduce_min_sync(0xffffffffu, min(pos[0], pos[1]));
  const int p_max = __reduce_max_sync(0xffffffffu, max(pos[0], pos[1]));

  const int q_hi = min(c0 + bq, s_len) - 1;
  const long long k_lo64 = (long long)c0 - (long long)window + 1;
  const int k_lo = k_lo64 > 0 ? (int)k_lo64 : 0;
  const int k_hi = causal ? q_hi + 1 : s_len;
  const long long kv_base = (long long)b * s_len * hkv + h;

  const int n_tiles = (k_hi - k_lo + kTk - 1) / kTk;
  auto load_tile = [&](int i) {
    const int t0 = k_lo + i * kTk;
    const int n = min(kTk, k_hi - t0);
    stage<D>(k, k_s + (i & 1) * kTk * stride, kv_base, t0, n, hkv, kTk);
    stage<D>(v, v_s + (i & 1) * kTk * stride, kv_base, t0, n, hkv, kTk);
    cp_async_commit();
  };
  load_tile(0);
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = k_lo + i * kTk;
    const int n = min(kTk, k_hi - t0);
    if (i + 1 < n_tiles) {
      load_tile(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = k_s + (i & 1) * kTk * stride;
    const bf16* vt = v_s + (i & 1) * kTk * stride;

    float sc[ST][4], dp[ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
    mma_abt<D, ST / 2>(sc, q_s + warp * 16 * stride, kt, lane);
    mma_abt<D, ST / 2>(dp, g_s + warp * 16 * stride, vt, lane);
    if (n == kTk && all_visible(p_min, p_max, t0, t0 + kTk - 1, causal,
                                window))
      grad_tile<false, ST>(sc, dp, lse_r, delta_r, pos, t0, n, scale,
                           softcap, causal, window, t4);
    else
      grad_tile<true, ST>(sc, dp, lse_r, delta_r, pos, t0, n, scale, softcap,
                          causal, window, t4);
    mma_pb<D, kTk / 16>(acc, sc, kt, lane);
    __syncthreads();
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    if (r >= rows || pos[hh] >= s_len) continue;
    const long long orow =
        ((long long)b * s_len + pos[hh]) * hq + h * g_n + r / bq;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dq + orow * D + nt * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[nt][2 * hh] * scale,
                                acc[nt][2 * hh + 1] * scale);
  }
}

inline size_t dkv_smem_bytes(int d) {
  return sizeof(bf16) * (size_t)(2 * kRows + 4 * kTq) * (d + 8) +
         sizeof(float) * 4 * kTq;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ d_o,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int s_len, int hq,
           int hkv, float scale, int causal, int window, float softcap) {
  constexpr int stride = D + 8;
  constexpr int NT = D / 8;
  constexpr int ST = kTq / 8;
  const int kb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g_n = hq / hkv;
  const int k0 = kb * kRows;
  const int n_keys = min(kRows, s_len - k0);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kRows * stride;
  bf16* q_s = v_s + kRows * stride;                  // 2 buffers of kTq
  bf16* g_s = q_s + 2 * kTq * stride;                // 2 buffers of kTq
  float* lse_s = reinterpret_cast<float*>(g_s + 2 * kTq * stride);
  float* delta_s = lse_s + 2 * kTq;

  const long long kv_base = (long long)b * s_len * hkv + h;
  stage<D>(k, k_s, kv_base, k0, n_keys, hkv, kRows);
  stage<D>(v, v_s, kv_base, k0, n_keys, hkv, kRows);
  cp_async_commit();

  const int g = lane >> 2, t4 = lane & 3;
  int kp[2];
  bool key_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = warp * 16 + g + 8 * hh;
    kp[hh] = k0 + key;
    key_ok[hh] = key < n_keys;
  }
  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;

  // the key positions of this warp's 16 keys (all valid, or masked)
  const int k_min = k0 + warp * 16, k_max = k_min + 15;
  const bool warp_keys_ok = k_max < k0 + n_keys;
  const int k_last = k0 + n_keys - 1;
  const int q_lo = causal ? k0 : 0;
  const long long q_hi64 = (long long)k_last + (long long)window;
  const int q_hi = q_hi64 < s_len ? (int)q_hi64 : s_len;

  // Tile j: query head h * G + j / n_qt, queries from q_lo + (j % n_qt) kTq.
  const int n_qt = (q_hi - q_lo + kTq - 1) / kTq;
  const int n_tiles = g_n * n_qt;
  auto load_tile = [&](int j) {
    const int gi = j / n_qt;
    const int t0 = q_lo + (j - gi * n_qt) * kTq;
    const int n = min(kTq, q_hi - t0);
    const int head = h * g_n + gi;
    const int bo = (j & 1) * kTq;
    const long long q_base = (long long)b * s_len * hq + head;
    stage<D>(q, q_s + bo * stride, q_base, t0, n, hq, kTq);
    stage<D>(d_o, g_s + bo * stride, q_base, t0, n, hq, kTq);
    if (tid < kTq) {
      const bool ok = tid < n;
      const long long li = ((long long)b * hq + head) * s_len + t0 + tid;
      cp_async4(lse_s + bo + tid, ok ? lse + li : lse, ok ? 4 : 0);
      cp_async4(delta_s + bo + tid, ok ? delta + li : delta, ok ? 4 : 0);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0);
  for (int j = 0; j < n_tiles; ++j) {
    const int gi = j / n_qt;
    const int t0 = q_lo + (j - gi * n_qt) * kTq;
    const int n = min(kTq, q_hi - t0);
    const int bo = (j & 1) * kTq;
    if (j + 1 < n_tiles) {
      load_tile(j + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();    // K, V and tile j visible to every warp
    const bf16* qt = q_s + bo * stride;
    const bf16* gt = g_s + bo * stride;
    const float* lse_t = lse_s + bo;
    const float* delta_t = delta_s + bo;

    float st[ST][4], dpt[ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    mma_abt<D, ST / 2>(st, k_s + warp * 16 * stride, qt, lane);
    mma_abt<D, ST / 2>(dpt, v_s + warp * 16 * stride, gt, lane);
    if (n == kTq && warp_keys_ok &&
        all_visible(t0, t0 + kTq - 1, k_min, k_max, causal, window))
      grad_tile_t<false, ST>(st, dpt, lse_t, delta_t, kp, key_ok, t0, n,
                             scale, softcap, causal, window, t4);
    else
      grad_tile_t<true, ST>(st, dpt, lse_t, delta_t, kp, key_ok, t0, n,
                            scale, softcap, causal, window, t4);
    mma_pb<D, kTq / 16>(dv_acc, st, gt, lane);
    mma_pb<D, kTq / 16>(dk_acc, dpt, qt, lane);
    __syncthreads();    // every warp is done with tile j's buffer
  }
  if (n_tiles == 0) cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!key_ok[hh]) continue;
    const long long orow = kv_base + (long long)kp[hh] * hkv;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * t4;
      *reinterpret_cast<__nv_bfloat162*>(dk + orow * D + col) =
          __floats2bfloat162_rn(dk_acc[nt][2 * hh] * scale,
                                dk_acc[nt][2 * hh + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + orow * D + col) =
          __floats2bfloat162_rn(dv_acc[nt][2 * hh], dv_acc[nt][2 * hh + 1]);
    }
  }
}

template <int D>
int launch_fwd_d(const void* q, const void* k, const void* v, void* o,
                 float* lse, int batch, int s_len, int hq, int hkv,
                 float scale, int causal, int window, float softcap,
                 cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  const size_t smem = fwd_smem_bytes(D);
  const cudaError_t e = allow_smem(fwd_kernel<D>, smem, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const int bq = kRows / (hq / hkv);
  const dim3 grid((s_len + bq - 1) / bq, hkv, batch);
  fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, s_len, hq,
      hkv, bq, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

inline int launch_fwd(const void* q, const void* k, const void* v, void* o,
                      float* lse, int batch, int s_len, int hq, int hkv,
                      int d, float scale, int causal, int window,
                      float softcap, cudaStream_t stream) {
  if (d == 64)
    return launch_fwd_d<64>(q, k, v, o, lse, batch, s_len, hq, hkv, scale,
                            causal, window, softcap, stream);
  if (d == 128)
    return launch_fwd_d<128>(q, k, v, o, lse, batch, s_len, hq, hkv, scale,
                             causal, window, softcap, stream);
  if (d == 256)
    return launch_fwd_d<256>(q, k, v, o, lse, batch, s_len, hq, hkv, scale,
                             causal, window, softcap, stream);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int launch_bwd_d(const void* q, const void* k, const void* v,
                 const void* d_o, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, int batch, int s_len, int hq,
                 int hkv, float scale, int causal, int window, float softcap,
                 cudaStream_t stream) {
  static size_t opted_dq = 48 * 1024, opted_dkv = 48 * 1024;
  const size_t smem_dq = dq_smem_bytes(D), smem_dkv = dkv_smem_bytes(D);
  cudaError_t e = allow_smem(dq_kernel<D>, smem_dq, &opted_dq);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(dkv_kernel<D>, smem_dkv, &opted_dkv);
  if (e != cudaSuccess) return (int)e;
  const int bq = kRows / (hq / hkv);
  const dim3 grid_q((s_len + bq - 1) / bq, hkv, batch);
  dq_kernel<D><<<grid_q, kThreads, smem_dq, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(d_o), lse, delta,
      static_cast<bf16*>(dq), s_len, hq, hkv, bq, scale, causal, window,
      softcap);
  const dim3 grid_k((s_len + kRows - 1) / kRows, hkv, batch);
  dkv_kernel<D><<<grid_k, kThreads, smem_dkv, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(d_o), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), s_len, hq, hkv, scale,
      causal, window, softcap);
  return (int)cudaGetLastError();
}

inline int launch_bwd(const void* q, const void* k, const void* v,
                      const void* d_o, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, int batch, int s_len,
                      int hq, int hkv, int d, float scale, int causal,
                      int window, float softcap, cudaStream_t stream) {
  if (d == 64)
    return launch_bwd_d<64>(q, k, v, d_o, lse, delta, dq, dk, dv, batch,
                            s_len, hq, hkv, scale, causal, window, softcap,
                            stream);
  if (d == 128)
    return launch_bwd_d<128>(q, k, v, d_o, lse, delta, dq, dk, dv, batch,
                             s_len, hq, hkv, scale, causal, window, softcap,
                             stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash_mma
