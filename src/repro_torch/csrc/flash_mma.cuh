// Dense flash attention on mma.sync tensor cores: the bf16 forward at
// D 256 (flash_fwd.cu; see its header for the function and the bound),
// plus the softmax, mask and gradient-tile helpers that the wgmma kernels
// of flash_wgmma.cuh (bf16 at D 64 and 128, both directions) reuse, and
// the cp.async helpers of matmul.cu.
//
// Every product is mma.sync m16n8k16 (bf16 operands, f32 accumulation) on
// tiles staged in shared memory as bf16 with a row stride of D + 8
// elements (an odd number of 16-byte units), so ldmatrix reads them
// without bank conflicts.  A warp owns 16 rows of the M side of every
// product; the scores it produces stay in registers, and the softmax
// weights are rounded to bf16 and fed back as the A operand of the next
// product without a trip through shared memory.
//
// fwd_kernel (KB: the keys are one block at positions k_off.., O in f32,
// the log-sum-exp of a row that sees none of them -inf; flash_wgmma.cuh's
// header says how the positions shift): 4 warps x 16 query rows; the
// rows are the G query heads of one kv head at 64 / G positions, so each
// 64-key K/V tile serves all G heads.  Online softmax in registers (a
// row's 16 scores per tile sit in the 4 lanes of a quad), P V into D / 2
// f32 accumulators per thread.
// Tiles stream through two shared-memory buffers with cp.async (16 bytes
// per copy, zero-filled past the ragged end): while the warps run the
// products of one tile, the next tile's copies are in flight.
//
// The accumulator layout of mma.sync m16n8k16 (sc[nt][e]: e 0, 1 at row
// g = lane / 4, e 2, 3 at row g + 8, columns 8 nt + 2 (lane % 4) + e % 2)
// is also that of wgmma's m64nNk16 for each warp's 16 rows, so the helpers
// below serve both kernel families.
#pragma once

#include <type_traits>

#include "paged_common.cuh"

namespace flash_mma {

using namespace paged;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kRows = 64;  // query rows
constexpr int kTk = 64;    // keys per tile

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

template <int D, bool KB>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v,
           std::conditional_t<KB, float, bf16>* __restrict__ o,
           float* __restrict__ lse, int sq, int sk, int hq, int hkv, int bq,
           float scale, int causal, int window, float softcap, int k_off) {
  constexpr int stride = D + 8;
  constexpr int NT = D / 8;
  constexpr int ST = kTk / 8;
  // the last query blocks walk the most keys under the causal mask: start
  // them first, so that the short ones fill the tail of the grid
  const int qb = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g_n = hq / hkv, rows = g_n * bq, c0 = qb * bq;
  const int shift = KB ? k_off : 0;   // pos: a row's position less shift

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kRows * stride;      // 2 buffers of kTk rows
  bf16* v_s = k_s + 2 * kTk * stride;    // 2 buffers of kTk rows
  stage_q_block<D>(q, q_s, b, h, c0, bq, rows, sq, hq, g_n);

  const int g = lane >> 2, t4 = lane & 3;
  int pos[2];
  float m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    pos[hh] = c0 + (warp * 16 + g + 8 * hh) % bq - shift;
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

  const int q_hi = min(c0 + bq, sq) - 1 - shift;
  const long long k_lo64 = (long long)c0 - shift - (long long)window + 1;
  const int k_lo = k_lo64 > 0 ? (int)k_lo64 : 0;
  const int k_hi = causal ? min(q_hi + 1, sk) : sk;
  const long long kv_base = (long long)b * sk * hkv + h;

  const int n_tiles =
      KB && k_hi <= k_lo ? 0 : (k_hi - k_lo + kTk - 1) / kTk;
  auto load_tile = [&](int i) {
    const int t0 = k_lo + i * kTk;
    const int n = min(kTk, k_hi - t0);
    stage<D>(k, k_s + (i & 1) * kTk * stride, kv_base, t0, n, hkv, kTk);
    stage<D>(v, v_s + (i & 1) * kTk * stride, kv_base, t0, n, hkv, kTk);
    cp_async_commit();
  };
  if (!KB || n_tiles > 0) load_tile(0);
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
    const int row_pos = pos[hh] + shift;
    if (r >= rows || row_pos >= sq) continue;
    const int head = h * g_n + r / bq;
    const long long orow = ((long long)b * sq + row_pos) * hq + head;
    const float inv = 1.f / fmaxf(l[hh], 1e-30f);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float a = acc[nt][2 * hh] * inv, c = acc[nt][2 * hh + 1] * inv;
      if constexpr (KB)
        *reinterpret_cast<float2*>(o + orow * D + nt * 8 + 2 * t4) =
            make_float2(a, c);
      else
        *reinterpret_cast<__nv_bfloat162*>(o + orow * D + nt * 8 + 2 * t4) =
            __floats2bfloat162_rn(a, c);
    }
    if (t4 == 0)   // m is in the log2 domain
      lse[((long long)b * hq + head) * sq + row_pos] =
          KB && l[hh] == 0.f ? -INFINITY
                             : (m[hh] + log2f(fmaxf(l[hh], 1e-30f))) * kLn2;
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

template <int D, bool KB>
int launch_fwd_d(const void* q, const void* k, const void* v, void* o,
                 float* lse, int batch, int sq, int sk, int hq, int hkv,
                 float scale, int causal, int window, float softcap,
                 int k_off, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  const size_t smem = fwd_smem_bytes(D);
  const cudaError_t e = allow_smem(fwd_kernel<D, KB>, smem, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const int bq = kRows / (hq / hkv);
  const dim3 grid((sq + bq - 1) / bq, hkv, batch);
  fwd_kernel<D, KB><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v),
      static_cast<std::conditional_t<KB, float, bf16>*>(o), lse, sq, sk, hq,
      hkv, bq, scale, causal, window, softcap, k_off);
  return (int)cudaGetLastError();
}

}  // namespace flash_mma
