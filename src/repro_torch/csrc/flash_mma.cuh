// mma.sync helpers of the attention kernels: the m16n8k16 products over
// tiles staged in shared memory as bf16 with a row stride of D + 8
// elements (an odd number of 16-byte units, so ldmatrix reads them without
// bank conflicts) that paged_prefill.cu runs, the softmax, mask and
// gradient-tile helpers that the wgmma kernels of flash_wgmma.cuh and
// flash_wgmma256.cuh (bf16 at D 64, 112, 128 and 256, both directions),
// paged_decode.cu and the latent kernels reuse, and the cp.async helpers
// of matmul.cu.  (The dense forward at D 256 that ran here on mma.sync
// now runs on wgmma: flash_wgmma256.cuh.)
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

// As score_log2, with the tanh from one exp2 and one fast division,
// tanh(y) = 1 - 2 / (1 + e^(2y)): MUFU.EX2 and MUFU.RCP in place of tanhf
// and an IEEE division, which at gemma2-2b's cap up to doubled the
// D-256 kernels' time (flash_wgmma256.cuh).  Within 1e-6 of tanh (near
// y = 0, the rounding of 1 - 1).
__device__ __forceinline__ float score_log2_fast(float raw, float scale,
                                                 float softcap,
                                                 float* cap_grad) {
  if (softcap > 0.f) {
    const float e = exp2f(raw * ((2.f * kLog2e) * (scale / softcap)));
    const float t = 1.f - __fdividef(2.f, 1.f + e);
    *cap_grad = 1.f - t * t;
    return t * (softcap * kLog2e);
  }
  *cap_grad = 1.f;
  return raw * (scale * kLog2e);
}

// score_log2, or with FAST score_log2_fast.
template <bool FAST>
__device__ __forceinline__ float score(float raw, float scale, float softcap,
                                       float* cap_grad) {
  if constexpr (FAST)
    return score_log2_fast(raw, scale, softcap, cap_grad);
  else
    return score_log2(raw, scale, softcap, cap_grad);
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
// key weighs 0); a tile whose pairs are all visible skips them.  FAST: the
// softcap's tanh by score_log2_fast.
template <bool MASKED, int ST, bool FAST = false>
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
      float x = score<FAST>(sc[nt][e], scale, softcap, &cg);
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

// One key tile of the dQ pass for a thread's two rows: from the raw
// products sc = Q K^T and dp = dO V^T, sc leaves with dS = P (dP - Delta),
// times the softcap's derivative; P = exp2(x - lse2) from the forward's
// log-sum-exp (lse2 in the log2 domain).  MASKED and FAST as in
// online_softmax.
template <bool MASKED, int ST, bool FAST = false>
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
      const float x = score<FAST>(sc[nt][e], scale, softcap, &cg);
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

}  // namespace flash_mma
