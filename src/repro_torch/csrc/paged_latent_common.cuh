// The tile walk shared by the paged MLA latent kernels
// (paged_latent_decode.cu, paged_latent_prefill.cu).
//
// Absorbed MLA attention reads ONE head-free latent key/value per position,
// shared by every query head: key = [c_kv | k_rope] (kv_lora + qk_rope
// features), value = c_kv.  So any set of query rows of one slot (the H
// heads of a decode token, or the C * H (position, head) pairs of a prefill
// chunk) can share each latent tile it loads.  The kernel is written over
// such rows:
//
// q_lat  (B, NR, kv_lora)      NR query rows per batch element
// q_rope (B, NR, qk_rope)
// ckv    (n_pool, page, kv_lora), kr (n_pool, page, qk_rope): one layer's
//                              latent pools (null page included)
// tables (B, width) int32      logical page -> physical page, per element
// out    (B, NR, kv_lora)      in q's type
//
// Row r of element b sees key positions [0, limit(b, r)): decode gives every
// head of slot b the slot's length; prefill gives row r (position r / H of
// the chunk) the global causal limit start + r / H + 1, which also masks
// stale and future page contents; verify gives row r of slot b (position
// r / H of its W-token window) the limit lengths[b] + r / H + 1.  A decode
// slot of length 0 has no valid key: it walks its whole table with every
// key scored 0, the uniform mean of its latents, which the TPU kernel and
// the plain version give by masking every score to the finite -1e30.
//
// What bounds it: the products.  A key costs 2 * (kv_lora + qk_rope) flops
// per row for its score and 2 * kv_lora for the value, against 1152 bytes
// of latent (bf16, full width), shared by H = 128 heads: about 250 flops
// per byte in decode and, in prefill, about 32,000 per byte the chunk
// needs, both near or above the card's ~295 flop/byte ridge.  So bf16 at
// the full-width shapes runs its products on tensor cores
// (latent_mma_kernel, below); float32 and the small shapes run them on
// CUDA cores (latent_kernel), bound by arithmetic and shared-memory
// traffic.  The design of both:
//  * the accumulator does not fit one CTA: 128 heads x 512 latent features
//    in f32 are 256 KB.  A CTA takes kRows = 16 rows, whose accumulators
//    (16 x 512 f32) sit in registers: 32 per thread over 256 threads on
//    CUDA cores, 64 per thread over 128 on tensor cores;
//  * the grid is (row block, batch element, key split).  Prefill at full
//    width has 1,024 row blocks and walks each block's whole causal range;
//    decode has only B * H / 16 blocks, so its key range is split into
//    kSplitKeys-wide pieces over more CTAs and a second small kernel merges
//    the splits' online-softmax states (combine_kernel);
//  * a CTA walks only its valid key range, in tiles of kTk = 32 keys: the
//    tile's latent rows (c_kv and k_rope, reached through the block table)
//    go to shared memory with 16-byte loads from all threads, and the
//    online softmax takes one key per lane, so row max and row sum are
//    warp shuffles;
//  * the f32 online softmax keeps the TPU kernels' finite -1e30 as its
//    initial max, and a masked key gets weight 0 (not exp(0)), so a row
//    with no valid key in a split leaves l = 0 and acc = 0, which the merge
//    and the max(l, 1e-30) guard turn into nothing.
#pragma once

#include "paged_common.cuh"

namespace latent {

using namespace paged;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                     // query rows per CTA
constexpr int kRowsPerWarp = kRows / kWarps;  // 2
constexpr int kTk = 32;                       // keys per tile (one per lane)
constexpr int kSplitKeys = 128;               // keys per split, when split
constexpr int kMaxEpl = 16;                   // kv_lora <= 32 * kMaxEpl
constexpr int kMaxFeat = 1024;                // kv_lora + qk_rope
constexpr int kSms = 132;

// Key splits for a launch of row_blocks * batch CTAs per split: none when
// those already fill the card twice over.
inline int splits(int width, int page, int row_blocks) {
  if (row_blocks >= 2 * kSms) return 1;
  return (width * page + kSplitKeys - 1) / kSplitKeys;
}

inline size_t smem_bytes(int feat) {
  return kTk * sizeof(long long) +
         sizeof(float) * ((size_t)kRows * feat + (size_t)kTk * (feat + 1) +
                          (size_t)kRows * kTk);
}

// On CUDA cores: a warp holds 2 rows, lanes across the latent features;
// the tile is staged as f32 and the softmax weights stay f32 for the value
// product.  CAUSAL = false: limit(b, r) = lengths[b] (decode).  CAUSAL =
// true: limit(b, r) = s + r / n_heads + 1 with s = lengths[b] (verify) or,
// where lengths is null, ``start`` (prefill, B = 1).  EPL: kv_lora
// elements per lane.
template <typename T, bool CAUSAL, int EPL>
__global__ void __launch_bounds__(kThreads)
latent_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
              const T* __restrict__ ckv, const T* __restrict__ kr,
              const int* __restrict__ tables,
              const int* __restrict__ lengths, T* __restrict__ out,
              float* __restrict__ part_acc, float* __restrict__ part_ml,
              int n_rows, int n_heads, int kv, int rope, int page, int width,
              int n_pool, int start, int split_keys, float scale) {
  const int rb = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int feat = kv + rope;
  const int r0 = rb * kRows;  // first row of this block within element b
  const int rows_here = min(kRows, n_rows - r0);
  const long long grow0 = (long long)b * n_rows + r0;  // its global row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* off_s = reinterpret_cast<long long*>(smem_raw);  // kTk
  float* q_s = reinterpret_cast<float*>(off_s + kTk);          // kRows*feat
  float* k_s = q_s + kRows * feat;                   // kTk * (feat + 1)
  float* p_s = k_s + kTk * (feat + 1);               // kRows * kTk

  for (int i = tid; i < kRows * feat; i += kThreads) {
    const int r = i / feat;
    const int dd = i - r * feat;
    float x = 0.f;
    if (r < rows_here)
      x = dd < kv ? to_f32(q_lat[(grow0 + r) * kv + dd])
                  : to_f32(q_rope[(grow0 + r) * rope + dd - kv]);
    q_s[i] = x;
  }

  // Each warp row's key limit, and the block's: [lo, hi) is the key range
  // this CTA walks.
  const bool uniform = !CAUSAL && lengths[b] <= 0;
  const int st = CAUSAL && lengths != nullptr ? lengths[b] : start;
  const int dec = uniform ? width * page : CAUSAL ? 0 : lengths[b];
  int limit[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = r0 + warp * kRowsPerWarp + j;
    limit[j] = CAUSAL ? st + r / n_heads + 1 : dec;
  }
  const int block_limit =
      CAUSAL ? st + (r0 + rows_here - 1) / n_heads + 1 : dec;
  const int lo = split * split_keys;
  const int hi = min(min(block_limit, width * page), lo + split_keys);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][EPL];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[j][e] = 0.f;
  }

  constexpr int vec = Vec<T>::n;
  const int kv_chunks = kv / vec;
  const int chunks = kv_chunks + rope / vec;
  const int* table = tables + (long long)b * width;
  const float* qw = q_s + warp * kRowsPerWarp * feat;

  for (int t0 = lo; t0 < hi; t0 += kTk) {
    const int n = min(kTk, hi - t0);
    if (tid < n) {
      const int pos = t0 + tid;
      const int phys = min(max(table[pos / page], 0), n_pool - 1);
      off_s[tid] = (long long)phys * page + pos % page;  // latent row
    }
    __syncthreads();
    // The tile's latent rows -> shared memory as f32, [c_kv | k_rope] per
    // key; the tail past n is zero so that no lane reads stale data.
    for (int i = tid; i < kTk * chunks; i += kThreads) {
      const int t = i / chunks;
      const int cc = i - t * chunks;
      float x[vec];
      if (t < n) {
        if (cc < kv_chunks)
          load_n<T, vec>(ckv + off_s[t] * kv + cc * vec, x);
        else
          load_n<T, vec>(kr + off_s[t] * rope + (cc - kv_chunks) * vec, x);
      } else {
#pragma unroll
        for (int e = 0; e < vec; ++e) x[e] = 0.f;
      }
      float* dst = k_s + t * (feat + 1) + cc * vec;
#pragma unroll
      for (int e = 0; e < vec; ++e) dst[e] = x[e];
    }
    __syncthreads();

    // Scores of this warp's rows against key t0 + lane (decomposed:
    // q_lat . c_kv + q_rope . k_rope, one pass over the two halves).
    float s[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) s[j] = 0.f;
    const float* krow = k_s + lane * (feat + 1);
    for (int dd = 0; dd < feat; dd += 4) {
      const float k0 = krow[dd], k1 = krow[dd + 1], k2 = krow[dd + 2],
                  k3 = krow[dd + 3];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + j * feat + dd);
        s[j] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
      }
    }
    const int k_pos = t0 + lane;
    float alpha[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const bool valid = lane < n && k_pos < limit[j];
      const float sc = valid ? (uniform ? 0.f : s[j] * scale) : kNegInf;
      const float m_new = fmaxf(m[j], warp_max(sc));
      const float p = valid ? expf(sc - m_new) : 0.f;
      alpha[j] = expf(m[j] - m_new);
      l[j] = l[j] * alpha[j] + warp_sum(p);
      m[j] = m_new;
      p_s[(warp * kRowsPerWarp + j) * kTk + lane] = p;
    }
    __syncwarp();

    // P . c_kv: lanes across the latent features, this warp's rows in
    // registers.
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[j][e] *= alpha[j];
    const float* pw = p_s + warp * kRowsPerWarp * kTk;
    for (int t = 0; t < n; ++t) {
      const float* vrow = k_s + t * (feat + 1);
      float vv[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int dd = lane + 32 * e;
        vv[e] = dd < kv ? vrow[dd] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const float pj = pw[j * kTk + t];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[j][e] += pj * vv[e];
      }
    }
    __syncthreads();
  }

  const long long all_rows = (long long)gridDim.y * n_rows;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp * kRowsPerWarp + j;
    if (r >= rows_here) continue;
    const long long grow = grow0 + r;
    if (gridDim.z == 1) {
      const float inv = 1.f / fmaxf(l[j], 1e-30f);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int dd = lane + 32 * e;
        if (dd < kv) store_val(out + grow * kv + dd, acc[j][e] * inv);
      }
    } else {
      const long long prow = (long long)split * all_rows + grow;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int dd = lane + 32 * e;
        if (dd < kv) part_acc[prow * kv + dd] = acc[j][e];
      }
      if (lane == 0) {
        part_ml[prow * 2] = m[j];
        part_ml[prow * 2 + 1] = l[j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores (mma.sync m16n8k16, f32 accumulation): the same walk
// for the full-width shapes (kv_lora a multiple of 64, kv_lora + qk_rope a
// multiple of 16).  A CTA of 4 warps takes the same 16 query rows as above,
// now one m16 tile.  Per 32-key tile, warp w scores keys [8w, 8w + 8)
// against all 16 rows (S = Q K^T over kv_lora + qk_rope), the 16 x 32 f32
// scores meet in shared memory for the online softmax (one warp per 4
// rows, one key per lane), the weights are rounded to bf16 (as the plain
// version rounds them) and warp w accumulates P V for latent features
// [w * kv / 4, (w + 1) * kv / 4) in registers: 64 f32 per thread at
// kv_lora 512.  Q, the key tile and P sit in shared memory as bf16 with a
// row stride of an odd number of 16-byte units, so ldmatrix reads them
// without bank conflicts.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;

inline size_t mma_smem_bytes(int feat) {
  const int stride = feat + 8;  // bf16 elements per Q / key row
  return kTk * sizeof(long long) +
         sizeof(__nv_bfloat16) * ((size_t)(kRows + kTk) * stride +
                                  (size_t)kRows * (kTk + 8)) +
         sizeof(float) * ((size_t)kRows * kTk + 3 * kRows);
}

// NT: n-tiles of 8 latent features per warp (kv_lora = 32 * NT).
template <bool CAUSAL, int NT>
__global__ void __launch_bounds__(kMmaThreads)
latent_mma_kernel(const __nv_bfloat16* __restrict__ q_lat,
                  const __nv_bfloat16* __restrict__ q_rope,
                  const __nv_bfloat16* __restrict__ ckv,
                  const __nv_bfloat16* __restrict__ kr,
                  const int* __restrict__ tables,
                  const int* __restrict__ lengths,
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int n_rows, int n_heads, int kv, int rope, int page,
                  int width, int n_pool, int start, int split_keys,
                  float scale) {
  using bf16 = __nv_bfloat16;
  const int rb = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int feat = kv + rope;
  const int stride = feat + 8;
  const int r0 = rb * kRows;
  const int rows_here = min(kRows, n_rows - r0);
  const long long grow0 = (long long)b * n_rows + r0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* off_s = reinterpret_cast<long long*>(smem_raw);   // kTk
  bf16* q_s = reinterpret_cast<bf16*>(off_s + kTk);             // kRows
  bf16* k_s = q_s + kRows * stride;                             // kTk
  bf16* p_s = k_s + kTk * stride;                     // kRows x (kTk + 8)
  float* s_s = reinterpret_cast<float*>(p_s + kRows * (kTk + 8));
  float* alpha_s = s_s + kRows * kTk;                           // kRows
  float* ml_s = alpha_s + kRows;                                // kRows x 2

  // Q rows -> shared memory, [q_lat | q_rope], 16 bytes at a time.
  const int kv_chunks = kv / 8;
  const int chunks = feat / 8;
  for (int i = tid; i < kRows * chunks; i += kMmaThreads) {
    const int r = i / chunks;
    const int cc = i - r * chunks;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < rows_here)
      x = cc < kv_chunks
              ? *reinterpret_cast<const uint4*>(q_lat + (grow0 + r) * kv +
                                                cc * 8)
              : *reinterpret_cast<const uint4*>(
                    q_rope + (grow0 + r) * rope + (cc - kv_chunks) * 8);
    *reinterpret_cast<uint4*>(q_s + r * stride + cc * 8) = x;
  }

  // Softmax rows of this warp: 4w .. 4w + 3, their limits and state.
  constexpr int kSoftRows = kRows / kMmaWarps;
  const bool uniform = !CAUSAL && lengths[b] <= 0;
  const int st = CAUSAL && lengths != nullptr ? lengths[b] : start;
  const int dec = uniform ? width * page : CAUSAL ? 0 : lengths[b];
  int limit[kSoftRows];
  float m[kSoftRows], l[kSoftRows];
#pragma unroll
  for (int j = 0; j < kSoftRows; ++j) {
    const int r = r0 + warp * kSoftRows + j;
    limit[j] = CAUSAL ? st + r / n_heads + 1 : dec;
    m[j] = kNegInf;
    l[j] = 0.f;
  }
  const int block_limit =
      CAUSAL ? st + (r0 + rows_here - 1) / n_heads + 1 : dec;
  const int lo = split * split_keys;
  const int hi = min(min(block_limit, width * page), lo + split_keys);

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int* table = tables + (long long)b * width;
  const int g = lane >> 2;   // C fragment rows g and g + 8
  const int t4 = lane & 3;   // C fragment columns 2 * t4, 2 * t4 + 1
  const int f0 = warp * NT * 8;   // this warp's first latent feature

  for (int t0 = lo; t0 < hi; t0 += kTk) {
    const int n = min(kTk, hi - t0);
    if (tid < n) {
      const int pos = t0 + tid;
      const int phys = min(max(table[pos / page], 0), n_pool - 1);
      off_s[tid] = (long long)phys * page + pos % page;
    }
    __syncthreads();
    // Key tile [c_kv | k_rope] -> shared memory; zero rows past n so that
    // the products never meet stale (or non-finite) bits.
    for (int i = tid; i < kTk * chunks; i += kMmaThreads) {
      const int t = i / chunks;
      const int cc = i - t * chunks;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (t < n)
        x = cc < kv_chunks
                ? *reinterpret_cast<const uint4*>(ckv + off_s[t] * kv +
                                                  cc * 8)
                : *reinterpret_cast<const uint4*>(
                      kr + off_s[t] * rope + (cc - kv_chunks) * 8);
      *reinterpret_cast<uint4*>(k_s + t * stride + cc * 8) = x;
    }
    __syncthreads();

    // S = Q K^T for keys [8w, 8w + 8).
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16* qa = q_s + (lane & 15) * stride + (lane >> 4) * 8;
    const bf16* kb = k_s + (warp * 8 + (lane & 7)) * stride +
                     ((lane >> 3) & 1) * 8;
    for (int k0 = 0; k0 < feat; k0 += 16) {
      unsigned a[4], bb[2];
      ldsm_x4(a, qa + k0);
      ldsm_x2(bb, kb + k0);
      mma_bf16(sc, a, bb);
    }
    const int key = warp * 8 + 2 * t4;
    s_s[g * kTk + key] = sc[0];
    s_s[g * kTk + key + 1] = sc[1];
    s_s[(g + 8) * kTk + key] = sc[2];
    s_s[(g + 8) * kTk + key + 1] = sc[3];
    __syncthreads();

    // Online softmax, one warp per 4 rows, one key per lane.
    const int k_pos = t0 + lane;
#pragma unroll
    for (int j = 0; j < kSoftRows; ++j) {
      const int r = warp * kSoftRows + j;
      const bool valid = lane < n && k_pos < limit[j];
      const float x =
          valid ? (uniform ? 0.f : s_s[r * kTk + lane] * scale) : kNegInf;
      const float m_new = fmaxf(m[j], warp_max(x));
      const float p = valid ? expf(x - m_new) : 0.f;
      const float alpha = expf(m[j] - m_new);
      l[j] = l[j] * alpha + warp_sum(p);
      m[j] = m_new;
      p_s[r * (kTk + 8) + lane] = __float2bfloat16(p);
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // O[:, f0 : f0 + 8 NT] = alpha * O + P V.
    const float al0 = alpha_s[g], al1 = alpha_s[g + 8];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= al0;
      acc[nt][1] *= al0;
      acc[nt][2] *= al1;
      acc[nt][3] *= al1;
    }
#pragma unroll
    for (int ks = 0; ks < kTk / 16; ++ks) {
      unsigned a[4];
      ldsm_x4(a, p_s + (lane & 15) * (kTk + 8) + ks * 16 + (lane >> 4) * 8);
      const bf16* vb = k_s + (ks * 16 + (lane & 15)) * stride + f0 +
                       (lane >> 4) * 8;
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        unsigned bb[4];
        ldsm_x4_trans(bb, vb + nt * 8);
        mma_bf16(acc[nt], a, bb);
        mma_bf16(acc[nt + 1], a, bb + 2);
      }
    }
    __syncthreads();
  }

  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kSoftRows; ++j) {
      ml_s[(warp * kSoftRows + j) * 2] = m[j];
      ml_s[(warp * kSoftRows + j) * 2 + 1] = l[j];
    }
  }
  __syncthreads();
  const long long all_rows = (long long)gridDim.y * n_rows;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half;
    if (r >= rows_here) continue;
    const long long grow = grow0 + r;
    if (gridDim.z == 1) {
      const float inv = 1.f / fmaxf(ml_s[r * 2 + 1], 1e-30f);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int f = f0 + nt * 8 + 2 * t4;
        __nv_bfloat162 v;
        v.x = __float2bfloat16(acc[nt][2 * half] * inv);
        v.y = __float2bfloat16(acc[nt][2 * half + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(out + grow * kv + f) = v;
      }
    } else {
      const long long prow = (long long)split * all_rows + grow;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int f = f0 + nt * 8 + 2 * t4;
        part_acc[prow * kv + f] = acc[nt][2 * half];
        part_acc[prow * kv + f + 1] = acc[nt][2 * half + 1];
      }
      if (warp == 0 && t4 == 0) {
        part_ml[prow * 2] = ml_s[r * 2];
        part_ml[prow * 2 + 1] = ml_s[r * 2 + 1];
      }
    }
  }
}

template <bool CAUSAL, int NT>
int launch_mma(const void* q_lat, const void* q_rope, const void* ckv,
               const void* kr, const int* tables, const int* lengths,
               void* out, void* part_acc, void* part_ml, int batch,
               int n_rows, int n_heads, int kv, int rope, int page,
               int width, int n_pool, int start, float scale,
               cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  const size_t smem = mma_smem_bytes(kv + rope);
  const cudaError_t e =
      allow_smem(latent_mma_kernel<CAUSAL, NT>, smem, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const int row_blocks = (n_rows + kRows - 1) / kRows;
  const int n_split = splits(width, page, row_blocks * batch);
  const int split_keys = n_split == 1 ? width * page : kSplitKeys;
  const dim3 grid(row_blocks, batch, n_split);
  using bf16 = __nv_bfloat16;
  latent_mma_kernel<CAUSAL, NT><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q_lat), static_cast<const bf16*>(q_rope),
      static_cast<const bf16*>(ckv), static_cast<const bf16*>(kr), tables,
      lengths, static_cast<bf16*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), n_rows, n_heads, kv, rope, page, width,
      n_pool, start, split_keys, scale);
  if (n_split > 1) {
    const int rows = batch * n_rows;
    combine_kernel<bf16><<<rows, kThreads, 0, stream>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml), static_cast<bf16*>(out), rows,
        kv, n_split);
  }
  return (int)cudaGetLastError();
}

template <typename T, bool CAUSAL, int EPL>
int launch_epl(const void* q_lat, const void* q_rope, const void* ckv,
               const void* kr, const int* tables, const int* lengths,
               void* out, void* part_acc, void* part_ml, int batch,
               int n_rows, int n_heads, int kv, int rope, int page,
               int width, int n_pool, int start, float scale,
               cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  const size_t smem = smem_bytes(kv + rope);
  const cudaError_t e =
      allow_smem(latent_kernel<T, CAUSAL, EPL>, smem, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const int row_blocks = (n_rows + kRows - 1) / kRows;
  const int n_split = splits(width, page, row_blocks * batch);
  const int split_keys = n_split == 1 ? width * page : kSplitKeys;
  const dim3 grid(row_blocks, batch, n_split);
  latent_kernel<T, CAUSAL, EPL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(kr), tables, lengths,
      static_cast<T*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), n_rows, n_heads, kv, rope, page, width,
      n_pool, start, split_keys, scale);
  if (n_split > 1) {
    const int rows = batch * n_rows;
    combine_kernel<T><<<rows, kThreads, 0, stream>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml), static_cast<T*>(out), rows, kv,
        n_split);
  }
  return (int)cudaGetLastError();
}

// kv_lora elements per lane: the fewest of 1, 2, 4, 8, 16 that cover it.
inline int lane_elems(int kv) {
  int epl = 1;
  while (epl < kMaxEpl && 32 * epl < kv) epl *= 2;
  return epl;
}

inline bool shapes_ok(int kv, int rope) {
  return kv > 0 && rope > 0 && kv % 8 == 0 && rope % 8 == 0 &&
         kv <= 32 * kMaxEpl && kv + rope <= kMaxFeat;
}

template <bool CAUSAL>
int launch(int dtype, const void* q_lat, const void* q_rope, const void* ckv,
           const void* kr, const int* tables, const int* lengths, void* out,
           void* part_acc, void* part_ml, int batch, int n_rows, int n_heads,
           int kv, int rope, int page, int width, int n_pool, int start,
           float scale, cudaStream_t stream) {
  if (!shapes_ok(kv, rope)) return (int)cudaErrorInvalidValue;
  // bf16 at widths the tensor-core tiles divide: mma.sync.
  if (dtype == 1 && kv % 64 == 0 && (kv + rope) % 16 == 0) {
#define REPRO_LATENT_MMA(NT)                                                 \
  if (kv == 32 * NT)                                                         \
    return launch_mma<CAUSAL, NT>(q_lat, q_rope, ckv, kr, tables, lengths,   \
                                  out, part_acc, part_ml, batch, n_rows,     \
                                  n_heads, kv, rope, page, width, n_pool,    \
                                  start, scale, stream);
    REPRO_LATENT_MMA(2)
    REPRO_LATENT_MMA(4)
    REPRO_LATENT_MMA(8)
    REPRO_LATENT_MMA(16)
#undef REPRO_LATENT_MMA
  }
#define REPRO_LATENT_EPL(T, N)                                                \
  if (lane_elems(kv) == N)                                                    \
    return launch_epl<T, CAUSAL, N>(q_lat, q_rope, ckv, kr, tables, lengths,  \
                                    out, part_acc, part_ml, batch, n_rows,    \
                                    n_heads, kv, rope, page, width, n_pool,   \
                                    start, scale, stream);
#define REPRO_LATENT_TYPE(T) \
  REPRO_LATENT_EPL(T, 1)     \
  REPRO_LATENT_EPL(T, 2)     \
  REPRO_LATENT_EPL(T, 4)     \
  REPRO_LATENT_EPL(T, 8)     \
  REPRO_LATENT_EPL(T, 16)
  if (dtype == 0) {
    REPRO_LATENT_TYPE(float)
  } else if (dtype == 1) {
    REPRO_LATENT_TYPE(__nv_bfloat16)
  }
#undef REPRO_LATENT_TYPE
#undef REPRO_LATENT_EPL
  return (int)cudaErrorInvalidValue;
}

}  // namespace latent
