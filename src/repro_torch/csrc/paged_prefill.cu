// Paged chunked-prefill attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/attention/attention.py:paged_flash_prefill_pallas
// (body _paged_prefill_kernel): one slot's C-token prompt chunk at global
// positions [start, start + C) against the K/V pages of the slot's block
// row, under the GLOBAL causal mask (which also masks stale pages) with an
// optional sliding window and tanh softcap.
//
// q     (C, Hq, D)              the chunk's queries, in the model's layout
// pages (n_pool, page, Hkv, D)  one layer's K or V pool
// row   (width,) int32          the slot's logical page -> physical page
// out   (C, Hq, D)              in q's type
//
// What bounds it: at the serving shapes (C = 64, Hq = 16, Hkv = 8,
// D = 128) a chunk does about 64 flops per K/V byte it needs, under the
// card's ~295 flop/byte ridge, so on paper the bytes of K/V bound it.  This
// first version runs its products on CUDA cores, not tensor cores, so in
// practice its arithmetic and the latency of its tile loads do.  The
// design:
//  * one CTA per (q block, kv head, key split): the CTA holds the G query
//    heads of its kv head for bq = kRows / G chunk positions, so each K/V
//    tile it loads serves all G * bq rows; key splits of kSplitKeys
//    positions spread a long context over more CTAs, and a second small
//    kernel merges the splits' online-softmax states;
//  * a CTA walks key positions from the window's start for its first row
//    to its last row's position (clamped to the table), never the pages
//    past the chunk, loading each kTk-key tile of K and V into shared
//    memory with 16-byte loads from all its threads at once;
//  * scores go through an f32 online softmax, one warp per kRowsPerWarp
//    rows with the tile's keys across the lanes, so row max and row sum are
//    warp shuffles; the PV product puts head_dim across the lanes.
//
// Masking keeps the TPU kernel's finite NEG_INF (-1e30): a row whose first
// tile lies wholly before its window takes exp(0) weights there, and the
// next tile that holds a valid key scales them by exp(-1e30 - m) = 0.
// Every row reaches a valid key (its own position), and the split merge
// weighs a split that saw none by exp(-1e30 - m) = 0, so the junk never
// survives; -inf would give NaN from exp(-inf - -inf).

#include "paged_common.cuh"

namespace {

using namespace paged;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kTk = 32;                       // key positions per tile
constexpr int kSplitKeys = 128;               // key positions per CTA
constexpr int kMaxDLane = 8;                  // head_dim <= 32 * kMaxDLane

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int* __restrict__ block_row, T* __restrict__ out,
                     float* __restrict__ part_acc,
                     float* __restrict__ part_ml, int c, int hq, int hkv,
                     int d, int page, int width, int n_pool, int start,
                     int bq, float scale, int window, float softcap) {
  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g_n = hq / hkv;
  const int rows = g_n * bq;  // <= kRows; row r = (head g = r / bq,
  const int c0 = qb * bq;     //                   position c0 + r % bq)
  constexpr int kv = Vec<T>::n;
  const int chunks = d / kv;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* off_s = reinterpret_cast<long long*>(smem_raw);  // kTk
  float* q_s = reinterpret_cast<float*>(off_s + kTk);          // kRows * D
  float* k_s = q_s + kRows * d;                                // kTk*(D+1)
  float* v_s = k_s + kTk * (d + 1);                            // kTk * D
  float* p_s = v_s + kTk * d;                                  // kRows*kTk

  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d;
    const int dd = i - r * d;
    const int ci = c0 + r % bq;
    float x = 0.f;
    if (r < rows && ci < c)
      x = to_f32(q[((long long)ci * hq + h * g_n + r / bq) * d + dd]);
    q_s[i] = x;
  }

  // Key positions this CTA needs: [k_lo, k_hi).  64-bit for the window
  // of a global layer (INT32_MAX).
  const int q_lo = start + c0;
  const int q_hi = start + min(c0 + bq, c) - 1;
  const long long k_lo64 = (long long)q_lo - (long long)window + 1;
  const int k_lo = max(k_lo64 > 0 ? (int)k_lo64 : 0, split * kSplitKeys);
  const int k_hi = min(min(q_hi + 1, width * page), (split + 1) * kSplitKeys);

  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][kMaxDLane];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxDLane; ++s) acc[j][s] = 0.f;
  }

  for (int t0 = k_lo; t0 < k_hi; t0 += kTk) {
    const int n = min(kTk, k_hi - t0);
    if (tid < n) {
      const int pos = t0 + tid;
      const int phys = min(max(block_row[pos / page], 0), n_pool - 1);
      off_s[tid] = (((long long)phys * page + pos % page) * hkv + h) * d;
    }
    __syncthreads();
    // K and V tile -> shared memory, 16 bytes per load, all threads; the
    // tail past n is zero so that no lane reads stale data.
    for (int i = tid; i < kTk * chunks; i += kThreads) {
      const int t = i / chunks;
      const int cc = (i - t * chunks) * kv;
      float kb[kv], vb[kv];
      if (t < n) {
        load_n<T, kv>(k_pages + off_s[t] + cc, kb);
        load_n<T, kv>(v_pages + off_s[t] + cc, vb);
      } else {
#pragma unroll
        for (int j = 0; j < kv; ++j) kb[j] = vb[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kv; ++j) {
        k_s[t * (d + 1) + cc + j] = kb[j];
        v_s[t * d + cc + j] = vb[j];
      }
    }
    __syncthreads();

    // Scores of this warp's rows against key position t0 + lane.
    float s[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) s[j] = 0.f;
    const float* qw = q_s + warp * kRowsPerWarp * d;
    for (int dd = 0; dd < d; ++dd) {
      const float kx = k_s[lane * (d + 1) + dd];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) s[j] += qw[j * d + dd] * kx;
    }
    const int k_pos = t0 + lane;
    float alpha[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int r = warp * kRowsPerWarp + j;
      const int q_pos = start + c0 + r % bq;
      float sc = s[j] * scale;
      if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
      const bool valid =
          lane < n && k_pos <= q_pos && (q_pos - k_pos) < window;
      sc = valid ? sc : kNegInf;
      const float m_new = fmaxf(m[j], warp_max(sc));
      const float p = expf(sc - m_new);
      alpha[j] = expf(m[j] - m_new);
      l[j] = l[j] * alpha[j] + warp_sum(p);
      m[j] = m_new;
      p_s[r * kTk + lane] = p;
    }
    __syncwarp();

    // PV: lanes across head_dim, this warp's rows in registers.
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
      for (int s2 = 0; s2 < kMaxDLane; ++s2) acc[j][s2] *= alpha[j];
    const float* pw = p_s + warp * kRowsPerWarp * kTk;
    for (int t = 0; t < n; ++t) {
      float vv[kMaxDLane];
#pragma unroll
      for (int s2 = 0; s2 < kMaxDLane; ++s2) {
        const int dd = lane + 32 * s2;
        vv[s2] = dd < d ? v_s[t * d + dd] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const float pj = pw[j * kTk + t];
#pragma unroll
        for (int s2 = 0; s2 < kMaxDLane; ++s2) acc[j][s2] += pj * vv[s2];
      }
    }
    __syncthreads();
  }

  // Output row of (chunk position ci, q head h * G + g) is ci * Hq + head.
  const long long out_rows = (long long)c * hq;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp * kRowsPerWarp + j;
    const int ci = c0 + r % bq;
    if (r < rows && ci < c) {
      const long long orow = (long long)ci * hq + h * g_n + r / bq;
      if (gridDim.z == 1) {
        const float inv = 1.f / fmaxf(l[j], 1e-30f);
#pragma unroll
        for (int s2 = 0; s2 < kMaxDLane; ++s2) {
          const int dd = lane + 32 * s2;
          if (dd < d) store_val(out + orow * d + dd, acc[j][s2] * inv);
        }
      } else {
        const long long prow = (long long)split * out_rows + orow;
#pragma unroll
        for (int s2 = 0; s2 < kMaxDLane; ++s2) {
          const int dd = lane + 32 * s2;
          if (dd < d) part_acc[prow * d + dd] = acc[j][s2];
        }
        if (lane == 0) {
          part_ml[prow * 2] = m[j];
          part_ml[prow * 2 + 1] = l[j];
        }
      }
    }
  }
}

size_t prefill_smem_bytes(int d) {
  return kTk * sizeof(long long) +
         sizeof(float) * ((size_t)kRows * d + (size_t)kTk * (d + 1) +
                          (size_t)kTk * d + (size_t)kRows * kTk);
}

int prefill_splits(int width, int page) {
  return (width * page + kSplitKeys - 1) / kSplitKeys;
}

template <typename T>
int launch_prefill(const void* q, const void* k_pages, const void* v_pages,
                   const int* block_row, void* out, void* part_acc,
                   void* part_ml, int c, int hq, int hkv, int d, int page,
                   int width, int n_pool, int start, float scale, int window,
                   float softcap, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  const size_t smem = prefill_smem_bytes(d);
  const cudaError_t e = allow_smem(paged_prefill_kernel<T>, smem, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const int bq = kRows / (hq / hkv);
  const int n_split = prefill_splits(width, page);
  const dim3 grid((c + bq - 1) / bq, hkv, n_split);
  paged_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_row, static_cast<T*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), c, hq,
      hkv, d, page, width, n_pool, start, bq, scale, window, softcap);
  if (n_split > 1) {
    const int rows = c * hq;
    combine_kernel<T><<<rows, kThreads, 0, stream>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml), static_cast<T*>(out), rows, d,
        n_split);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Limits and scratch sizes the wrapper reads before it launches.
int paged_prefill_max_g() { return kRows; }
int paged_prefill_max_d() { return 32 * kMaxDLane; }
int paged_prefill_splits(int width, int page) {
  return prefill_splits(width, page);
}

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 means no softcap; a
// window of INT32_MAX means a global layer.  part_acc (n_split, C*Hq, D) and
// part_ml (n_split, C*Hq, 2) are f32 scratch, unused when n_split == 1.
// Returns cudaGetLastError().
int paged_prefill(int dtype, const void* q, const void* k_pages,
                  const void* v_pages, const int* block_row, void* out,
                  void* part_acc, void* part_ml, int c, int hq, int hkv,
                  int d, int page, int width, int n_pool, int start,
                  float scale, int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_prefill<float>(q, k_pages, v_pages, block_row, out,
                                 part_acc, part_ml, c, hq, hkv, d, page,
                                 width, n_pool, start, scale, window,
                                 softcap, s);
  if (dtype == 1)
    return launch_prefill<__nv_bfloat16>(
        q, k_pages, v_pages, block_row, out, part_acc, part_ml, c, hq, hkv,
        d, page, width, n_pool, start, scale, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
