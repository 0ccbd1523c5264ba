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
// D = 128, a ~1000-token context) a chunk does about 64 flops per K/V byte
// it needs, under the card's ~295 flop/byte ridge, so the bytes of K/V
// bound it (1.4 us for 4 MB); in practice the latency of a few dependent
// tile loads and two launches does, since each CTA has little work.  The
// design:
//  * one CTA per (q block, kv head, key split): the CTA holds the G query
//    heads of its kv head at bq = rows / G chunk positions, position-major
//    (row r is head r % G at position c0 + r / G, so a warp's 16 rows span
//    few positions and the causal mask leaves its tiles whole), so each
//    K/V tile it loads serves all G * bq rows; key splits of kSplitKeys
//    positions spread a long context over more CTAs (8 kv heads alone
//    would fill 8 of 132 SMs), and a second small kernel merges the
//    splits' online-softmax states;
//  * a CTA walks key positions from the window's start for its first row
//    to its last row's position (clamped to the table), never the pages
//    past the chunk, and never a split past the chunk's end;
//  * bf16 with D in {16, 32, 64, 128, 256} (variant "mma_sync",
//    tc_prefill_kernel): 128 rows per CTA, all G x C rows of a kv head at
//    qwen3-0.6b's chunk (G 2, C 64), so each K/V page is read once per
//    key split (the CUDA-core body's 32 rows read it four times); eight
//    warps of 16 rows; S = Q K^T and O += P V on tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulation) through ldmatrix, the
//    fragment, softmax and mask helpers of flash_mma.cuh; 64-key tiles of
//    K and V gathered page by page with 16-byte cp.async into two
//    buffers, the next tile's copies in flight while the warps multiply;
//    the softmax in the log2 domain, P rounded to bf16 in registers as the
//    A operand of P V.  mma.sync rather than wgmma: a CTA walks two
//    64-key tiles per split at the serving shape, too few for a producer
//    warp and TMA's pipeline to pay for themselves, and page-gathered
//    K/V would need a 4-D map per page.
//  * float32 and other widths (variant "cuda_cores", paged_prefill_kernel):
//    CUDA cores, kRows = 32 rows per CTA (head-major), scores one warp per
//    kRowsPerWarp rows with the tile's keys across the lanes (row max and
//    sum are warp shuffles), the PV product with head_dim across the
//    lanes.
//
// paged_verify is the speculative-verify entry: the W-token windows of all
// B slots in one launch, as jax.vmap of the TPU kernel over the slots runs
// it (slot b's scalar-prefetched start is lengths[b]),
//
// q      (B, W, Hq, D)         slot b's queries at positions lengths[b] + t
// tables (B, width) int32      block-table rows
// lengths(B,) int32            the windows' starts, read on the device
// out    (B, W, Hq, D)
//
// with the slot as a grid axis of both bodies (the chunk of slot b is its
// window).  It takes the shapes paged_decode.cu's cluster family does not
// (attention.paged_flash_verify asks paged_verify_cluster_takes first):
// float32 ("cuda_cores"), bf16 at D 16 or 32, and bf16 windows of more
// than 16 rows (W x G; "mma_sync").  bf16 at D 64, 128 and 256 with W x G
// <= 16, qwen3-0.6b's and gemma2-2b's verify among them, runs
// paged_decode.cu's paged_verify_cluster: one launch of clusters whose
// splits are sized from the device lengths and merged on chip.  Here key
// splits are sized on the host from width x page; a split past a slot's
// last key (lengths[b] + W) walks nothing and leaves the empty state,
// which the merge weighs 0.  The tensor-core body takes four warps a CTA
// where 64 rows cover a slot's G x W rows of one kv head, else eight.
//
// Masking keeps the TPU kernel's finite NEG_INF (-1e30).  In the CUDA-core
// body a row whose first tile lies wholly before its window takes exp(0)
// weights there, and the next tile that holds a valid key scales them by
// exp(-1e30 - m) = 0; in the tensor-core body a masked key weighs 0
// outright.  Every row reaches a valid key (its own position), and the
// split merge weighs a split that saw none by exp(-1e30 - m) = 0, so the
// junk never survives; -inf would give NaN from exp(-inf - -inf).

#include "flash_mma.cuh"

namespace {

using namespace paged;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kTk = 32;                       // key positions per tile
constexpr int kSplitKeys = 128;               // key positions per CTA
constexpr int kMaxDLane = 8;                  // head_dim <= 32 * kMaxDLane

// Grid (q blocks, Hkv, n_split x B): slot b = z / n_split takes row b of
// ``tables`` and starts at starts[b] (or, where starts is null, ``start``).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                     const T* __restrict__ v_pages,
                     const int* __restrict__ tables,
                     const int* __restrict__ starts, T* __restrict__ out,
                     float* __restrict__ part_acc,
                     float* __restrict__ part_ml, int c, int hq, int hkv,
                     int d, int page, int width, int n_pool, int start,
                     int n_split, int bq, float scale, int window,
                     float softcap) {
  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z % n_split;
  const int b = blockIdx.z / n_split;
  const int* block_row = tables + (long long)b * width;
  if (starts != nullptr) start = starts[b];
  q += (long long)b * c * hq * d;
  out += (long long)b * c * hq * d;
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

  // Output row of (chunk position ci, q head h * G + g) is ci * Hq + head;
  // partial rows run over all slots.
  const long long out_rows = (long long)c * hq;
  const long long all_rows = out_rows * (gridDim.z / n_split);
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp * kRowsPerWarp + j;
    const int ci = c0 + r % bq;
    if (r < rows && ci < c) {
      const long long orow = (long long)ci * hq + h * g_n + r / bq;
      if (n_split == 1) {
        const float inv = 1.f / fmaxf(l[j], 1e-30f);
#pragma unroll
        for (int s2 = 0; s2 < kMaxDLane; ++s2) {
          const int dd = lane + 32 * s2;
          if (dd < d) store_val(out + orow * d + dd, acc[j][s2] * inv);
        }
      } else {
        const long long prow = split * all_rows + b * out_rows + orow;
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

// ---------------------------------------------------------------------------
// bf16 on tensor cores (mma.sync)
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 8;    // the prefill's warps of 16 rows a CTA
constexpr int kTcRows = 16 * kTcWarps;   // its query rows per CTA: 128
constexpr int kTcTk = 64;      // keys per tile

inline bool tc_takes(int d) {
  return d == 16 || d == 32 || d == 64 || d == 128 || d == 256;
}

template <int D, int NW>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(16 * NW + 4 * kTcTk) * (D + 8);
}

// Keys t0 .. t0 + n of one kv head, page by page through the block row,
// -> shared memory rows of D + 8; rows past n up to kTcTk are zero.
template <int D, int NW>
__device__ __forceinline__ void stage_keys(
    const __nv_bfloat16* __restrict__ pages, __nv_bfloat16* dst,
    const int* __restrict__ block_row, int t0, int n, int page, int hkv,
    int h, int n_pool) {
  constexpr int chunks = D / 8;
  for (int i = threadIdx.x; i < kTcTk * chunks; i += 32 * NW) {
    const int t = i / chunks;
    const int cc = i - t * chunks;
    const __nv_bfloat16* src = pages;
    if (t < n) {
      const int pos = t0 + t;
      const int phys = min(max(block_row[pos / page], 0), n_pool - 1);
      src = pages + (((long long)phys * page + pos % page) * hkv + h) * D +
            cc * 8;
    }
    flash_mma::cp_async16(dst + t * (D + 8) + cc * 8, src, t < n ? 16 : 0);
  }
}

// NW warps of 16 rows a CTA (the prefill takes 8, verify 4 where 64 rows
// cover its G x W); grid and slots as paged_prefill_kernel's.
template <int D, int NW>
__global__ void __launch_bounds__(32 * NW, 1)
tc_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k_pages,
                  const __nv_bfloat16* __restrict__ v_pages,
                  const int* __restrict__ tables,
                  const int* __restrict__ starts,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int c, int hq, int hkv,
                  int page, int width, int n_pool, int start, int n_split,
                  int bq, float scale, int window, float softcap) {
  using namespace flash_mma;
  constexpr int stride = D + 8;
  constexpr int NT = D / 8;
  constexpr int ST = kTcTk / 8;
  constexpr int kRowsCta = 16 * NW;
  const int qb = blockIdx.x, h = blockIdx.y;
  const int split = blockIdx.z % n_split, b = blockIdx.z / n_split;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g_n = hq / hkv, rows = g_n * bq, c0 = qb * bq;
  const int* block_row = tables + (long long)b * width;
  if (starts != nullptr) start = starts[b];
  q += (long long)b * c * hq * D;
  out += (long long)b * c * hq * D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kRowsCta * stride;    // 2 buffers of kTcTk rows
  bf16* v_s = k_s + 2 * kTcTk * stride;   // 2 buffers of kTcTk rows

  // Q: row r is head h G + r % G at chunk position c0 + r / G
  constexpr int chunks = D / 8;
  for (int i = threadIdx.x; i < kRowsCta * chunks; i += 32 * NW) {
    const int r = i / chunks;
    const int cc = i - r * chunks;
    const int ci = c0 + r / g_n;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (r < rows && ci < c)
      x = *reinterpret_cast<const uint4*>(
          q + ((long long)ci * hq + h * g_n + r % g_n) * D + cc * 8);
    *reinterpret_cast<uint4*>(q_s + r * stride + cc * 8) = x;
  }

  const int g = lane >> 2, t4 = lane & 3;
  int pos[2], row[2];
  float m[2], l[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = warp * 16 + g + 8 * hh;
    pos[hh] = start + c0 + row[hh] / g_n;   // global position
    m[hh] = kNegInf;
    l[hh] = 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // the positions of this warp's 16 rows (rows past the chunk only widen
  // them, which errs toward masking)
  const int p_min = __reduce_min_sync(0xffffffffu, min(pos[0], pos[1]));
  const int p_max = __reduce_max_sync(0xffffffffu, max(pos[0], pos[1]));

  // Key positions this CTA needs: [k_lo, k_hi).  64-bit for the window
  // of a global layer (INT32_MAX).
  const int q_lo = start + c0;
  const int q_hi = start + min(c0 + bq, c) - 1;
  const long long k_lo64 = (long long)q_lo - (long long)window + 1;
  const int k_lo = max(k_lo64 > 0 ? (int)k_lo64 : 0, split * kSplitKeys);
  const int k_hi = min(min(q_hi + 1, width * page), (split + 1) * kSplitKeys);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kTcTk - 1) / kTcTk : 0;

  auto load_tile = [&](int i) {
    const int t0 = k_lo + i * kTcTk;
    const int n = min(kTcTk, k_hi - t0);
    stage_keys<D, NW>(k_pages, k_s + (i & 1) * kTcTk * stride, block_row,
                      t0, n, page, hkv, h, n_pool);
    stage_keys<D, NW>(v_pages, v_s + (i & 1) * kTcTk * stride, block_row,
                      t0, n, page, hkv, h, n_pool);
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0);
  for (int i = 0; i < n_tiles; ++i) {
    const int t0 = k_lo + i * kTcTk;
    const int n = min(kTcTk, k_hi - t0);
    if (i + 1 < n_tiles) {
      load_tile(i + 1);   // into the buffer the last tile's readers left
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();      // tile i (and Q) visible to every warp
    const bf16* kt = k_s + (i & 1) * kTcTk * stride;
    const bf16* vt = v_s + (i & 1) * kTcTk * stride;

    float sc[ST][4];
#pragma unroll
    for (int nt = 0; nt < ST; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
    mma_abt<D, ST / 2>(sc, q_s + warp * 16 * stride, kt, lane);

    float alpha[2], rs[2] = {0.f, 0.f};
    if (n == kTcTk && all_visible(p_min, p_max, t0, t0 + kTcTk - 1, 1,
                                  window))
      online_softmax<false, ST>(sc, m, alpha, rs, pos, t0, n, scale, softcap,
                                1, window, t4);
    else
      online_softmax<true, ST>(sc, m, alpha, rs, pos, t0, n, scale, softcap,
                               1, window, t4);
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
    mma_pb<D, kTcTk / 16>(acc, sc, vt, lane);
    __syncthreads();      // every warp is done with tile i's buffer
  }

  // Output row of (chunk position ci, q head h G + r % G) is ci Hq + head;
  // partial rows run over all slots.
  const long long out_rows = (long long)c * hq;
  const long long all_rows = out_rows * (gridDim.z / n_split);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ci = c0 + row[hh] / g_n;
    if (row[hh] >= rows || ci >= c) continue;
    const long long orow = (long long)ci * hq + h * g_n + row[hh] % g_n;
    if (n_split == 1) {
      const float inv = 1.f / fmaxf(l[hh], 1e-30f);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(out + orow * D + nt * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[nt][2 * hh] * inv,
                                  acc[nt][2 * hh + 1] * inv);
    } else {
      const long long prow = split * all_rows + b * out_rows + orow;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(part_acc + prow * D + nt * 8 + 2 * t4) =
            make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
      if (t4 == 0) {   // m is in the log2 domain; the merge takes natural
        part_ml[prow * 2] = m[hh] * kLn2;
        part_ml[prow * 2 + 1] = l[hh];
      }
    }
  }
}

template <int D, int NW>
int launch_tc(const void* q, const void* k_pages, const void* v_pages,
              const int* tables, const int* starts, void* out, void* part_acc,
              void* part_ml, int batch, int c, int hq, int hkv, int page,
              int width, int n_pool, int start, int n_split, float scale,
              int window, float softcap, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  constexpr size_t smem = tc_smem_bytes<D, NW>();
  const cudaError_t e =
      allow_smem(tc_prefill_kernel<D, NW>, smem, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const int bq = 16 * NW / (hq / hkv);
  const dim3 grid((c + bq - 1) / bq, hkv, n_split * batch);
  using bf = __nv_bfloat16;
  tc_prefill_kernel<D, NW><<<grid, 32 * NW, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k_pages),
      static_cast<const bf*>(v_pages), tables, starts, static_cast<bf*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), c, hq,
      hkv, page, width, n_pool, start, n_split, bq, scale, window, softcap);
  return (int)cudaGetLastError();
}

// The tensor-core launch at D for NW warps a CTA (4 or 8).
template <int NW>
int launch_tc_d(int d, const void* q, const void* k_pages,
                const void* v_pages, const int* tables, const int* starts,
                void* out, void* part_acc, void* part_ml, int batch, int c,
                int hq, int hkv, int page, int width, int n_pool, int start,
                int n_split, float scale, int window, float softcap,
                cudaStream_t s) {
  auto launch = d == 16    ? launch_tc<16, NW>
                : d == 32  ? launch_tc<32, NW>
                : d == 64  ? launch_tc<64, NW>
                : d == 128 ? launch_tc<128, NW>
                           : launch_tc<256, NW>;
  return launch(q, k_pages, v_pages, tables, starts, out, part_acc, part_ml,
                batch, c, hq, hkv, page, width, n_pool, start, n_split, scale,
                window, softcap, s);
}

size_t prefill_smem_bytes(int d) {
  return kTk * sizeof(long long) +
         sizeof(float) * ((size_t)kRows * d + (size_t)kTk * (d + 1) +
                          (size_t)kTk * d + (size_t)kRows * kTk);
}

// Key splits of a chunk at [start, start + C): keys past the chunk's end
// are never visible, so splits past it would only merge zeros.
int prefill_splits(int width, int page, int start, int c) {
  const int keys = min(start + c, width * page);
  return keys > 0 ? (keys + kSplitKeys - 1) / kSplitKeys : 1;
}

// Key splits of a verify launch: its starts are on the device, so the
// splits cover the whole table.
int verify_splits(int width, int page) {
  return prefill_splits(width, page, 0, width * page);
}

// Warps of 16 rows a verify CTA takes on tensor cores: 4, or 8 where 64
// rows do not cover a slot's G x W rows of one kv head.
constexpr int kVerifyWarps = 4;
int verify_warps(int g_n, int w) {
  return 16 * kVerifyWarps < g_n * w ? kTcWarps : kVerifyWarps;
}

template <typename T>
int launch_prefill(const void* q, const void* k_pages, const void* v_pages,
                   const int* tables, const int* starts, void* out,
                   void* part_acc, void* part_ml, int batch, int c, int hq,
                   int hkv, int d, int page, int width, int n_pool, int start,
                   int n_split, float scale, int window, float softcap,
                   cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  const size_t smem = prefill_smem_bytes(d);
  const cudaError_t e = allow_smem(paged_prefill_kernel<T>, smem, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const int bq = kRows / (hq / hkv);
  const dim3 grid((c + bq - 1) / bq, hkv, n_split * batch);
  paged_prefill_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, starts, static_cast<T*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), c, hq,
      hkv, d, page, width, n_pool, start, n_split, bq, scale, window,
      softcap);
  return (int)cudaGetLastError();
}

// Both entries: B slots of C rows (B 1 and a host ``start`` for a prefill
// chunk; the windows' device starts for verify), nw warps a tensor-core CTA,
// then the merge of the splits.
int run(int dtype, const void* q, const void* k_pages, const void* v_pages,
        const int* tables, const int* starts, void* out, void* part_acc,
        void* part_ml, int batch, int c, int hq, int hkv, int d, int page,
        int width, int n_pool, int start, int n_split, int nw, float scale,
        int window, float softcap, cudaStream_t s) {
  int err;
  if (dtype == 1 && tc_takes(d)) {
    auto launch = nw == kVerifyWarps ? launch_tc_d<kVerifyWarps>
                                     : launch_tc_d<kTcWarps>;
    err = launch(d, q, k_pages, v_pages, tables, starts, out, part_acc,
                 part_ml, batch, c, hq, hkv, page, width, n_pool, start,
                 n_split, scale, window, softcap, s);
  } else if (dtype == 0) {
    err = launch_prefill<float>(q, k_pages, v_pages, tables, starts, out,
                                part_acc, part_ml, batch, c, hq, hkv, d, page,
                                width, n_pool, start, n_split, scale, window,
                                softcap, s);
  } else if (dtype == 1) {
    err = launch_prefill<__nv_bfloat16>(
        q, k_pages, v_pages, tables, starts, out, part_acc, part_ml, batch,
        c, hq, hkv, d, page, width, n_pool, start, n_split, scale, window,
        softcap, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err || n_split == 1) return err;
  const int rows = batch * c * hq;
  if (dtype == 0)
    combine_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml), static_cast<float*>(out), rows,
        d, n_split);
  else
    combine_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml),
        static_cast<__nv_bfloat16*>(out), rows, d, n_split);
  return (int)cudaGetLastError();
}

// The variants, numbered as the wrapper's PREFILL_VARIANTS.
enum { kCudaCores = 0, kMmaSync = 1 };

int variant_of(int dtype, int d) {
  return dtype == 1 && tc_takes(d) ? kMmaSync : kCudaCores;
}

}  // namespace

extern "C" {

// Limits and scratch sizes the wrapper reads before it launches.
int paged_prefill_max_g() { return kRows; }
int paged_prefill_max_d() { return 32 * kMaxDLane; }
int paged_prefill_splits(int width, int page, int start, int c) {
  return prefill_splits(width, page, start, c);
}
// The kernel family a launch takes: 0 CUDA cores, 1 mma.sync tensor cores.
int paged_prefill_variant(int dtype, int d) { return variant_of(dtype, d); }

int paged_verify_splits(int width, int page) {
  return verify_splits(width, page);
}

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 means no softcap; a
// window of INT32_MAX means a global layer.  part_acc (n_split, C*Hq, D) and
// part_ml (n_split, C*Hq, 2) are f32 scratch for paged_prefill_splits key
// splits, unused when there is one.  Returns cudaGetLastError().
int paged_prefill(int dtype, const void* q, const void* k_pages,
                  const void* v_pages, const int* block_row, void* out,
                  void* part_acc, void* part_ml, int c, int hq, int hkv,
                  int d, int page, int width, int n_pool, int start,
                  float scale, int window, float softcap, void* stream) {
  return run(dtype, q, k_pages, v_pages, block_row, nullptr, out, part_acc,
             part_ml, 1, c, hq, hkv, d, page, width, n_pool, start,
             prefill_splits(width, page, start, c), kTcWarps, scale, window,
             softcap, static_cast<cudaStream_t>(stream));
}

// The verify entry: q and out (B, W, Hq, D), tables (B, width), lengths
// (B,) the windows' starts; part_acc (n_split, B*W*Hq, D) and part_ml
// (n_split, B*W*Hq, 2) f32 scratch for paged_verify_splits key splits,
// unused when there is one.  Returns cudaGetLastError().
int paged_verify(int dtype, const void* q, const void* k_pages,
                 const void* v_pages, const int* tables, const int* lengths,
                 void* out, void* part_acc, void* part_ml, int batch, int w,
                 int hq, int hkv, int d, int page, int width, int n_pool,
                 float scale, int window, float softcap, void* stream) {
  if (batch * w == 0) return 0;
  return run(dtype, q, k_pages, v_pages, tables, lengths, out, part_acc,
             part_ml, batch, w, hq, hkv, d, page, width, n_pool, 0,
             verify_splits(width, page), verify_warps(hq / hkv, w), scale,
             window, softcap, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
