// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/attention/attention.py:paged_flash_decode_pallas
// (body _paged_decode_kernel): one decode query per slot and query head
// against the paged K/V pool, reached through the slot's block table.
//
// q      (B, Hkv, G, D)          the slot's G grouped query heads per kv head
// pages  (n_pool, page, Hkv, D)  one layer's K or V pool (null page included)
// tables (B, width) int32        logical page -> physical page, per slot
// lengths(B,) int32              valid positions per slot (the new token's
//                                K/V is already written)
// out    (B, Hkv, G, D)          in q's type
//
// What bounds it: the bytes of K/V it reads.  At the serving shapes
// (G = 2, D = 128) attention does 4 flops per K/V byte in bf16, far below
// the card's ~295 flop/byte ridge, so the kernel is a streaming read of the
// slots' live pages and its time is set by how many bytes it keeps in
// flight.  The design:
//  * it reads only the valid key positions [max(0, length - window),
//    min(length, width * page)), each K and V row once (the TPU kernel
//    visits every page of the table and masks);
//  * the grid is (kv head, slot, key split): each CTA takes one
//    kSplitKeys-wide range of key positions, so a batch of 8 slots still
//    puts hundreds of CTAs on the 132 SMs, and a second small kernel
//    merges the splits' online-softmax states (flash-decoding);
//  * the CTA reads its split's page ids into shared memory once; then each
//    of its eight warps streams its own batches of kBatch keys through
//    registers: a lane holds EPL consecutive elements of head_dim for the
//    G grouped queries, issues the batch's K and V loads together (kBatch
//    rows of each in flight per warp), reduces the dot products with warp
//    shuffles and keeps its own f32 online-softmax state.  No global table
//    load and no block barrier sit in the loop; the warps' states merge
//    once at the end.  The softmax weights stay f32 for the PV
//    product (the plain version rounds them to the value type).
// Every position the walk visits is valid, so no masking is needed; a slot
// with no valid position (only a frozen, inactive slot past its table)
// writes zeros.

#include "paged_common.cuh"

namespace {

using namespace paged;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;        // keys per warp step
constexpr int kSplitKeys = 128;  // key positions per CTA
constexpr int kMaxG = 8;         // grouped query heads per kv head
constexpr int kMaxEpl = 8;       // head_dim <= 32 * kMaxEpl

// G_MAX: a compile-time bound on the G grouped queries; EPL: head_dim
// elements per lane.
template <typename T, int G_MAX, int EPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int hkv, int g_n, int d, int page, int width, int n_pool,
                    float scale, int window, float softcap) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int e0 = lane * EPL;  // this lane's head_dim elements [e0, e0+EPL)
  const bool lane_on = e0 < d;

  const long long row0 = ((long long)b * hkv + h) * g_n;  // first q row
  float qr[G_MAX][EPL];
  float acc[G_MAX][EPL];
  float m[G_MAX], l[G_MAX];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = acc[g][e] = 0.f;
    if (g < g_n && lane_on) load_n<T, EPL>(q + (row0 + g) * d + e0, qr[g]);
  }

  // This CTA's valid key positions: [lo, hi).  64-bit so that a global
  // layer's window of INT32_MAX cannot overflow.
  const int length = lengths[b];
  const long long lo64 = (long long)length - (long long)window;
  const int lo = max(lo64 > 0 ? (int)lo64 : 0, split * kSplitKeys);
  const int hi = min(min(length, width * page), (split + 1) * kSplitKeys);

  // The split's page ids, once, into shared memory: the key loop then
  // waits on no global table load.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* phys_s = reinterpret_cast<int*>(smem_raw);  // kSplitKeys + 1
  const int first_page = lo / page;
  if (lo < hi) {
    const int* row = block_tables + (long long)b * width;
    for (int i = threadIdx.x; i <= (hi - 1) / page - first_page;
         i += kThreads)
      phys_s[i] = min(max(row[first_page + i], 0), n_pool - 1);
  }
  __syncthreads();

  for (int t0 = lo + warp * kBatch; t0 < hi; t0 += kWarps * kBatch) {
    // lane j < kBatch finds the row offset of key t0 + j
    long long off = 0;
    if (lane < kBatch && t0 + lane < hi) {
      const int pos = t0 + lane;
      const int phys = phys_s[pos / page - first_page];
      off = (((long long)phys * page + pos % page) * hkv + h) * d;
    }
    float kx[kBatch][EPL], vx[kBatch][EPL];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const long long oj = __shfl_sync(0xffffffffu, off, j);
      if (t0 + j < hi && lane_on) {
        load_n<T, EPL>(k_pages + oj + e0, kx[j]);
        load_n<T, EPL>(v_pages + oj + e0, vx[j]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kx[j][e] = vx[j][e] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g >= g_n) break;
      float s[kBatch];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qr[g][e] * kx[j][e];
        s[j] = warp_sum(part) * scale;
        if (softcap > 0.f) s[j] = tanhf(s[j] / softcap) * softcap;
        if (t0 + j < hi) mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const float p = t0 + j < hi ? expf(s[j] - m_new) : 0.f;
        sum += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += p * vx[j][e];
      }
      l[g] = l[g] * alpha + sum;
      m[g] = m_new;
    }
  }

  // Merge the warps' states: (m, l) per warp and query, then acc.
  float* ml_s = reinterpret_cast<float*>(phys_s + kSplitKeys + 1);
  float* acc_s = ml_s + kWarps * g_n * 2;            // kWarps * G * D
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    if (g >= g_n) break;
    if (lane == 0) {
      ml_s[(warp * g_n + g) * 2] = m[g];
      ml_s[(warp * g_n + g) * 2 + 1] = l[g];
    }
    if (lane_on) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc_s[(warp * g_n + g) * d + e0 + e] = acc[g][e];
    }
  }
  __syncthreads();
  const long long rows = (long long)gridDim.y * hkv * g_n;
  for (int i = threadIdx.x; i < g_n * d; i += kThreads) {
    const int g = i / d;
    const int dd = i - g * d;
    float mm = kNegInf;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, ml_s[(w * g_n + g) * 2]);
    float ll = 0.f, aa = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(ml_s[(w * g_n + g) * 2] - mm);
      ll += ml_s[(w * g_n + g) * 2 + 1] * wt;
      aa += acc_s[(w * g_n + g) * d + dd] * wt;
    }
    if (gridDim.z == 1) {
      store_val(out + (row0 + g) * d + dd, aa / fmaxf(ll, 1e-30f));
    } else {
      const long long prow = (long long)split * rows + row0 + g;
      part_acc[prow * d + dd] = aa;
      if (dd == 0) {
        part_ml[prow * 2] = mm;
        part_ml[prow * 2 + 1] = ll;
      }
    }
  }
}

int decode_splits(int width, int page) {
  return (width * page + kSplitKeys - 1) / kSplitKeys;
}

template <typename T, int G_MAX, int EPL>
int launch_decode(const void* q, const void* k_pages, const void* v_pages,
                  const int* block_tables, const int* lengths, void* out,
                  void* part_acc, void* part_ml, int batch, int hkv, int g_n,
                  int d, int page, int width, int n_pool, float scale,
                  int window, float softcap, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  const size_t smem = sizeof(int) * (kSplitKeys + 1) +
                      sizeof(float) * kWarps * g_n * (2 + (size_t)d);
  const cudaError_t e =
      allow_smem(paged_decode_kernel<T, G_MAX, EPL>, smem, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const int n_split = decode_splits(width, page);
  const dim3 grid(hkv, batch, n_split);
  paged_decode_kernel<T, G_MAX, EPL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_tables, lengths,
      static_cast<T*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), hkv, g_n, d, page, width, n_pool, scale,
      window, softcap);
  if (n_split > 1) {
    const int rows = batch * hkv * g_n;
    combine_kernel<T><<<rows, kThreads, 0, stream>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml), static_cast<T*>(out), rows, d,
        n_split);
  }
  return (int)cudaGetLastError();
}

// Head_dim elements per lane: the fewest of 1, 2, 4, 8 that cover d with
// 32 lanes (the wrapper checks that it divides d).
int lane_elems(int d) {
  int epl = 1;
  while (epl < kMaxEpl && 32 * epl < d) epl *= 2;
  return epl;
}

template <typename T, int G_MAX>
int dispatch_epl(const void* q, const void* k_pages, const void* v_pages,
                 const int* block_tables, const int* lengths, void* out,
                 void* part_acc, void* part_ml, int batch, int hkv, int g_n,
                 int d, int page, int width, int n_pool, float scale,
                 int window, float softcap, cudaStream_t stream) {
#define REPRO_DECODE_EPL(N)                                                 \
  if (lane_elems(d) == N)                                                   \
    return launch_decode<T, G_MAX, N>(q, k_pages, v_pages, block_tables,    \
                                      lengths, out, part_acc, part_ml,      \
                                      batch, hkv, g_n, d, page, width,      \
                                      n_pool, scale, window, softcap, stream);
  REPRO_DECODE_EPL(1)
  REPRO_DECODE_EPL(2)
  REPRO_DECODE_EPL(4)
  REPRO_DECODE_EPL(8)
#undef REPRO_DECODE_EPL
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* q, const void* k_pages, const void* v_pages,
             const int* block_tables, const int* lengths, void* out,
             void* part_acc, void* part_ml, int batch, int hkv, int g_n,
             int d, int page, int width, int n_pool, float scale, int window,
             float softcap, cudaStream_t stream) {
  if (g_n <= 2)
    return dispatch_epl<T, 2>(q, k_pages, v_pages, block_tables, lengths,
                              out, part_acc, part_ml, batch, hkv, g_n, d,
                              page, width, n_pool, scale, window, softcap,
                              stream);
  return dispatch_epl<T, kMaxG>(q, k_pages, v_pages, block_tables, lengths,
                                out, part_acc, part_ml, batch, hkv, g_n, d,
                                page, width, n_pool, scale, window, softcap,
                                stream);
}

}  // namespace

extern "C" {

// Limits and scratch sizes the wrapper reads before it launches.
int paged_decode_max_g() { return kMaxG; }
int paged_decode_max_d() { return 32 * kMaxEpl; }
int paged_decode_splits(int width, int page) {
  return decode_splits(width, page);
}

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 means no softcap; a
// window of INT32_MAX means a global layer.  part_acc (n_split, B*Hq, D) and
// part_ml (n_split, B*Hq, 2) are f32 scratch, unused when n_split == 1.
// Returns cudaGetLastError().
int paged_decode(int dtype, const void* q, const void* k_pages,
                 const void* v_pages, const int* block_tables,
                 const int* lengths, void* out, void* part_acc, void* part_ml,
                 int batch, int hkv, int g_n, int d, int page, int width,
                 int n_pool, float scale, int window, float softcap,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_n < 1 || g_n > kMaxG || d > 32 * kMaxEpl || d % lane_elems(d))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k_pages, v_pages, block_tables, lengths, out,
                           part_acc, part_ml, batch, hkv, g_n, d, page, width,
                           n_pool, scale, window, softcap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k_pages, v_pages, block_tables,
                                   lengths, out, part_acc, part_ml, batch,
                                   hkv, g_n, d, page, width, n_pool, scale,
                                   window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
