// Dense flash attention, backward, for Hopper (sm_90a).
//
// The gradient of src/repro/kernels/attention/attention.py:
// flash_attention_pallas (the function flash_fwd.cu computes).  The JAX
// package has no backward kernel: XLA differentiates its jnp attention.
// This is the port's own gradient of the same function, in the usual
// recompute scheme from the forward's saved row log-sum-exp:
//
//   Delta_i = rowsum(dO_i * O_i)
//   P       = exp(S - LSE)              S the scaled (and capped) scores
//   dV      = P^T dO,   dP = dO V^T,    dS = P * (dP - Delta)
//   softcap: dS_raw = dS * (1 - (S / cap)^2)
//   dQ      = scale * dS K,             dK = scale * dS^T Q
//
// q, o, do (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D) in the model's layout
// (Sq query positions against Sk keys, both from 0, as in the forward; a
// cross-attention when they differ), lse (B, Hq, Sq) f32 from the forward;
// delta (B, Hq, Sq) f32 scratch; dq (B, Sq, Hq, D), dk, dv (B, Sk, Hkv, D)
// in q's type.  A key that no query sees (past Sq under the causal mask, or
// out of every window) gets zero dK and dV.
//
// Three launches (two in the split family below), no atomics, so every
// sum has a fixed order and the result does not vary between runs:
//  1. delta_kernel: Delta, one warp per (query position, head) row;
//  2. dq pass: one CTA per (q block, kv head, batch element) over the G
//     query heads of the kv head, walking the keys its rows may see, like
//     the forward, and accumulating dQ in registers;
//  3. dk/dv pass: one CTA per (key block, kv head, batch element), looping
//     over the G query heads and the query tiles that may see its keys,
//     so dK and dV sum over the G heads inside one CTA.
// (On wgmma, a persistent grid: each CTA takes such items in turn.)
//
// Which shapes take which launches (whole-sequence entry, bf16 at D 64,
// 112 and 128): where the dQ pass's (q block, kv head, batch) items fill
// the card's processors (rows 5, 5@112 and the training shapes: 512 or
// more items), the three above.  Where they fill few (flash_bwd_ranks > 1:
// seamless-m4t-medium's cross-attention, 64 items against Sk 1024, and its
// decoder self-attention, 64 items at S 256), two: the split dQ pass
// (flash_wgmma.cuh's dq_split2_kernel), one cluster of 2 CTAs an item
// whose ranks walk contiguous shares of its key tiles, each forming Delta
// for its rows from the O and dO tiles it loads (rank 0 stores it to
// `delta`), and add their dQ partials through
// distributed shared memory in rank order before one rounded store; then
// pass 3 as above, reading that Delta.  The scratch is the same `delta`.
// D 256, float32, other widths and the key-block entry keep three.
//
// What bounds it: operations.  Passes 2 and 3 do 7 products of the
// forward's size between them (QK^T and dO V^T in both, P^T dO and dS^T Q
// in pass 3, dS K in pass 2) against the 5 of a backward that keeps dQ in
// atomics: 3.5 times the forward's 4 B Hq S^2 D / 2 flops (causal), 481
// GFLOP at the training shape, 0.49 ms at 989 TFLOP/s bf16 (a gradient
// needs 2.5 times, 0.35 ms).  Recomputing two products buys a
// deterministic dQ.  bf16 with D 64 or 128 runs the two passes on wgmma
// with TMA loads, a producer warp and a persistent grid (dq_kernel and
// dkv_kernel in flash_wgmma.cuh: 128 query rows per CTA over 64-key
// tiles, 128 keys per CTA over 64-query tiles); bf16 with D 112 runs them
// padded to 128 (flash_wgmma.cuh says how); bf16 with D 256 on wgmma
// with tiles of its own (dq256_kernel and dkv256_kernel in
// flash_wgmma256.cuh: 128 query rows over 32-key tiles, 64 keys per CTA
// whose two warpgroups split the four products); float32 at D 64 and 128
// as three TF32 products on wgmma (flash_tf32.cuh, entry
// flash_bwd_tf32x3: Delta, the pre-passes of K, V, K^T, Q, dO, Q^T and
// dO^T's TF32 parts into its workspace, then dQ, dV and dK passes); other
// widths on CUDA cores (below), bound by shared-memory traffic.
// Both walk only the tiles the masks leave, and mask the ragged last
// tile.
//
// flash_bwd_block is the key-block entry of sequence-parallel attention
// (flash_fwd.cu's flash_fwd_block is its forward): k and v hold keys
// k_off .. k_off + Sk - 1, o and lse are the MERGED forward's over every
// block (so Delta and P are the whole sequence's), and it writes this
// block's partial dQ in f32, which the ranks add, and the block's own dK
// and dV.  Every kernel family takes the offset through its template flag
// KB; a query block that sees none of the keys stores a zero dQ.

#include <type_traits>

#include "flash_tf32.cuh"
#include "flash_wgmma256.cuh"

namespace {

using namespace paged;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // q rows (dq) / keys (dk, dv)
constexpr int kTk = 32;                       // keys (dq) / queries per tile

// Delta = rowsum(dO * O) in f32, one warp per (batch, query position,
// head) row of the Sq positions.
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o,
                             const T* __restrict__ d_o,
                             float* __restrict__ delta, int rows, int sq,
                             int hq, int d) {
  const int row = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + (long long)row * d;
  const T* grow = d_o + (long long)row * d;
  float acc = 0.f;
  for (int dd = lane; dd < d; dd += 32)
    acc += to_f32(orow[dd]) * to_f32(grow[dd]);
  acc = warp_sum(acc);
  if (lane == 0) {
    const int head = row % hq;
    const long long bs = row / hq;  // b * Sq + pos
    const long long b = bs / sq;
    const int pos = (int)(bs - b * sq);
    delta[(b * hq + head) * sq + pos] = acc;
  }
}

// Stage `n` rows of a (.., rows, H, D) tensor, starting at row r0, head
// `head`, into shared memory as f32 with row stride `stride`; rows past n
// are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* dst, long long base, int r0,
                                           int n, int heads, int d,
                                           int stride, int n_tile) {
  constexpr int vec = Vec<T>::n;
  const int chunks = d / vec;
  for (int i = threadIdx.x; i < n_tile * chunks; i += blockDim.x) {
    const int t = i / chunks;
    const int cc = (i - t * chunks) * vec;
    float x[vec];
    if (t < n) {
      load_n<T, vec>(src + (base + (long long)(r0 + t) * heads) * d + cc, x);
    } else {
#pragma unroll
      for (int e = 0; e < vec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < vec; ++e) dst[t * stride + cc + e] = x[e];
  }
}

// Score, softmax weight and dS of one (query, key) pair.  raw = q . k,
// dp = dO . v.  Returns dS with respect to the scaled, uncapped score (the
// caller multiplies by scale); *p gets P.
__device__ __forceinline__ float pair_grad(float raw, float dp, float lse,
                                           float delta, bool valid,
                                           float scale, float softcap,
                                           float* p) {
  float sc = raw * scale;
  float cap_grad = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(sc / softcap);
    sc = t * softcap;
    cap_grad = 1.f - t * t;
  }
  const float pv = valid ? expf(sc - lse) : 0.f;
  *p = pv;
  return pv * (dp - delta) * cap_grad;
}

size_t dq_smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)kRows * d + 2 * (size_t)kTk * (d + 1) +
                          (size_t)kRows * kTk);
}

// Pass 2: dQ.  Rows as in the forward: row r is head h * G + r / bq at
// position c0 + r % bq of the sq; the keys range over the sk (KB: a block
// at k_off, dQ in f32).
template <typename T, int DL, bool KB>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ d_o,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                std::conditional_t<KB, float, T>* __restrict__ dq, int sq,
                int sk, int hq, int hkv, int d, int bq, float scale,
                int causal, int window, float softcap, int k_off) {
  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g_n = hq / hkv;
  const int rows = g_n * bq;
  const int c0 = qb * bq;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // kRows * D
  float* g_s = q_s + kRows * d;                     // kRows * D (dO)
  float* k_s = g_s + kRows * d;                     // kTk * (D + 1)
  float* v_s = k_s + kTk * (d + 1);                 // kTk * (D + 1)
  float* ds_s = v_s + kTk * (d + 1);                // kRows * kTk

  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d;
    const int dd = i - r * d;
    const int pos = c0 + r % bq;
    float x = 0.f, y = 0.f;
    if (r < rows && pos < sq) {
      const long long off =
          (((long long)b * sq + pos) * hq + h * g_n + r / bq) * d + dd;
      x = to_f32(q[off]);
      y = to_f32(d_o[off]);
    }
    q_s[i] = x;
    g_s[i] = y;
  }

  // q_pos: the rows' positions less `shift` (a key block's offset), as
  // the masks compare them
  const int shift = KB ? k_off : 0;
  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp];
  float acc[kRowsPerWarp][DL];
  int q_pos[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp * kRowsPerWarp + j;
    q_pos[j] = c0 + r % bq - shift;
    const bool live = r < rows && q_pos[j] + shift < sq;
    const long long li =
        ((long long)b * hq + h * g_n + r / bq) * sq + q_pos[j] + shift;
    lse_r[j] = live ? lse[li] : 0.f;
    delta_r[j] = live ? delta[li] : 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[j][e] = 0.f;
  }

  const int q_hi = min(c0 + bq, sq) - 1 - shift;
  const long long k_lo64 = (long long)c0 - shift - (long long)window + 1;
  const int k_lo = k_lo64 > 0 ? (int)k_lo64 : 0;
  const int k_hi = causal ? min(q_hi + 1, sk) : sk;
  const long long kv_base = (long long)b * sk * hkv + h;

  for (int t0 = k_lo; t0 < k_hi; t0 += kTk) {
    const int n = min(kTk, k_hi - t0);
    stage_rows<T>(k, k_s, kv_base, t0, n, hkv, d, d + 1, kTk);
    stage_rows<T>(v, v_s, kv_base, t0, n, hkv, d, d + 1, kTk);
    __syncthreads();

    // q . k and dO . v of this warp's rows against key t0 + lane.
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) s[j] = dp[j] = 0.f;
    const float* qw = q_s + warp * kRowsPerWarp * d;
    const float* gw = g_s + warp * kRowsPerWarp * d;
    const float* krow = k_s + lane * (d + 1);
    const float* vrow = v_s + lane * (d + 1);
    for (int dd = 0; dd < d; dd += 4) {
      const float k0 = krow[dd], k1 = krow[dd + 1], k2 = krow[dd + 2],
                  k3 = krow[dd + 3];
      const float v0 = vrow[dd], v1 = vrow[dd + 1], v2 = vrow[dd + 2],
                  v3 = vrow[dd + 3];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + j * d + dd);
        const float4 gv = *reinterpret_cast<const float4*>(gw + j * d + dd);
        s[j] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
        dp[j] += gv.x * v0 + gv.y * v1 + gv.z * v2 + gv.w * v3;
      }
    }
    const int k_pos = t0 + lane;
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const bool valid = lane < n && (!causal || k_pos <= q_pos[j]) &&
                         (q_pos[j] - k_pos) < window;
      float p;
      ds_s[(warp * kRowsPerWarp + j) * kTk + lane] = pair_grad(
          s[j], dp[j], lse_r[j], delta_r[j], valid, scale, softcap, &p);
    }
    __syncwarp();

    // dQ += dS K: lanes across head_dim.
    const float* dsw = ds_s + warp * kRowsPerWarp * kTk;
    for (int t = 0; t < n; ++t) {
      float kk[DL];
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        const int dd = lane + 32 * e;
        kk[e] = dd < d ? k_s[t * (d + 1) + dd] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const float x = dsw[j * kTk + t];
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[j][e] += x * kk[e];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp * kRowsPerWarp + j;
    if (r >= rows || q_pos[j] + shift >= sq) continue;
    const long long orow =
        ((long long)b * sq + q_pos[j] + shift) * hq + h * g_n + r / bq;
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      const int dd = lane + 32 * e;
      if (dd < d) store_val(dq + orow * d + dd, acc[j][e] * scale);
    }
  }
}

size_t dkv_smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)kRows * d + 2 * (size_t)kTk * (d + 1) +
                          2 * (size_t)kRows * kTk + 2 * (size_t)kTk);
}

// Pass 3: dK and dV for kRows keys [k0, k0 + kRows) of the sk of kv head
// h; warp w owns keys k0 + 8w .. k0 + 8w + 7, and the lanes take the
// queries of a tile (scores) or head_dim (accumulation).  A block no query
// sees walks no tile and stores zeros.  KB: key k sits at position
// k_off + k.
template <typename T, int DL, bool KB>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ d_o,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int sq, int sk, int hq, int hkv, int d,
                 float scale, int causal, int window, float softcap,
                 int k_off) {
  const int kb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g_n = hq / hkv;
  const int k0 = kb * kRows;
  const int n_keys = min(kRows, sk - k0);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* k_s = reinterpret_cast<float*>(smem_raw);  // kRows * D
  float* v_s = k_s + kRows * d;                     // kRows * D
  float* q_s = v_s + kRows * d;                     // kTk * (D + 1)
  float* g_s = q_s + kTk * (d + 1);                 // kTk * (D + 1)
  float* p_s = g_s + kTk * (d + 1);                 // kRows * kTk
  float* ds_s = p_s + kRows * kTk;                  // kRows * kTk
  float* lse_s = ds_s + kRows * kTk;                // kTk
  float* delta_s = lse_s + kTk;                     // kTk

  const long long kv_base = (long long)b * sk * hkv + h;
  stage_rows<T>(k, k_s, kv_base, k0, n_keys, hkv, d, d, kRows);
  stage_rows<T>(v, v_s, kv_base, k0, n_keys, hkv, d, d, kRows);

  float dk_acc[kRowsPerWarp][DL], dv_acc[kRowsPerWarp][DL];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
    for (int e = 0; e < DL; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  // Queries that may see some key of the block: [q_lo, q_hi), none when
  // q_hi <= q_lo.  The masks compare key positions, shift + the key.
  const int shift = KB ? k_off : 0;
  const int k_last = k0 + n_keys - 1 + shift;
  const int q_lo = causal ? k0 + shift : 0;
  const long long q_hi64 = (long long)k_last + (long long)window;
  const int q_hi = q_hi64 < sq ? (int)q_hi64 : sq;

  for (int g = 0; g < g_n; ++g) {
    const int head = h * g_n + g;
    const long long q_base = (long long)b * sq * hq + head;
    const float* lse_h = lse + ((long long)b * hq + head) * sq;
    const float* delta_h = delta + ((long long)b * hq + head) * sq;
    for (int t0 = q_lo; t0 < q_hi; t0 += kTk) {
      const int n = min(kTk, q_hi - t0);
      __syncthreads();  // the previous tile's readers are done
      stage_rows<T>(q, q_s, q_base, t0, n, hq, d, d + 1, kTk);
      stage_rows<T>(d_o, g_s, q_base, t0, n, hq, d, d + 1, kTk);
      if (tid < kTk) {
        lse_s[tid] = tid < n ? lse_h[t0 + tid] : 0.f;
        delta_s[tid] = tid < n ? delta_h[t0 + tid] : 0.f;
      }
      __syncthreads();

      // q . k and dO . v of query t0 + lane against this warp's keys.
      float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) s[j] = dp[j] = 0.f;
      const float* qrow = q_s + lane * (d + 1);
      const float* grow = g_s + lane * (d + 1);
      const float* kw = k_s + warp * kRowsPerWarp * d;
      const float* vw = v_s + warp * kRowsPerWarp * d;
      for (int dd = 0; dd < d; dd += 4) {
        const float q0 = qrow[dd], q1 = qrow[dd + 1], q2 = qrow[dd + 2],
                    q3 = qrow[dd + 3];
        const float g0 = grow[dd], g1 = grow[dd + 1], g2 = grow[dd + 2],
                    g3 = grow[dd + 3];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const float4 kv4 = *reinterpret_cast<const float4*>(kw + j * d + dd);
          const float4 vv4 = *reinterpret_cast<const float4*>(vw + j * d + dd);
          s[j] += q0 * kv4.x + q1 * kv4.y + q2 * kv4.z + q3 * kv4.w;
          dp[j] += g0 * vv4.x + g1 * vv4.y + g2 * vv4.z + g3 * vv4.w;
        }
      }
      const int qp = t0 + lane;
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int key = warp * kRowsPerWarp + j;
        const int kp = k0 + key + shift;
        const bool valid = lane < n && key < n_keys &&
                           (!causal || kp <= qp) && (qp - kp) < window;
        float p;
        const float x = pair_grad(s[j], dp[j], lse_s[lane], delta_s[lane],
                                  valid, scale, softcap, &p);
        p_s[key * kTk + lane] = p;
        ds_s[key * kTk + lane] = x;
      }
      __syncwarp();

      // dV += P^T dO, dK += dS^T Q: lanes across head_dim.
      const float* pw = p_s + warp * kRowsPerWarp * kTk;
      const float* dsw = ds_s + warp * kRowsPerWarp * kTk;
      for (int t = 0; t < n; ++t) {
        float gq[DL], qq[DL];
#pragma unroll
        for (int e = 0; e < DL; ++e) {
          const int dd = lane + 32 * e;
          gq[e] = dd < d ? g_s[t * (d + 1) + dd] : 0.f;
          qq[e] = dd < d ? q_s[t * (d + 1) + dd] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          const float pj = pw[j * kTk + t];
          const float xj = dsw[j * kTk + t];
#pragma unroll
          for (int e = 0; e < DL; ++e) {
            dv_acc[j][e] += pj * gq[e];
            dk_acc[j][e] += xj * qq[e];
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int key = warp * kRowsPerWarp + j;
    if (key >= n_keys) continue;
    const long long orow = kv_base + (long long)(k0 + key) * hkv;
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      const int dd = lane + 32 * e;
      if (dd < d) {
        store_val(dk + orow * d + dd, dk_acc[j][e] * scale);
        store_val(dv + orow * d + dd, dv_acc[j][e]);
      }
    }
  }
}

template <typename T>
int launch_delta(const void* o, const void* d_o, float* delta, int batch,
                 int sq, int hq, int d, cudaStream_t stream) {
  const int rows = batch * sq * hq;
  constexpr int kWarpsPerBlock = 8;
  delta_kernel<T><<<(rows + kWarpsPerBlock - 1) / kWarpsPerBlock,
                    32 * kWarpsPerBlock, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(d_o), delta, rows,
      sq, hq, d);
  return (int)cudaGetLastError();
}

template <typename T, int DL, bool KB>
int launch_cuda_cores(const void* q, const void* k, const void* v,
                      const void* d_o, const float* lse, const float* delta,
                      void* dq, void* dk, void* dv, int batch, int sq, int sk,
                      int hq, int hkv, int d, float scale, int causal,
                      int window, float softcap, int k_off,
                      cudaStream_t stream) {
  static size_t opted_dq = 48 * 1024, opted_dkv = 48 * 1024;
  const size_t smem_dq = dq_smem_bytes(d), smem_dkv = dkv_smem_bytes(d);
  cudaError_t e =
      allow_smem(flash_dq_kernel<T, DL, KB>, smem_dq, &opted_dq);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(flash_dkv_kernel<T, DL, KB>, smem_dkv, &opted_dkv);
  if (e != cudaSuccess) return (int)e;
  const int bq = kRows / (hq / hkv);
  const dim3 grid_q((sq + bq - 1) / bq, hkv, batch);
  flash_dq_kernel<T, DL, KB><<<grid_q, kThreads, smem_dq, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(d_o), lse, delta,
      static_cast<std::conditional_t<KB, float, T>*>(dq), sq, sk, hq, hkv, d,
      bq, scale, causal, window, softcap, k_off);
  const dim3 grid_k((sk + kRows - 1) / kRows, hkv, batch);
  flash_dkv_kernel<T, DL, KB><<<grid_k, kThreads, smem_dkv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(d_o), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, hq, hkv, d, scale,
      causal, window, softcap, k_off);
  return (int)cudaGetLastError();
}

template <typename T, bool KB>
int launch_type(const void* q, const void* k, const void* v,
                const void* d_o, const float* lse, const float* delta,
                void* dq, void* dk, void* dv, int batch, int sq, int sk,
                int hq, int hkv, int d, float scale, int causal, int window,
                float softcap, int k_off, cudaStream_t stream) {
#define REPRO_FLASH_DL(N)                                                   \
  if (d <= 32 * N)                                                          \
    return launch_cuda_cores<T, N, KB>(q, k, v, d_o, lse, delta, dq, dk,    \
                                       dv, batch, sq, sk, hq, hkv, d, scale, \
                                       causal, window, softcap, k_off,      \
                                       stream);
  REPRO_FLASH_DL(1)
  REPRO_FLASH_DL(2)
  REPRO_FLASH_DL(4)
  REPRO_FLASH_DL(8)
#undef REPRO_FLASH_DL
  return (int)cudaErrorInvalidValue;
}

// Either entry after its checks: Delta, then the two passes (KB false the
// whole sequence, dQ in q's type; KB true the key block at k_off, dQ f32);
// or, at ranks 2 (the wgmma family's whole-sequence split), the split
// dQ pass, which forms Delta, then the dK/dV pass.
template <bool KB>
int run_bwd(int dtype, const void* q, const void* k, const void* v,
            const void* o, const void* d_o, const float* lse, float* delta,
            void* dq, void* dk, void* dv, int batch, int sq, int sk, int hq,
            int hkv, int d, float scale, int causal, int window,
            float softcap, int k_off, int ranks, cudaStream_t st) {
  const bool split_family = !KB && dtype == 1 && flash_wgmma::takes(d);
  if (ranks != 1 && !split_family) return (int)cudaErrorInvalidValue;
  // float32 at D 64 and 128 is flash_bwd_tf32x3's (it needs a workspace)
  if (dtype == 0 && flash_tf32::takes(d)) return (int)cudaErrorInvalidValue;
  if (ranks != 1)
    return flash_wgmma::dispatch_d(d, [&](auto dt) {
      return flash_wgmma::launch_bwd_ranked<decltype(dt)::value>(
          ranks, q, k, v, o, d_o, lse, delta, dq, dk, dv, batch, sq, sk, hq,
          hkv, scale, causal, window, softcap, st);
    }, (int)cudaErrorInvalidValue);
  int err;
  if (dtype == 0) {
    err = launch_delta<float>(o, d_o, delta, batch, sq, hq, d, st);
    if (err) return err;
    return launch_type<float, KB>(q, k, v, d_o, lse, delta, dq, dk, dv,
                                  batch, sq, sk, hq, hkv, d, scale, causal,
                                  window, softcap, k_off, st);
  }
  if (dtype == 1) {
    err = launch_delta<__nv_bfloat16>(o, d_o, delta, batch, sq, hq, d, st);
    if (err) return err;
    if (flash_wgmma::takes(d))
      return flash_wgmma::dispatch_d(d, [&](auto dt) {
        return flash_wgmma::launch_bwd_d<decltype(dt)::value, KB>(
            q, k, v, d_o, lse, delta, dq, dk, dv, batch, sq, sk, hq, hkv,
            scale, causal, window, softcap, k_off, st);
      }, (int)cudaErrorInvalidValue);
    if (d == flash_wgmma::kD256)
      return flash_wgmma::launch_bwd256<KB>(q, k, v, d_o, lse, delta, dq, dk,
                                            dv, batch, sq, sk, hq, hkv, scale,
                                            causal, window, softcap, k_off,
                                            st);
    return launch_type<__nv_bfloat16, KB>(q, k, v, d_o, lse, delta, dq, dk,
                                          dv, batch, sq, sk, hq, hkv, d,
                                          scale, causal, window, softcap,
                                          k_off, st);
  }
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int d, int hq, int hkv, int sq, int sk) {
  return d <= 0 || d % 8 || d > 256 || hkv <= 0 || hq % hkv ||
         hq / hkv > kRows || sq < 1 || sk < 1;
}

}  // namespace

extern "C" {

// Limits the wrapper reads before it launches.
int flash_bwd_max_g() { return kRows; }
int flash_bwd_max_d() { return 256; }

// The rank count flash_bwd splits a whole-sequence call's dQ pass over
// (flash_wgmma.cuh's split_ranks with the pass's 64-key tiles on this
// card's processors): 2 for bf16 at D 64, 112 and 128 where the query
// blocks fill few processors, else 1.
int flash_bwd_ranks(int dtype, int d, int batch, int sq, int sk, int hq,
                    int hkv, int causal, int window) {
  if (dtype != 1 || !flash_wgmma::takes(d) || bad_shape(d, hq, hkv, sq, sk))
    return 1;
  return flash_wgmma::bwd_ranks(batch, sq, sk, hq, hkv, causal, window);
}

// The kernels a call at this dtype, D and rank count (flash_bwd_ranks, or
// the key-block entry's 1) launches: 0 CUDA cores (delta_kernel,
// flash_dq_kernel, flash_dkv_kernel), 2 wgmma (delta_kernel, then
// flash_wgmma.cuh at D 64, 112 and 128, flash_wgmma256.cuh at D 256), 3
// the split family (dq_split2_kernel, Delta inside,
// then dkv_kernel), 4 float32 at D 64 and 128 (delta_kernel, the
// pre-passes, then flash_tf32.cuh's dQ, dV and dK passes, through
// flash_bwd_tf32x3), numbered as flash_fwd_variant.
int flash_bwd_variant(int dtype, int d, int ranks) {
  if (dtype == 0 && flash_tf32::takes(d)) return 4;
  if (dtype == 1 && flash_wgmma::takes(d) && ranks > 1) return 3;
  return dtype == 1 && (flash_wgmma::takes(d) || d == flash_wgmma::kD256)
             ? 2
             : 0;
}

// dtype: 0 = float32 (but for D 64 and 128: flash_bwd_tf32x3), 1 =
// bfloat16; q, k, v, o, d_o as in the forward
// (contiguous, the model's layout): sq query and sk key positions per batch
// element, both >= 1, and a window that leaves the last query row a key
// (sq - window < sk), as flash_fwd takes them; lse (B, Hq, Sq) f32 from
// the forward; delta (B, Hq, Sq) f32 scratch.  Writes dq, dk, dv in q's
// type.  Splits the dQ pass over flash_bwd_ranks' count.  Returns
// cudaGetLastError().
int flash_bwd(int dtype, const void* q, const void* k, const void* v,
              const void* o, const void* d_o, const void* lse, void* delta,
              void* dq, void* dk, void* dv, int batch, int sq, int sk, int hq,
              int hkv, int d, float scale, int causal, int window,
              float softcap, void* stream) {
  if (bad_shape(d, hq, hkv, sq, sk) ||
      (long long)sq - (long long)window >= (long long)sk)
    return (int)cudaErrorInvalidValue;
  return run_bwd<false>(dtype, q, k, v, o, d_o, static_cast<const float*>(lse),
                        static_cast<float*>(delta), dq, dk, dv, batch, sq, sk,
                        hq, hkv, d, scale, causal, window, softcap, 0,
                        flash_bwd_ranks(dtype, d, batch, sq, sk, hq, hkv,
                                        causal, window),
                        static_cast<cudaStream_t>(stream));
}

// flash_bwd at a rank count of the caller's: 1 (every family: Delta, then
// the two passes), 2 (bf16 at D 64, 112, 128: the split family; 4 too
// in a copy built with FLASH_MAX_RANKS 4), whatever flash_bwd_ranks
// would choose; for checks and benches.
int flash_bwd_split(int ranks, int dtype, const void* q, const void* k,
                    const void* v, const void* o, const void* d_o,
                    const void* lse, void* delta, void* dq, void* dk,
                    void* dv, int batch, int sq, int sk, int hq, int hkv,
                    int d, float scale, int causal, int window,
                    float softcap, void* stream) {
  if (bad_shape(d, hq, hkv, sq, sk) ||
      (long long)sq - (long long)window >= (long long)sk)
    return (int)cudaErrorInvalidValue;
  return run_bwd<false>(dtype, q, k, v, o, d_o, static_cast<const float*>(lse),
                        static_cast<float*>(delta), dq, dk, dv, batch, sq, sk,
                        hq, hkv, d, scale, causal, window, softcap, 0, ranks,
                        static_cast<cudaStream_t>(stream));
}

// The key-block entry: as flash_bwd, with k and v the sk keys at
// positions k_off .. k_off + sk - 1 (k_off >= 0), o and lse the merged
// forward's over every block, any window >= 1; dq (B, Sq, Hq, D) is this
// block's partial in f32, dk and dv the block's in q's type.
int flash_bwd_block(int dtype, const void* q, const void* k, const void* v,
                    const void* o, const void* d_o, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int batch,
                    int sq, int sk, int hq, int hkv, int d, float scale,
                    int causal, int window, float softcap, int k_off,
                    void* stream) {
  if (bad_shape(d, hq, hkv, sq, sk) || k_off < 0 || window < 1)
    return (int)cudaErrorInvalidValue;
  return run_bwd<true>(dtype, q, k, v, o, d_o, static_cast<const float*>(lse),
                       static_cast<float*>(delta), dq, dk, dv, batch, sq, sk,
                       hq, hkv, d, scale, causal, window, softcap, k_off, 1,
                       static_cast<cudaStream_t>(stream));
}

// The workspace (floats) flash_bwd_tf32x3 takes at this shape: the TF32
// lo parts of K, V, Q and dO (their hi parts are the tensors themselves)
// and the hi and lo parts of K^T, Q^T and dO^T.
long long flash_bwd_tf32x3_ws_floats(int d, int batch, int sq, int sk,
                                     int hq, int hkv) {
  return flash_tf32::bwd_ws_floats(d, batch, sq, sk, hq, hkv);
}

// float32 at D 64 and 128 (variant 4): either entry, kb 0 the whole
// sequence (as flash_bwd, k_off 0) or kb 1 the key block at k_off (as
// flash_bwd_block: o and lse the merged forward's).  Writes dq, dk, dv in
// float32; delta (B, Hq, Sq) f32 scratch; ws 16-byte aligned, at least
// flash_bwd_tf32x3_ws_floats floats.  Six launches: Delta, the two
// pre-passes, then the dQ, dV and dK passes.
int flash_bwd_tf32x3(int kb, const void* q, const void* k, const void* v,
                     const void* o, const void* d_o, const void* lse,
                     void* delta, void* ws, long long ws_floats, void* dq,
                     void* dk, void* dv, int batch, int sq, int sk, int hq,
                     int hkv, int d, float scale, int causal, int window,
                     float softcap, int k_off, void* stream) {
  if (bad_shape(d, hq, hkv, sq, sk) || !flash_tf32::takes(d) ||
      (kb ? (k_off < 0 || window < 1)
          : (k_off != 0 ||
             (long long)sq - (long long)window >= (long long)sk)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_delta<float>(o, d_o, static_cast<float*>(delta),
                                      batch, sq, hq, d, st);
  if (err) return err;
  auto run = kb ? flash_tf32::run_bwd<true> : flash_tf32::run_bwd<false>;
  return run(q, k, v, d_o, static_cast<const float*>(lse),
             static_cast<const float*>(delta), static_cast<float*>(ws),
             ws_floats, dq, dk, dv, batch, sq, sk, hq, hkv, d, scale, causal,
             window, softcap, k_off, st);
}

}  // extern "C"
