// Dense flash attention, forward, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/attention/attention.py:flash_attention_pallas
// (body _flash_kernel): softmax(scale * Q K^T, masked) V for Sq query
// positions against Sk key positions per batch element (both counted from
// 0; Sq == Sk is one sequence attending to itself, Sq != Sk a
// cross-attention), with GQA (G = Hq / Hkv query heads per kv head), an
// optional causal mask q_pos >= k_pos, an optional sliding window
// q_pos - k_pos < window and an optional tanh softcap, scale 1 / sqrt(D).
// Besides O it writes the f32 row log-sum-exp of the (capped) scores, which
// the backward (flash_bwd.cu) needs.
//
// q   (B, Sq, Hq, D)   the model's layout, float32 or bfloat16
// k,v (B, Sk, Hkv, D)
// o   (B, Sq, Hq, D)   in q's type
// lse (B, Hq, Sq)      f32
//
// What bounds it: operations.  The causal forward does 4 B Hq S^2 D / 2
// flops (QK^T and PV over the lower triangle): 137 GFLOP at the training
// shape (B 2, Hq 16, S 4096, D 128), 0.139 ms of tensor cores at 989
// TFLOP/s bf16, against 101 MB of Q, K, V, O and the log-sum-exp.  The
// design:
//  * the TPU kernel walks keys along a sequential grid axis and carries
//    (m, l, acc) in VMEM; here one CTA walks its key range in a loop and
//    keeps that state in registers;
//  * one CTA per (q block, kv head, batch element): its rows are the G
//    query heads of the kv head at bq = kRows / G positions, so each K/V
//    tile it loads serves all G heads (the TPU kernel copies K/V G times);
//  * it walks only the keys some row of the block may see: from the
//    window's start for its first row to its last row's position under the
//    causal mask (or to Sk), so wholly masked tiles are never loaded; the
//    ragged last tile (any Sk) is masked key by key;
//  * bf16 with D 64, 112, 128 or 256 runs on wgmma with TMA loads, a
//    producer warp and a persistent grid (fwd_kernel in flash_wgmma.cuh:
//    128 query rows per CTA, 128-key tiles; D 112 padded to 128 in shared
//    memory, its last 16 columns zero-filled by TMA; D 256 with 64-key
//    tiles and O through shared memory, FwdTraits there), with f32
//    accumulation and the softmax in the log2 domain.  float32 at D 64
//    and 128 runs every product as three TF32 products on wgmma
//    (flash_tf32.cuh, entry flash_fwd_tf32x3, which takes a workspace for
//    K's and V^T's TF32 parts); other widths, in either type, run the
//    products on CUDA cores (flash_fwd_kernel below), bound by
//    shared-memory traffic;
//  * where the (q block, kv head, batch) items of such a whole-sequence
//    call fill few of the card's processors (seamless-m4t-medium's
//    cross-attention, B 2 x 16 heads x 2 query blocks: 64 items on 132
//    processors, each walking 1024 keys alone), the split family takes
//    it: one cluster of 2 CTAs an item (fwd_split2_kernel: fwd_kernel's
//    body), the ranks walking contiguous shares of the item's key tiles
//    and merging (m, l, O) through distributed shared memory in rank
//    order before one rounded store.
//    flash_fwd_ranks says which shapes split and how far
//    (flash_wgmma.cuh's split_ranks: items x ranks within the
//    processors, at least two 128-key tiles a rank); flash_fwd_split
//    fixes the count.
//
// Masking: the TPU kernel's finite -1e30 is the initial max, and a masked
// key weighs 0 (not exp(0)), so no row ever meets exp(-inf - -inf) = NaN.
// Every row sees at least one key (flash_fwd refuses a window that would
// leave the last query row none: Sq - window >= Sk), so l > 0 at the end.
//
// flash_fwd_block is the key-block entry of sequence-parallel attention:
// k and v hold keys k_off .. k_off + Sk - 1 of a longer sequence (the
// queries still at 0 .. Sq - 1), every kernel family takes the offset
// through its template flag KB (flash_wgmma.cuh's header says how), and
// O comes out in f32: the block's normalized partial, which the ranks'
// merge weighs by exp(lse - max lse) and adds before it rounds once.  A
// row that sees no key of the block (l = 0) gets O = 0 and lse = -inf,
// weight 0 in the merge; this entry refuses no window.

#include <type_traits>

#include "flash_tf32.cuh"

namespace {

using namespace paged;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kTk = 32;                       // keys per tile

size_t fwd_smem_bytes(int d) {
  return sizeof(float) * ((size_t)kRows * d + (size_t)kTk * (d + 1) +
                          (size_t)kTk * d + (size_t)kRows * kTk);
}

// DL: head_dim elements per lane in the PV product (D <= 32 * DL).  KB:
// the keys are a block at k_off (O in f32).
template <typename T, int DL, bool KB>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v,
                 std::conditional_t<KB, float, T>* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int hq, int hkv,
                 int d, int bq, float scale, int causal, int window,
                 float softcap, int k_off) {
  const int qb = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g_n = hq / hkv;
  const int rows = g_n * bq;  // row r: head h * G + r / bq, position
  const int c0 = qb * bq;     //        c0 + r % bq
  constexpr int vec = Vec<T>::n;
  const int chunks = d / vec;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // kRows * D
  float* k_s = q_s + kRows * d;                     // kTk * (D + 1)
  float* v_s = k_s + kTk * (d + 1);                 // kTk * D
  float* p_s = v_s + kTk * d;                       // kRows * kTk

  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d;
    const int dd = i - r * d;
    const int pos = c0 + r % bq;
    float x = 0.f;
    if (r < rows && pos < sq)
      x = to_f32(q[(((long long)b * sq + pos) * hq + h * g_n + r / bq) *
                       d + dd]);
    q_s[i] = x;
  }

  // Keys some row of the block may see: [k_lo, k_hi).  The masks compare
  // positions less `shift` (a key block's offset).
  const int shift = KB ? k_off : 0;
  const int q_lo = c0 - shift;
  const int q_hi = min(c0 + bq, sq) - 1 - shift;
  const long long k_lo64 = (long long)q_lo - (long long)window + 1;
  const int k_lo = k_lo64 > 0 ? (int)k_lo64 : 0;
  const int k_hi = causal ? min(q_hi + 1, sk) : sk;

  float m[kRowsPerWarp], l[kRowsPerWarp];
  float acc[kRowsPerWarp][DL];
  int q_pos[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    m[j] = kNegInf;
    l[j] = 0.f;
    q_pos[j] = c0 + (warp * kRowsPerWarp + j) % bq - shift;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[j][e] = 0.f;
  }
  const long long kv_base = (long long)b * sk * hkv + h;

  for (int t0 = k_lo; t0 < k_hi; t0 += kTk) {
    const int n = min(kTk, k_hi - t0);
    // K and V tile -> shared memory as f32, 16 bytes per load; the tail
    // past n is zero so that no lane reads stale data.
    for (int i = tid; i < kTk * chunks; i += kThreads) {
      const int t = i / chunks;
      const int cc = (i - t * chunks) * vec;
      float kb[vec], vb[vec];
      if (t < n) {
        const long long off = (kv_base + (long long)(t0 + t) * hkv) * d + cc;
        load_n<T, vec>(k + off, kb);
        load_n<T, vec>(v + off, vb);
      } else {
#pragma unroll
        for (int e = 0; e < vec; ++e) kb[e] = vb[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < vec; ++e) {
        k_s[t * (d + 1) + cc + e] = kb[e];
        v_s[t * d + cc + e] = vb[e];
      }
    }
    __syncthreads();

    // Scores of this warp's rows against key t0 + lane.
    float s[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) s[j] = 0.f;
    const float* qw = q_s + warp * kRowsPerWarp * d;
    const float* krow = k_s + lane * (d + 1);
    for (int dd = 0; dd < d; dd += 4) {
      const float k0 = krow[dd], k1 = krow[dd + 1], k2 = krow[dd + 2],
                  k3 = krow[dd + 3];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + j * d + dd);
        s[j] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
      }
    }
    const int k_pos = t0 + lane;
    float alpha[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      float sc = s[j] * scale;
      if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
      const bool valid = lane < n && (!causal || k_pos <= q_pos[j]) &&
                         (q_pos[j] - k_pos) < window;
      sc = valid ? sc : kNegInf;
      const float m_new = fmaxf(m[j], warp_max(sc));
      const float p = valid ? expf(sc - m_new) : 0.f;
      alpha[j] = expf(m[j] - m_new);
      l[j] = l[j] * alpha[j] + warp_sum(p);
      m[j] = m_new;
      p_s[(warp * kRowsPerWarp + j) * kTk + lane] = p;
    }
    __syncwarp();

    // PV: lanes across head_dim, this warp's rows in registers.
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j)
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[j][e] *= alpha[j];
    const float* pw = p_s + warp * kRowsPerWarp * kTk;
    for (int t = 0; t < n; ++t) {
      float vv[DL];
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        const int dd = lane + 32 * e;
        vv[e] = dd < d ? v_s[t * d + dd] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const float pj = pw[j * kTk + t];
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[j][e] += pj * vv[e];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int r = warp * kRowsPerWarp + j;
    const int pos = q_pos[j] + shift;
    if (r >= rows || pos >= sq) continue;
    const int head = h * g_n + r / bq;
    const long long orow = ((long long)b * sq + pos) * hq + head;
    const float inv = 1.f / fmaxf(l[j], 1e-30f);
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      const int dd = lane + 32 * e;
      if (dd < d) store_val(o + orow * d + dd, acc[j][e] * inv);
    }
    if (lane == 0)
      lse[((long long)b * hq + head) * sq + pos] =
          KB && l[j] == 0.f ? -INFINITY : m[j] + logf(fmaxf(l[j], 1e-30f));
  }
}

template <typename T, int DL, bool KB>
int launch_cuda_cores(const void* q, const void* k, const void* v, void* o,
                      float* lse, int batch, int sq, int sk, int hq,
                      int hkv, int d, float scale, int causal, int window,
                      float softcap, int k_off, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  const size_t smem = fwd_smem_bytes(d);
  const cudaError_t e =
      allow_smem(flash_fwd_kernel<T, DL, KB>, smem, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const int bq = kRows / (hq / hkv);
  const dim3 grid((sq + bq - 1) / bq, hkv, batch);
  flash_fwd_kernel<T, DL, KB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v),
      static_cast<std::conditional_t<KB, float, T>*>(o), lse, sq, sk, hq,
      hkv, d, bq, scale, causal, window, softcap, k_off);
  return (int)cudaGetLastError();
}

template <typename T, bool KB>
int launch_type(const void* q, const void* k, const void* v, void* o,
                float* lse, int batch, int sq, int sk, int hq, int hkv,
                int d, float scale, int causal, int window, float softcap,
                int k_off, cudaStream_t stream) {
#define REPRO_FLASH_DL(N)                                                    \
  if (d <= 32 * N)                                                           \
    return launch_cuda_cores<T, N, KB>(q, k, v, o, lse, batch, sq, sk, hq,   \
                                       hkv, d, scale, causal, window,        \
                                       softcap, k_off, stream);
  REPRO_FLASH_DL(1)
  REPRO_FLASH_DL(2)
  REPRO_FLASH_DL(4)
  REPRO_FLASH_DL(8)
#undef REPRO_FLASH_DL
  return (int)cudaErrorInvalidValue;
}

// Either entry: KB false the whole sequence, O in q's type; KB true the
// key block at k_off, O in f32.  ranks: the wgmma family's split (1 the
// persistent grid; whole sequence only); the other families take 1.  The
// caller has checked the arguments.
template <bool KB>
int run_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
            float* lse, int batch, int sq, int sk, int hq, int hkv, int d,
            float scale, int causal, int window, float softcap, int k_off,
            int ranks, cudaStream_t st) {
  const bool split_family = !KB && dtype == 1 && flash_wgmma::takes(d);
  if (ranks != 1 && !split_family) return (int)cudaErrorInvalidValue;
  // float32 at D 64 and 128 is flash_fwd_tf32x3's (it needs a workspace)
  if (dtype == 0 && flash_tf32::takes(d)) return (int)cudaErrorInvalidValue;
  if (ranks != 1)
    return flash_wgmma::dispatch_d(d, [&](auto dt) {
      return flash_wgmma::launch_fwd_ranked<decltype(dt)::value>(
          ranks, q, k, v, o, lse, batch, sq, sk, hq, hkv, scale, causal,
          window, softcap, st);
    }, (int)cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_type<float, KB>(q, k, v, o, lse, batch, sq, sk, hq, hkv, d,
                                  scale, causal, window, softcap, k_off, st);
  if (dtype == 1) {
    if (flash_wgmma::takes(d))
      return flash_wgmma::dispatch_d(d, [&](auto dt) {
        return flash_wgmma::launch_fwd_d<decltype(dt)::value, KB>(
            q, k, v, o, lse, batch, sq, sk, hq, hkv, scale, causal, window,
            softcap, k_off, st);
      }, (int)cudaErrorInvalidValue);
    if (d == flash_wgmma::kD256)
      return flash_wgmma::launch_fwd_d<flash_wgmma::kD256, KB>(
          q, k, v, o, lse, batch, sq, sk, hq, hkv, scale, causal, window,
          softcap, k_off, st);
    return launch_type<__nv_bfloat16, KB>(q, k, v, o, lse, batch, sq, sk, hq,
                                          hkv, d, scale, causal, window,
                                          softcap, k_off, st);
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
int flash_fwd_max_g() { return kRows; }
int flash_fwd_max_d() { return 256; }

// The rank count flash_fwd splits a whole-sequence call's key ranges
// over (flash_wgmma.cuh's split_ranks on this card's processors): 2
// for bf16 at D 64, 112 and 128 where the items fill few processors, else
// 1.  window as flash_fwd takes it.
int flash_fwd_ranks(int dtype, int d, int batch, int sq, int sk, int hq,
                    int hkv, int causal, int window) {
  if (dtype != 1 || !flash_wgmma::takes(d) || bad_shape(d, hq, hkv, sq, sk))
    return 1;
  return flash_wgmma::fwd_ranks(batch, sq, sk, hq, hkv, causal, window);
}

// The kernel a call at this dtype, D and rank count (flash_fwd_ranks, or
// the key-block entry's 1) launches: 0 CUDA cores (flash_fwd_kernel), 2
// wgmma (flash_wgmma.cuh's fwd_kernel at D 64, 112, 128 and 256), 3 the
// split family (fwd_split2_kernel), 4 float32 at D 64 and 128 as three
// TF32 products (flash_tf32.cuh, through flash_fwd_tf32x3), numbered as
// the other libraries' families (1 is mma.sync).
int flash_fwd_variant(int dtype, int d, int ranks) {
  if (dtype == 0 && flash_tf32::takes(d)) return 4;
  if (dtype == 1 && flash_wgmma::takes(d) && ranks > 1) return 3;
  return dtype == 1 && (flash_wgmma::takes(d) || d == flash_wgmma::kD256)
             ? 2
             : 0;
}

// dtype: 0 = float32 (but for D 64 and 128: flash_fwd_tf32x3), 1 =
// bfloat16.  sq query and sk key positions per
// batch element, both >= 1.  causal: 0 or 1.  A window of INT32_MAX means
// none; a window that leaves the last query row no key (sq - window >= sk)
// is refused.  softcap <= 0 means none.  D must be a multiple of 8 and at
// most 256, Hq a multiple of Hkv with G = Hq / Hkv <= 32.  Splits the key
// ranges over flash_fwd_ranks' count.  Returns cudaGetLastError().
int flash_fwd(int dtype, const void* q, const void* k, const void* v,
              void* o, void* lse, int batch, int sq, int sk, int hq, int hkv,
              int d, float scale, int causal, int window, float softcap,
              void* stream) {
  if (bad_shape(d, hq, hkv, sq, sk) ||
      (long long)sq - (long long)window >= (long long)sk)
    return (int)cudaErrorInvalidValue;
  return run_fwd<false>(dtype, q, k, v, o, static_cast<float*>(lse), batch,
                        sq, sk, hq, hkv, d, scale, causal, window, softcap, 0,
                        flash_fwd_ranks(dtype, d, batch, sq, sk, hq, hkv,
                                        causal, window),
                        static_cast<cudaStream_t>(stream));
}

// flash_fwd at a rank count of the caller's: 1 (every family; the
// persistent grid for wgmma), 2 (bf16 at D 64, 112, 128: the split
// family; 4 too in a copy built with FLASH_MAX_RANKS 4), whatever
// flash_fwd_ranks would choose; for checks and benches.
int flash_fwd_split(int ranks, int dtype, const void* q, const void* k,
                    const void* v, void* o, void* lse, int batch, int sq,
                    int sk, int hq, int hkv, int d, float scale, int causal,
                    int window, float softcap, void* stream) {
  if (bad_shape(d, hq, hkv, sq, sk) ||
      (long long)sq - (long long)window >= (long long)sk)
    return (int)cudaErrorInvalidValue;
  return run_fwd<false>(dtype, q, k, v, o, static_cast<float*>(lse), batch,
                        sq, sk, hq, hkv, d, scale, causal, window, softcap, 0,
                        ranks, static_cast<cudaStream_t>(stream));
}

// The key-block entry: as flash_fwd, with k and v the sk keys at
// positions k_off .. k_off + sk - 1 (k_off >= 0) against queries at
// 0 .. sq - 1, and o (B, Sq, Hq, D) f32 whatever the dtype.  Any window
// >= 1: a row that sees no key of the block gets O = 0 and lse = -inf.
int flash_fwd_block(int dtype, const void* q, const void* k, const void* v,
                    void* o, void* lse, int batch, int sq, int sk, int hq,
                    int hkv, int d, float scale, int causal, int window,
                    float softcap, int k_off, void* stream) {
  if (bad_shape(d, hq, hkv, sq, sk) || k_off < 0 || window < 1)
    return (int)cudaErrorInvalidValue;
  return run_fwd<true>(dtype, q, k, v, o, static_cast<float*>(lse), batch,
                       sq, sk, hq, hkv, d, scale, causal, window, softcap,
                       k_off, 1, static_cast<cudaStream_t>(stream));
}

// The workspace (floats) flash_fwd_tf32x3 takes at this shape: K's TF32
// lo part (its hi part is K itself) and V^T's hi and lo (positions
// rounded up to 8).
long long flash_fwd_tf32x3_ws_floats(int d, int batch, int sq, int sk,
                                     int hq, int hkv) {
  (void)sq;
  (void)hq;
  return flash_tf32::fwd_ws_floats(d, batch, sk, hkv);
}

// float32 at D 64 and 128 (variant 4): either entry, kb 0 the whole
// sequence (as flash_fwd, k_off 0) or kb 1 the key block at k_off (as
// flash_fwd_block, O f32 either way).  ws 16-byte aligned, at least
// flash_fwd_tf32x3_ws_floats floats (ws_floats says how many it has).
// Three launches: the pre-passes of K and V^T, then the walk.
int flash_fwd_tf32x3(int kb, const void* q, const void* k, const void* v,
                     void* o, void* lse, void* ws, long long ws_floats,
                     int batch, int sq, int sk, int hq, int hkv, int d,
                     float scale, int causal, int window, float softcap,
                     int k_off, void* stream) {
  if (bad_shape(d, hq, hkv, sq, sk) || !flash_tf32::takes(d) ||
      (kb ? (k_off < 0 || window < 1)
          : (k_off != 0 ||
             (long long)sq - (long long)window >= (long long)sk)))
    return (int)cudaErrorInvalidValue;
  auto run = kb ? flash_tf32::run_fwd<true> : flash_tf32::run_fwd<false>;
  return run(q, k, v, o, static_cast<float*>(lse), static_cast<float*>(ws),
             ws_floats, batch, sq, sk, hq, hkv, d, scale, causal, window,
             softcap, k_off, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
