// Blocked matrix product C = A @ B for any n, m and k: the base case of
// every PACO matmul cuboid and Strassen leaf.
//
// Replaces the TPU kernel repro/kernels/matmul/matmul.py: matmul_pallas
// (body _matmul_kernel), which multiplies (bn, bk) x (bk, bm) VMEM blocks
// on a grid whose innermost axis walks k, accumulates in an f32 scratch
// and flushes once in a.dtype; its blocks must divide the shape.  Here one
// CTA owns one output tile and walks all of k itself (a CUDA grid runs in
// no order, so the sequential k axis becomes a loop inside the CTA), with
// the same f32 accumulator flushed once in a.dtype.
//
// Any shape: the PACO planner cuts n, m and k by arbitrary processor
// ratios (plan_mm_1piece(8192, 8192, 8192, 132) gives cuboids such as
// 1024 x 2048 x 1985, with no side divisible by 8), so every load is
// predicated and zero-fills past the ragged edge, and every store is
// predicated.  A and B come with a row stride each (lda, ldb), so a
// cuboid's faces a[n0:n1, k0:k1] and b[k0:k1, m0:m1] are read in place.
//
// What bounds it: operations, 2 n m k flops.
//  * bf16 (mm_bf16_kernel): tensor cores, mma.sync m16n8k16 with f32
//    accumulation (989 TFLOP/s peak).  128 x 128 output tile per CTA,
//    8 warps of 64 x 32 (64 x 128 and warps of 32 x 32 when 128-row tiles
//    would give fewer than two CTAs per SM, as one PACO cuboid of 8192^3
//    at p = 132 does), k in steps of 32 through three shared-memory
//    stages filled by cp.async (two steps' loads in flight while one
//    multiplies), rows padded to an odd number of 16-byte units so that
//    ldmatrix reads them without bank conflicts (the fragment helpers of
//    paged_common.cuh and flash_mma.cuh).  A cuboid's face starts at any
//    element, so its rows are rarely 16-byte aligned; but when the row
//    strides are multiples of 8 every row has the same 16-byte phase, and
//    the walk starts k and the output columns that many elements early
//    (zero-filled, never stored): then every whole 16-byte chunk is
//    aligned and goes by cp.async, and only ragged chunks at the edges are
//    gathered element by element.  Other strides gather every chunk.
//  * float32 (mm_f32_kernel): CUDA cores in true f32 (67 TFLOP/s peak; the
//    f32 checks need f32 arithmetic, not TF32).  128 x 128 output tile per
//    CTA, each of 256 threads computes 8 x 8 outputs (two 4 x 4 blocks a
//    side, read as 16-byte vectors from shared memory: 4 reads per 64
//    FMAs), k in steps of 8 through four shared-memory stages filled by
//    4-byte cp.async (A transposed on the way), three steps in flight.
// Not yet done (later work): wgmma with TMA loads, and a persistent kernel
// with one CTA per PACO processor walking its own cuboid list.
#include "flash_mma.cuh"

namespace {

using namespace paged;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 128;  // output rows per CTA
constexpr int kBN = 128;  // output columns per CTA

// ---------------------------------------------------------------------------
// bf16 on tensor cores
// ---------------------------------------------------------------------------

constexpr int kBK = 32;               // k per step
constexpr int kStages = 3;            // shared-memory buffers in flight
constexpr int kAStride = kBK + 8;     // 40 bf16 = 5 x 16 bytes
constexpr int kBStride = kBN + 8;     // 136 bf16 = 17 x 16 bytes
constexpr int kAStage = kBM * kAStride, kBStage = kBK * kBStride;
constexpr size_t kBf16Smem = sizeof(bf16) * kStages * (kAStage + kBStage);

// Eight consecutive bf16 elements x[0 .. 8) of one row -> 16 bytes of
// shared memory; element e counts when lo <= e < hi (the rest are zero).
// A chunk wholly inside a row whose 16 bytes are aligned goes by cp.async;
// one wholly outside is a zero-fill; a ragged one, or any chunk when the
// operand's rows are not 16-byte aligned, is gathered element by element.
template <bool VEC>
__device__ __forceinline__ void load_chunk(unsigned short* dst,
                                           const unsigned short* x, int lo,
                                           int hi, const void* any) {
  if (lo >= 8 || hi <= 0 || lo >= hi) {
    flash_mma::cp_async16(dst, any, 0);
  } else if (VEC && lo <= 0 && hi >= 8) {
    flash_mma::cp_async16(dst, x, 16);
  } else {
    unsigned short v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (e >= lo && e < hi) ? x[e] : 0;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// VEC: every row of A and of B starts on the same 16-byte phase (lda and
// ldb multiples of 8).  The walk then starts k at -a_shift and the output
// columns at -b_shift, a_shift and b_shift being the phases (in elements)
// of a and b, so that every whole chunk it loads is 16-byte aligned; the
// entries before 0 are zero-filled loads and unstored outputs.
template <bool VEC, int MT>
__global__ void __launch_bounds__(kThreads)
mm_bf16_kernel(const unsigned short* __restrict__ a,
               const unsigned short* __restrict__ b, bf16* __restrict__ c,
               int n, int m, int k, long long lda, long long ldb, int a_shift,
               int b_shift) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned short* a_s = reinterpret_cast<unsigned short*>(smem_raw);
  unsigned short* b_s = a_s + kStages * kAStage;
  constexpr int BM = 32 * MT;  // output rows per CTA: 2 warps x MT x 16
  const int n0 = blockIdx.y * BM, m0 = blockIdx.x * kBN - b_shift;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: 16 MT x 32

  // k-step `step` into stage `buf`: A is BM rows x 4 chunks, B 32 rows x
  // 16 chunks; each thread takes MT / 2 chunks of A and two of B
  auto load = [&](int step, int buf) {
    const int k0 = step * kBK - a_shift;
#pragma unroll
    for (int i = 0; i < MT / 2; ++i) {
      const int q = tid + kThreads * i;
      const int r = q >> 2, kc = (q & 3) * 8;
      const int gr = n0 + r, gk = k0 + kc;
      load_chunk<VEC>(a_s + buf * kAStage + r * kAStride + kc,
                      a + gr * lda + gk, -gk, gr < n ? k - gk : 0, a);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + kThreads * i;
      const int r = q >> 4, cc = (q & 15) * 8;
      const int gk = k0 + r, gc = m0 + cc;
      load_chunk<VEC>(b_s + buf * kBStage + r * kBStride + cc,
                      b + gk * ldb + gc, -gc,
                      (gk >= 0 && gk < k) ? m - gc : 0, b);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int n_steps = (k + a_shift + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load(st, st);
    flash_mma::cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    flash_mma::cp_async_wait<kStages - 2>();  // stage `step` has landed
    __syncthreads();  // ... for every thread; and stage step - 1 is free
    const int next = step + kStages - 1;
    if (next < n_steps) load(next, next % kStages);
    flash_mma::cp_async_commit();

    const int buf = step % kStages;
    const unsigned short* as = a_s + buf * kAStage + (wm * 16 * MT) * kAStride;
    const unsigned short* bs = b_s + buf * kBStage + wn * 32;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned af[MT][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[mt], as + (mt * 16 + (lane & 15)) * kAStride + kk +
                            (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned bb[4];
        ldsm_x4_trans(bb, bs + (kk + (lane & 15)) * kBStride + np * 16 +
                              (lane >> 4) * 8);
        bfr[2 * np][0] = bb[0];
        bfr[2 * np][1] = bb[1];
        bfr[2 * np + 1][0] = bb[2];
        bfr[2 * np + 1][1] = bb[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
    }
  }
  flash_mma::cp_async_wait<0>();

  // accumulator fragment: rows g and g + 8, columns 2 t4 and 2 t4 + 1
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = n0 + (wm * MT + mt) * 16 + g + 8 * hh;
      if (row >= n) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = m0 + wn * 32 + nt * 8 + 2 * t4;
        const long long idx = (long long)row * m + col;
        const float x0 = acc[mt][nt][2 * hh], x1 = acc[mt][nt][2 * hh + 1];
        if (col >= 0 && col + 1 < m && (idx & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(c + idx) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          if (col >= 0 && col < m) c[idx] = __float2bfloat16(x0);
          if (col + 1 >= 0 && col + 1 < m) c[idx + 1] = __float2bfloat16(x1);
        }
      }
    }
}

// ---------------------------------------------------------------------------
// float32 on CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFK = 8;                         // k per step
constexpr int kFStages = 4;                    // shared-memory buffers
constexpr int kFStride = kBM + 4;              // [k][row], rows 16B-aligned
constexpr int kFLoads = kBM * kFK / kThreads;  // 4 per thread, A and B each

__global__ void __launch_bounds__(kThreads)
mm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ c, int n, int m, int k, long long lda,
              long long ldb) {
  __shared__ __align__(16) float a_s[kFStages][kFK * kFStride];  // [k][row]
  __shared__ __align__(16) float b_s[kFStages][kFK * kFStride];  // [k][col]
  const int n0 = blockIdx.y * kBM, m0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  // thread (tr, tc) owns rows 4 tr + {0..3} and 64 + 4 tr + {0..3}, and
  // the same columns from tc: per k, two 16-byte reads of A (a warp reads
  // 2 distinct ones, broadcast) and two of B (16 consecutive per warp)
  const int tr = tid >> 4, tc = tid & 15;

  // k-step `step` into stage `buf`, one 4-byte cp.async per element (A
  // transposed on the way), zero-filled past the edges
  auto load = [&](int step, int buf) {
    const int k0 = step * kFK;
#pragma unroll
    for (int i = 0; i < kFLoads; ++i) {
      const int e = tid + kThreads * i;
      const int r = e / kFK, col = e % kFK;  // A: 8 k values of a row
      const int gr = n0 + r, gk = k0 + col;
      const bool ok = gr < n && gk < k;
      flash_mma::cp_async4(a_s[buf] + col * kFStride + r,
                           ok ? a + gr * lda + gk : a, ok ? 4 : 0);
      const int kr = e / kBN, bc = e % kBN;  // B: a row of 128 columns
      const int gk2 = k0 + kr, gc = m0 + bc;
      const bool ok2 = gk2 < k && gc < m;
      flash_mma::cp_async4(b_s[buf] + kr * kFStride + bc,
                           ok2 ? b + gk2 * ldb + gc : b, ok2 ? 4 : 0);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_steps = (k + kFK - 1) / kFK;
#pragma unroll
  for (int st = 0; st < kFStages - 1; ++st) {
    if (st < n_steps) load(st, st);
    flash_mma::cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    flash_mma::cp_async_wait<kFStages - 2>();
    __syncthreads();
    const int next = step + kFStages - 1;
    if (next < n_steps) load(next, next % kFStages);
    flash_mma::cp_async_commit();
    const int buf = step % kFStages;
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float* ak = a_s[buf] + kk * kFStride;
      const float* bk = b_s[buf] + kk * kFStride;
      float av[8], bv[8];
      *reinterpret_cast<float4*>(av) =
          *reinterpret_cast<const float4*>(ak + 4 * tr);
      *reinterpret_cast<float4*>(av + 4) =
          *reinterpret_cast<const float4*>(ak + 64 + 4 * tr);
      *reinterpret_cast<float4*>(bv) =
          *reinterpret_cast<const float4*>(bk + 4 * tc);
      *reinterpret_cast<float4*>(bv + 4) =
          *reinterpret_cast<const float4*>(bk + 64 + 4 * tc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  flash_mma::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = n0 + (i < 4 ? 4 * tr + i : 64 + 4 * tr + i - 4);
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = m0 + (j < 4 ? 4 * tc + j : 64 + 4 * tc + j - 4);
      if (col < m) c[(long long)row * m + col] = acc[i][j];
    }
  }
}

// SMs of the current device, read once.
int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count < 1) count = 1;
  }
  return count;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16.  a (n, k) with row stride lda, b (k, m)
// with row stride ldb, c (n, m) contiguous; n, m >= 1, k >= 0.  Returns the
// CUDA error of the launch (0 when none).
extern "C" int matmul(int dtype, const void* a, const void* b, void* c,
                      int n, int m, int k, long long lda, long long ldb,
                      void* stream) {
  if (n < 1 || m < 1 || k < 0 || (n + kBM / 2 - 1) / (kBM / 2) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const bool vec = lda % 8 == 0 && ldb % 8 == 0;
    // the 16-byte phase of each operand, in elements (bf16 is 2 bytes)
    const int a_shift = vec ? (int)(((uintptr_t)a >> 1) & 7) : 0;
    const int b_shift = vec ? (int)(((uintptr_t)b >> 1) & 7) : 0;
    // 128-row tiles, or 64-row ones when 128-row tiles would give fewer
    // than two CTAs per SM (a PACO cuboid such as 1024 x 2048 makes 128)
    const int cols = (m + b_shift + kBN - 1) / kBN;
    const bool tall = (long long)cols * ((n + kBM - 1) / kBM) >= 2 * sm_count();
    const int bm = tall ? kBM : kBM / 2;
    const dim3 grid(cols, (n + bm - 1) / bm);
    auto kernel = tall ? (vec ? mm_bf16_kernel<true, 4>
                              : mm_bf16_kernel<false, 4>)
                       : (vec ? mm_bf16_kernel<true, 2>
                              : mm_bf16_kernel<false, 2>);
    static size_t opted[2][2] = {{48 * 1024, 48 * 1024},
                                 {48 * 1024, 48 * 1024}};
    const cudaError_t e = allow_smem(kernel, kBf16Smem, &opted[tall][vec]);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, kThreads, kBf16Smem, st>>>(
        static_cast<const unsigned short*>(a),
        static_cast<const unsigned short*>(b), static_cast<bf16*>(c), n, m, k,
        lda, ldb, a_shift, b_shift);
  } else if (dtype == 0) {
    const dim3 grid((m + kBN - 1) / kBN, (n + kBM - 1) / kBM);
    mm_f32_kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), n, m, k, lda, ldb);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
