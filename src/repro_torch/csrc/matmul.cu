// Blocked matrix product C = A @ B for any n, m and k: the base case of
// every Strassen leaf (matmul), and the whole of a PACO matmul plan in one
// launch (matmul_plan).
//
// Replaces the TPU kernel repro/kernels/matmul/matmul.py: matmul_pallas
// (body _matmul_kernel), which multiplies (bn, bk) x (bk, bm) VMEM blocks
// on a grid whose innermost axis walks k, accumulates in an f32 scratch
// and flushes once in a.dtype; its blocks must divide the shape.  Here a
// CTA walks all of k of an output tile itself (a CUDA grid runs in no
// order, so the sequential k axis becomes a loop inside the CTA), with
// the same f32 accumulator flushed once in a.dtype.
//
// What bounds it: operations, 2 n m k flops (989 TFLOP/s bf16 on tensor
// cores, 67 TFLOP/s f32 on CUDA cores; f32 stays true f32, not TF32).
//
// matmul_plan: one launch runs every cuboid of a PACO plan, one CTA per
// processor, as the paper's model puts p processors on the machine (p =
// 132 is one CTA per SM; more queue); where k is cut, a second one sums
// the shared outputs.  A CTA walks its processor's
// cuboids in plan order and each cuboid's output tiles row by row, and
// writes each tile's part once:
//  * bf16, when both row strides are multiples of 8 and both bases
//    16-byte aligned (TMA's terms) - variant "wgmma": a producer warp
//    keeps four 48 KB stages of TMA loads in flight (a 128 x 64 box of A,
//    four 64 x 64 boxes of B, from 2-D tensor maps over the whole
//    operands: a cuboid's face is only a coordinate offset; TMA starts a
//    box's row on a 16-byte boundary, so a face's k walk and its tiles'
//    columns start at k0 and m0 rounded down to 8 elements), and two
//    consumer warpgroups each run wgmma m64n256k16 (bf16 in, f32
//    accumulators) on their 64 rows of a 128 x 256 output tile, releasing
//    each stage as its products land, so one tile's epilogue overlaps the
//    next tile's loads; the epilogue passes each warp's rows through
//    shared memory and writes whole 16-byte pieces (4-byte stores of the
//    accumulator fragments cost a third of the walk's time).  TMA
//    zero-fills only past the edges of the whole operand, so on a
//    cuboid's first and last k-steps the consumers zero A's columns
//    before k0 and from k1 in shared memory (a fence.proxy.async later
//    wgmma reads them), and output columns outside the cuboid are not
//    stored;
//  * other bf16 operands - variant "mma_sync": the cp.async + mma.sync
//    body of matmul below on 128 x 128 tiles, every chunk gathered;
//  * float32 - variant "cuda_cores": the f32 body below on 128 x 128
//    tiles.
// Where k is cut, several cuboids share output elements, and paco_matmul
// adds their parts, each rounded to a.dtype, into C in the output dtype
// in plan order.  The kernel does the same, deterministically and
// without atomics: a cuboid that shares outputs writes its part to a
// workspace (rows padded to 8 elements), and a second launch
// (plan_sum_kernel, one CTA per 128 x 256 cell of the shared output)
// adds each element's parts in plan order and writes C once.  Summing in
// the plan kernel instead, by whichever CTA finished a cell's last part,
// left a few CTAs most of the cells of plan_mm_1piece(8192^3, 132) and
// many none: a serial tail several times the products' time (PERF.md).
// The tables (kernels/matmul/matmul.py: plan_table) are built once per
// plan.
//
// matmul (one product, any shape; the Strassen leaves):
//  * bf16 (mm_bf16_kernel): tensor cores, mma.sync m16n8k16 with f32
//    accumulation.  128 x 128 output tile per CTA, 8 warps of 64 x 32
//    (64 x 128 and warps of 32 x 32 when 128-row tiles would give fewer
//    than two CTAs per SM), k in steps of 32 through three shared-memory
//    stages filled by cp.async (two steps' loads in flight while one
//    multiplies), rows padded to an odd number of 16-byte units so that
//    ldmatrix reads them without bank conflicts (the fragment helpers of
//    paged_common.cuh and flash_mma.cuh).  A face starts at any element,
//    so its rows are rarely 16-byte aligned; but when the row strides are
//    multiples of 8 every row has the same 16-byte phase, and the walk
//    starts k and the output columns that many elements early
//    (zero-filled, never stored): then every whole 16-byte chunk is
//    aligned and goes by cp.async, and only ragged chunks at the edges are
//    gathered element by element.  Other strides gather every chunk.
//  * float32 (mm_f32_kernel): CUDA cores in true f32.  128 x 128 output
//    tile per CTA, each of 256 threads computes 8 x 8 outputs (two 4 x 4
//    blocks a side, read as 16-byte vectors from shared memory: 4 reads
//    per 64 FMAs), k in steps of 8 through four shared-memory stages
//    filled by 4-byte cp.async (A transposed on the way), three steps in
//    flight.
#include "flash_wgmma.cuh"

namespace {

using namespace paged;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kBM = 128;  // output rows per CTA
constexpr int kBN = 128;  // output columns per CTA

__device__ __forceinline__ void store_one(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store_one(float* p, float x) { *p = x; }

// (x0, x1) -> columns col and col + 1 of a row at p (p points at column
// 0): whichever lies in [0, cols), as one 4-byte store where both do and
// the address allows it.
__device__ __forceinline__ void store_pair(bf16* p, int col, int cols,
                                           float x0, float x1) {
  bf16* q = p + col;
  if (col >= 0 && col + 1 < cols &&
      (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (col >= 0 && col < cols) store_one(q, x0);
    if (col + 1 >= 0 && col + 1 < cols) store_one(q + 1, x1);
  }
}
__device__ __forceinline__ void store_pair(float* p, int col, int cols,
                                           float x0, float x1) {
  if (col >= 0 && col < cols) p[col] = x0;
  if (col + 1 >= 0 && col + 1 < cols) p[col + 1] = x1;
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores (mma.sync)
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

// acc = the (32 MT) x 128 output tile at rows n0 and columns m0 of
// A (n x k, row stride lda) @ B (k x m, row stride ldb), in the mma.sync
// accumulator layout (warp tile 16 MT x 32: rows (wm MT + mt) 16 + g and
// + 8, columns wn 32 + nt 8 + 2 t4 and + 1).  VEC: every row of A and of B
// starts on the same 16-byte phase (lda and ldb multiples of 8); the walk
// then starts k at -a_shift (and the caller the columns at -b_shift), the
// phases in elements, so that every whole chunk it loads is 16-byte
// aligned; the entries before 0 are zero-filled loads.  Returns with every
// cp.async drained; the caller syncs before the stages are reused.
template <bool VEC, int MT>
__device__ __forceinline__ void bf16_tile(unsigned short* a_s,
                                          unsigned short* b_s,
                                          const unsigned short* __restrict__ a,
                                          const unsigned short* __restrict__ b,
                                          int n0, int m0, int n, int m, int k,
                                          long long lda, long long ldb,
                                          int a_shift, float (&acc)[MT][4][4]) {
  constexpr int BM = 32 * MT;  // output rows per CTA: 2 warps x MT x 16
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
}

// The tile of bf16_tile at rows n0, columns m0 -> rows [0, n) and columns
// [0, m) of the row-major matrix at c with row stride ldc.
template <typename T, int MT>
__device__ __forceinline__ void bf16_tile_store(const float (&acc)[MT][4][4],
                                                T* c, long long ldc, int n0,
                                                int m0, int n, int m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  // accumulator fragment: rows g and g + 8, columns 2 t4 and 2 t4 + 1
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = n0 + (wm * MT + mt) * 16 + g + 8 * hh;
      if (row >= n) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        store_pair(c + row * ldc, m0 + wn * 32 + nt * 8 + 2 * t4, m,
                   acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
    }
}

template <bool VEC, int MT>
__global__ void __launch_bounds__(kThreads)
mm_bf16_kernel(const unsigned short* __restrict__ a,
               const unsigned short* __restrict__ b, bf16* __restrict__ c,
               int n, int m, int k, long long lda, long long ldb, int a_shift,
               int b_shift) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned short* a_s = reinterpret_cast<unsigned short*>(smem_raw);
  unsigned short* b_s = a_s + kStages * kAStage;
  const int n0 = blockIdx.y * 32 * MT, m0 = blockIdx.x * kBN - b_shift;
  float acc[MT][4][4];
  bf16_tile<VEC, MT>(a_s, b_s, a, b, n0, m0, n, m, k, lda, ldb, a_shift, acc);
  bf16_tile_store<bf16, MT>(acc, c, m, n0, m0, n, m);
}

// ---------------------------------------------------------------------------
// float32 on CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFK = 8;                         // k per step
constexpr int kFStages = 4;                    // shared-memory buffers
constexpr int kFStride = kBM + 4;              // [k][row], rows 16B-aligned
constexpr int kFLoads = kBM * kFK / kThreads;  // 4 per thread, A and B each
using FStage = float[kFK * kFStride];

// acc = the 128 x 128 output tile at rows n0 and columns m0 of A @ B (A
// n x k with row stride lda, B k x m with row stride ldb): thread
// (tr, tc) = (tid / 16, tid % 16) owns rows 4 tr + {0..3} and
// 64 + 4 tr + {0..3}, and the same columns from tc.  Returns with every
// cp.async drained; the caller syncs before the stages are reused.
__device__ __forceinline__ void f32_tile(FStage* a_s, FStage* b_s,
                                         const float* __restrict__ a,
                                         const float* __restrict__ b, int n0,
                                         int m0, int n, int m, int k,
                                         long long lda, long long ldb,
                                         float (&acc)[8][8]) {
  const int tid = threadIdx.x;
  // per k, two 16-byte reads of A (a warp reads 2 distinct ones,
  // broadcast) and two of B (16 consecutive per warp)
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
}

// The tile of f32_tile at rows n0, columns m0 -> rows [0, n) and columns
// [0, m) of the row-major matrix at c with row stride ldc.
__device__ __forceinline__ void f32_tile_store(const float (&acc)[8][8],
                                               float* c, long long ldc,
                                               int n0, int m0, int n, int m) {
  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = n0 + (i < 4 ? 4 * tr + i : 64 + 4 * tr + i - 4);
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      store_pair(c + row * ldc, m0 + (j < 4 ? 4 * tc + j : 64 + 4 * tc + j - 4),
                 m, acc[i][j], acc[i][j + 1]);
  }
}

__global__ void __launch_bounds__(kThreads)
mm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ c, int n, int m, int k, long long lda,
              long long ldb) {
  __shared__ __align__(16) FStage a_s[kFStages];  // [k][row]
  __shared__ __align__(16) FStage b_s[kFStages];  // [k][col]
  const int n0 = blockIdx.y * kBM, m0 = blockIdx.x * kBN;
  float acc[8][8];
  f32_tile(a_s, b_s, a, b, n0, m0, n, m, k, lda, ldb, acc);
  f32_tile_store(acc, c, m, n0, m0, n, m);
}

// ---------------------------------------------------------------------------
// matmul_plan: a PACO plan in one launch
// ---------------------------------------------------------------------------

// The plan's tables, built on the host once per plan (kernels/matmul/
// matmul.py: plan_table).  Cuboids are numbered in walk order (empty ones
// dropped), processor by processor.
struct Plan {
  const int* proc_off;      // CTA i walks cuboids [proc_off[i], proc_off[i+1])
  const int* cub;           // per cuboid: n0, n1, m0, m1, k0, k1, ws row
                            // stride, 0
  const long long* ws_off;  // per cuboid: its part's workspace offset, or -1
                            // when it shares no output (written to C)
  const int* cell;          // per cell: r0, r1, c0, c1, first member,
                            // members, 0, 0
  const int* cell_mem;      // a cell's members: cuboids, in plan order
};

struct Cub {
  int n0, n1, m0, m1, k0, k1, ld;
};

__device__ __forceinline__ Cub cub_at(const Plan& pl, int i) {
  const int* c = pl.cub + 8 * i;
  return {c[0], c[1], c[2], c[3], c[4], c[5], c[6]};
}

// Where a cuboid's part goes, pointing at its column m0: C (at the
// cuboid's corner, row stride m) or its slice of the workspace, whose rows
// start at m0 rounded down to a multiple of 8 and are ld long (a multiple
// of 8), so that the sum pass reads them in 16-byte pieces.
template <typename T>
struct Dest {
  T* p;
  long long ld;
};

template <typename T>
__device__ __forceinline__ Dest<T> dest_of(const Plan& pl, int i,
                                           const Cub& q, T* c, T* ws,
                                           int m) {
  const long long off = pl.ws_off[i];
  if (off < 0) return {c + (long long)q.n0 * m + q.m0, m};
  return {ws + off + q.m0 % 8, q.ld};
}

// x + y rounded to T, as a T addition rounds it.
__device__ __forceinline__ float add_in(bf16*, float x, float y) {
  return __bfloat162float(__float2bfloat16(x + y));
}
__device__ __forceinline__ float add_in(float*, float x, float y) {
  return x + y;
}

// Eight consecutive elements of T (16-byte aligned) widened to float, and
// eight floats narrowed to T and stored.
__device__ __forceinline__ void load8(const bf16* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) x[e] = __bfloat162float(v[e]);
}
__device__ __forceinline__ void load8(const float* p, float* x) {
  *reinterpret_cast<float4*>(x) = *reinterpret_cast<const float4*>(p);
  *reinterpret_cast<float4*>(x + 4) = *reinterpret_cast<const float4*>(p + 4);
}
__device__ __forceinline__ void store8(bf16* p, const float* x) {
  uint4 raw;
  __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void store8(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(x);
  *reinterpret_cast<float4*>(p + 4) = *reinterpret_cast<const float4*>(x + 4);
}

// The k-cuts' sums, one CTA of kSumThreads per cell (a block of the
// output no larger than kCellRows x kCellCols inside one aligned
// kCellCols-column band): per element, the parts of the members that
// cover it, added in plan order in T (the first taken as it is), -> C.
// Thread t takes the 8 columns 8 (t % 32) of the band and every eighth
// row from t / 32; it loads kSumBatch members' 8 values of a row before
// it adds any, so that their loads are in flight together, and keeps few
// registers, so that three CTAs share an SM.
constexpr int kCellRows = 128, kCellCols = 256, kSumThreads = 256;
constexpr int kSumBatch = 4;

template <typename T>
__global__ void __launch_bounds__(kSumThreads, 3)
plan_sum_kernel(const T* __restrict__ ws, T* __restrict__ c, const Plan pl,
                int m) {
  const int* cl = pl.cell + 8 * blockIdx.x;
  const int r0 = cl[0], r1 = cl[1], c0 = cl[2], c1 = cl[3];
  const int* mem = pl.cell_mem + cl[4];
  const int n_mem = cl[5];
  const int col0 = c0 - c0 % kCellCols + 8 * (threadIdx.x % 32);
  if (col0 + 8 <= c0 || col0 >= c1) return;
  for (int row = r0 + threadIdx.x / 32; row < r1; row += kSumThreads / 32) {
    float v[8];
    unsigned seen = 0;
    for (int j0 = 0; j0 < n_mem; j0 += kSumBatch) {
      float x[kSumBatch][8];
      int lo[kSumBatch], hi[kSumBatch];
#pragma unroll
      for (int b = 0; b < kSumBatch; ++b) {
        lo[b] = 8;   // nothing of this member in the row's 8 columns
        hi[b] = 0;
        if (j0 + b >= n_mem) continue;
        const Cub q = cub_at(pl, mem[j0 + b]);
        if (row < q.n0 || row >= q.n1) continue;
        lo[b] = max(max(c0, q.m0) - col0, 0);
        hi[b] = min(min(c1, q.m1) - col0, 8);
        if (lo[b] >= hi[b]) continue;
        load8(ws + pl.ws_off[mem[j0 + b]] + (col0 - (q.m0 - q.m0 % 8)) +
                  (long long)(row - q.n0) * q.ld,
              x[b]);
      }
#pragma unroll
      for (int b = 0; b < kSumBatch; ++b)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (e < lo[b] || e >= hi[b]) continue;
          v[e] = (seen >> e & 1) ? add_in(c, v[e], x[b][e]) : x[b][e];
          seen |= 1u << e;
        }
    }
    T* dst = c + (long long)row * m + col0;
    if (seen == 0xffu &&
        reinterpret_cast<uintptr_t>(dst) % (8 * sizeof(T)) == 0) {
      store8(dst, v);
      continue;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (seen >> e & 1) store_one(dst + e, v[e]);
  }
}

// ---- variant "wgmma": bf16 through TMA and wgmma

constexpr int kWM = 128, kWN = 256, kWK = 64, kWStages = 4;
constexpr int kWThreads = 384;   // two consumer warpgroups and a producer
constexpr int kWConsumers = 256;
constexpr int kWAStage = kWM * kWK * 2;   // 16 KB: a 128 x 64 box of A
constexpr int kWBBlock = kWK * 64 * 2;    // 8 KB: a 64 x 64 box of B
constexpr int kWStage = kWAStage + 4 * kWBBlock;
// Each consumer warp stages its 16 rows of a tile's part, 128 columns at a
// time, on the way out: 8 warps x 16 rows x 256 bytes after the stages.
constexpr int kWStg = kWStages * kWStage;
constexpr int kWBar = kWStg + 8 * 16 * 256;  // full, then empty barriers
constexpr size_t kWSmem = kWBar + 16 * kWStages + 1024;  // + alignment
constexpr int kWProducerRegs = 40, kWConsumerRegs = 232;
// TMA takes a box whose first column starts on a 16-byte boundary: a
// cuboid's k walk and its tiles' columns start at k0 and m0 rounded down to
// a multiple of 8 elements (the columns before k0 are zeroed like those
// past k1; the output columns before m0 are not stored).
constexpr int kTmaAlign = 8;

// Columns outside [lo, hi) of this warpgroup's 64 rows of an A stage -> 0.
// The stage is TMA's 128-byte swizzle: row r's 16-byte chunk j sits at
// r * 128 + (j ^ (r % 8)) * 16.  t: the thread's index in its warpgroup.
__device__ __forceinline__ void zero_a_outside(unsigned char* a_stage, int wg,
                                               int lo, int hi, int t) {
#pragma unroll
  for (int i = t; i < 64 * 8; i += 128) {
    const int row = 64 * wg + (i >> 3), j = i & 7, e0 = 8 * j;
    unsigned char* chunk = a_stage + row * 128 + ((j ^ (row & 7)) << 4);
    if (e0 + 8 <= lo || e0 >= hi) {
      *reinterpret_cast<uint4*>(chunk) = make_uint4(0, 0, 0, 0);
    } else if (e0 < lo || e0 + 8 > hi) {
      unsigned short* e = reinterpret_cast<unsigned short*>(chunk);
      for (int x = 0; x < 8; ++x)
        if (e0 + x < lo || e0 + x >= hi) e[x] = 0;
    }
  }
}

__global__ void __launch_bounds__(kWThreads, 1)
plan_wgmma_kernel(const __grid_constant__ CUtensorMap a_map,
                  const __grid_constant__ CUtensorMap b_map,
                  bf16* __restrict__ c, bf16* __restrict__ ws, const Plan pl,
                  int m) {
  using namespace flash_wgmma;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full = base + kWBar, empty = full + 8 * kWStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWConsumers / 32);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int c_lo = pl.proc_off[blockIdx.x], c_hi = pl.proc_off[blockIdx.x + 1];
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: one thread issues every load
    regs_dealloc<kWProducerRegs>();
    if (threadIdx.x != kWConsumers) return;
    prefetch_map(&a_map);
    prefetch_map(&b_map);
    int stage = 0;
    uint32_t phase = 0;
    for (int ci = c_lo; ci < c_hi; ++ci) {
      const Cub q = cub_at(pl, ci);
      const int m_al = q.m0 - q.m0 % kTmaAlign, k_al = q.k0 - q.k0 % kTmaAlign;
      const int tm = (q.m1 - m_al + kWN - 1) / kWN;
      const int tiles = (q.n1 - q.n0 + kWM - 1) / kWM * tm;
      for (int t = 0; t < tiles; ++t) {
        const int row0 = q.n0 + (t / tm) * kWM, col0 = m_al + (t % tm) * kWN;
        for (int kb = k_al; kb < q.k1; kb += kWK) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          mbar_expect_tx(full + 8 * stage, kWStage);
          const uint32_t st = base + stage * kWStage;
          tma_load_2d(st, &a_map, full + 8 * stage, kb, row0);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load_2d(st + kWAStage + j * kWBBlock, &b_map,
                        full + 8 * stage, col0 + 64 * j, kb);
          if (++stage == kWStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg holds rows 64 wg .. 64 wg + 63 of a tile
  regs_alloc<kWConsumerRegs>();
  const int tid = threadIdx.x;   // 0 .. 255
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  float acc[128];
  for (int ci = c_lo; ci < c_hi; ++ci) {
    const Cub q = cub_at(pl, ci);
    const int nc = q.n1 - q.n0, mc = q.m1 - q.m0;
    const int m_al = q.m0 - q.m0 % kTmaAlign, k_al = q.k0 - q.k0 % kTmaAlign;
    const int tm = (q.m1 - m_al + kWN - 1) / kWN;
    const int tiles = (nc + kWM - 1) / kWM * tm;
    const Dest<bf16> d = dest_of(pl, ci, q, c, ws, m);
    for (int t = 0; t < tiles; ++t) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      int held = -1;   // the stage whose products may still be in flight
      for (int kb = k_al; kb < q.k1; kb += kWK) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t sa = base + stage * kWStage;
        if (kb < q.k0 || q.k1 - kb < kWK) {   // A's columns outside k0, k1
          zero_a_outside(gen + stage * kWStage, wg, q.k0 - kb, q.k1 - kb,
                         tid & 127);
          fence_proxy_async();
          bar_sync(2 + wg, 128);
        }
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < kWK / 16; ++ks)
          mma_ss_n256_tb(acc, desc_k(sa, kWM, 64 * wg, ks),
                         desc_mn(sa + kWAStage, kWK, ks));
        wg_commit();
        wg_wait<1>();   // the previous step's products have landed
        if (held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);
        held = stage;
        if (++stage == kWStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_wait<0>();
      fence_regs<128>(acc);
      if (held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);

      const int rt = (t / tm) * kWM, ct = m_al - q.m0 + (t % tm) * kWN;
      // The part leaves through the warp's staging rows, 128 columns at a
      // time: the accumulator fragments go in as bf16 pairs, whole 16-byte
      // pieces of a row come out, so each row's columns are written in
      // full 32-byte sectors where the cuboid and the address allow (the
      // 16-byte unit j of row r sits at unit j ^ (r % 8): no bank conflicts
      // on either side).
      unsigned char* stg = gen + kWStg + (4 * wg + warp) * 16 * 256;
      const int row0 = rt + 64 * wg + 16 * warp;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int r = g + 8 * hh, nt = 16 * half + j;
            *reinterpret_cast<__nv_bfloat162*>(
                stg + r * 256 + ((j ^ (r & 7)) << 4) + 4 * t4) =
                __floats2bfloat162_rn(acc[4 * nt + 2 * hh],
                                      acc[4 * nt + 2 * hh + 1]);
          }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = 2 * i + (lane >> 4), unit = lane & 15;
          const int row = row0 + r, col = ct + 128 * half + 8 * unit;
          if (row >= nc) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(
              stg + r * 256 + ((unit ^ (r & 7)) << 4));
          bf16* dst = d.p + row * d.ld + col;
          if (col >= 0 && col + 8 <= mc &&
              (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
            *reinterpret_cast<uint4*>(dst) = v;
          } else {
            const bf16* x = reinterpret_cast<const bf16*>(&v);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (col + e >= 0 && col + e < mc) dst[e] = x[e];
          }
        }
        __syncwarp();
      }
    }
  }
}

// ---- variants "mma_sync" (bf16) and "cuda_cores" (float32): 256 threads
// walk the plan's tiles of 128 x 128 with the bodies of matmul.

__global__ void __launch_bounds__(kThreads)
plan_mma_kernel(const unsigned short* __restrict__ a,
                const unsigned short* __restrict__ b, bf16* __restrict__ c,
                bf16* __restrict__ ws, const Plan pl, long long lda,
                long long ldb, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned short* a_s = reinterpret_cast<unsigned short*>(smem_raw);
  unsigned short* b_s = a_s + kStages * kAStage;
  for (int ci = pl.proc_off[blockIdx.x]; ci < pl.proc_off[blockIdx.x + 1];
       ++ci) {
    const Cub q = cub_at(pl, ci);
    const int nc = q.n1 - q.n0, mc = q.m1 - q.m0;
    const int tm = (mc + kBN - 1) / kBN;
    const int tiles = (nc + kBM - 1) / kBM * tm;
    const Dest<bf16> d = dest_of(pl, ci, q, c, ws, m);
    const unsigned short* ac = a + q.n0 * lda + q.k0;
    const unsigned short* bc = b + q.k0 * ldb + q.m0;
    for (int t = 0; t < tiles; ++t) {
      const int n0 = (t / tm) * kBM, m0 = (t % tm) * kBN;
      float acc[4][4][4];
      bf16_tile<false, 4>(a_s, b_s, ac, bc, n0, m0, nc, mc, q.k1 - q.k0, lda,
                          ldb, 0, acc);
      bf16_tile_store<bf16, 4>(acc, d.p, d.ld, n0, m0, nc, mc);
      __syncthreads();   // the stages are the next tile's
    }
  }
}

__global__ void __launch_bounds__(kThreads)
plan_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, float* __restrict__ ws, const Plan pl,
                long long lda, long long ldb, int m) {
  __shared__ __align__(16) FStage a_s[kFStages];
  __shared__ __align__(16) FStage b_s[kFStages];
  for (int ci = pl.proc_off[blockIdx.x]; ci < pl.proc_off[blockIdx.x + 1];
       ++ci) {
    const Cub q = cub_at(pl, ci);
    const int nc = q.n1 - q.n0, mc = q.m1 - q.m0;
    const int tm = (mc + kBN - 1) / kBN;
    const int tiles = (nc + kBM - 1) / kBM * tm;
    const Dest<float> d = dest_of(pl, ci, q, c, ws, m);
    const float* ac = a + q.n0 * lda + q.k0;
    const float* bc = b + q.k0 * ldb + q.m0;
    for (int t = 0; t < tiles; ++t) {
      const int n0 = (t / tm) * kBM, m0 = (t % tm) * kBN;
      float acc[8][8];
      f32_tile(a_s, b_s, ac, bc, n0, m0, nc, mc, q.k1 - q.k0, lda, ldb, acc);
      f32_tile_store(acc, d.p, d.ld, n0, m0, nc, mc);
      __syncthreads();   // the stages are the next tile's
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

extern "C" {

// The plan variants, numbered as the wrapper's PLAN_VARIANTS.
enum { kPlanCudaCores = 0, kPlanMmaSync = 1, kPlanWgmma = 2 };

// The output tile a variant walks, and the cells of the output whose
// parts are summed together: the wrapper builds its tables for them.
int matmul_plan_tile_rows(int variant) {
  return variant == kPlanWgmma ? kWM : kBM;
}
int matmul_plan_tile_cols(int variant) {
  return variant == kPlanWgmma ? kWN : kBN;
}
int matmul_plan_cell_rows() { return kCellRows; }
int matmul_plan_cell_cols() { return kCellCols; }

// Every cuboid of a plan, one CTA per processor (n_ctas of them), then,
// when cuboids share outputs (n_cells > 0), the sums of their parts.
// dtype 0 = float32 (variant 0), 1 = bfloat16 (variant 1, or 2 when TMA
// takes the operands: row strides multiples of 8, bases 16-byte aligned).
// a (n, k) row stride lda, b (k, m) row stride ldb, c (n, m) contiguous;
// ws: the parts of the cuboids that share outputs; the table pointers as
// Plan says.  Returns the CUDA error of the launches.
int matmul_plan(int dtype, int variant, const void* a, const void* b,
                void* c, void* ws, const int* proc_off, const int* cub,
                const long long* ws_off, const int* cell, const int* cell_mem,
                int n_ctas, int n_cells, int n, int m, int k, long long lda,
                long long ldb, void* stream) {
  if (n_ctas < 1 || n_cells < 0 || n < 1 || m < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl{proc_off, cub, ws_off, cell, cell_mem};
  if (dtype == 1 && variant == kPlanWgmma) {
    if (lda % 8 || ldb % 8 || (uintptr_t)a % 16 || (uintptr_t)b % 16)
      return (int)cudaErrorInvalidValue;
    // setmaxnreg moves registers from the producer to the consumers on
    // the assumption that each of the 384 threads got 168
    static int regs = -1;
    if (regs < 0) {
      cudaFuncAttributes fa;
      const cudaError_t e = cudaFuncGetAttributes(&fa, plan_wgmma_kernel);
      if (e != cudaSuccess) return (int)e;
      regs = fa.numRegs;
    }
    if (regs != 168) return (int)cudaErrorInvalidConfiguration;
    static size_t opted = 48 * 1024;
    const cudaError_t e = allow_smem(plan_wgmma_kernel, kWSmem, &opted);
    if (e != cudaSuccess) return (int)e;
    CUtensorMap am, bm;
    if (!flash_wgmma::map_2d(&am, a, n, k, lda, kWM) ||
        !flash_wgmma::map_2d(&bm, b, k, m, ldb, kWK))
      return (int)cudaErrorInvalidValue;
    plan_wgmma_kernel<<<n_ctas, kWThreads, kWSmem, st>>>(
        am, bm, static_cast<bf16*>(c), static_cast<bf16*>(ws), pl, m);
  } else if (dtype == 1 && variant == kPlanMmaSync) {
    static size_t opted = 48 * 1024;
    const cudaError_t e = allow_smem(plan_mma_kernel, kBf16Smem, &opted);
    if (e != cudaSuccess) return (int)e;
    plan_mma_kernel<<<n_ctas, kThreads, kBf16Smem, st>>>(
        static_cast<const unsigned short*>(a),
        static_cast<const unsigned short*>(b), static_cast<bf16*>(c),
        static_cast<bf16*>(ws), pl, lda, ldb, m);
  } else if (dtype == 0 && variant == kPlanCudaCores) {
    plan_f32_kernel<<<n_ctas, kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), static_cast<float*>(ws), pl, lda, ldb, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_cells == 0) return (int)e;
  if (dtype == 1)
    plan_sum_kernel<bf16><<<n_cells, kSumThreads, 0, st>>>(
        static_cast<const bf16*>(ws), static_cast<bf16*>(c), pl, m);
  else
    plan_sum_kernel<float><<<n_cells, kSumThreads, 0, st>>>(
        static_cast<const float*>(ws), static_cast<float*>(c), pl, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
