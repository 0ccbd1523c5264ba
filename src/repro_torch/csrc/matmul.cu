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
// What bounds it: operations, 2 n m k flops at 989 TFLOP/s in bf16; in
// float32, which the tensor cores have only as TF32, three TF32 products
// of 2 n m k flops each at 495 TFLOP/s (against 67 TFLOP/s of true f32 on
// the CUDA cores): each operand split into a TF32 hi and lo part, the
// products A_lo B_hi + A_hi B_lo + A_hi B_hi summed in f32: 1.6e-6 to
// 2.7e-6 of the largest output at k = 8192 on an H100, within MM_TOL
// (1e-5), where one TF32 product errs by 2.5e-4
// (tests/test_torch_paco_kernels.py: the single-pass guard).
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
//  * float32 - variant "wgmma_tf32x3": three TF32 products on wgmma
//    (the section of that name below), 128 x 128 tiles.
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
//  * float32 (matmul_tf32x3): the plan walk's "wgmma_tf32x3" body on the
//    whole product as one cuboid, a persistent grid of at most one CTA per
//    SM taking every gridDim.x-th 128 x 128 tile.
#include "flash_wgmma.cuh"
#include "tf32_wgmma.cuh"

namespace {

using namespace paged;
using namespace tf32x3;   // tf32_rna, split_tf32, mma_tf32_n128
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

// ---- variant "mma_sync" (other bf16): 256 threads walk the plan's tiles
// of 128 x 128 with the body of matmul.

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

// ---- variant "wgmma_tf32x3": float32 as three TF32 products on wgmma
//
// Each operand element is split into a TF32 hi and lo part and each
// product takes three TF32 products, A_lo B_hi + A_hi B_lo + A_hi B_hi
// (tf32_wgmma.cuh, shared with the flash pair's float32 family, says how).
// wgmma takes TF32 operands K-major only, so a pre-pass
// (split_bt_kernel) writes B^T's hi and lo parts, (m x kp) each, kp = k
// rounded up to 4 (TMA's 16-byte row pitch), into the caller's workspace;
// A (n x k, K-major as it is) streams at f32 size through TMA where its row
// stride is a multiple of 4 and its base 16-byte aligned (else
// pad_a_kernel copies it into the workspace first) and is split in
// registers, where wgmma takes it.  A CTA of two consumer warpgroups and a
// producer warp walks 128 x 128 output tiles (each warpgroup 64 rows: one
// m64n128k8 product per k8 slice and part) in k-steps of 32 through four
// 48 KB stages (a 128 x 32 box of A, a 128 x 32 box each of B^T's hi and
// lo, TMA's 128-byte swizzle).  The tensor cores' accumulator truncates:
// summed over all of k in one accumulator, the three products drifted by
// 1.5e-5 of the largest output at 2048^3 and 5.8e-5 at k = 8192 (linear
// in k), past MM_TOL.  So wgmma sums each kTPromote k-steps (128 of k)
// from zero, and that sum is added into a second f32 accumulator with
// rounded adds (~2e-6 of the largest output at k = 8192; after every
// k-step, ~1.4e-6 but 10% slower on an H100); that second set of
// registers is why a warpgroup takes 64 rows, not 128.
// A k-step of a cuboid starts at k0 rounded down to 4 elements (a box
// starts a row on a 16-byte boundary) and A's columns outside [k0, k1) are
// zeroed as they are split, hi and lo both.  What bounds it: per k, a tile
// loads 128 x 4 bytes of A and 128 x 8 of B^T for 3 x 2 x 128 x 128 TF32
// flops, 64 flops a byte from L2 against 495 TFLOP/s.  The split costs a
// cvt, a subtraction and a cvt an element of A, on the CUDA cores beside
// the products.

constexpr int kTM = 128, kTN = 128, kTK = 32, kTStages = 4;
constexpr int kTAStage = kTM * kTK * 4;          // 16 KB: A, f32
constexpr int kTBBox = kTN * kTK * 4;            // 16 KB: B^T's hi or lo
constexpr int kTStage = kTAStage + 2 * kTBBox;   // 48 KB
constexpr int kTBar = kTStages * kTStage;        // full, then empty barriers
constexpr size_t kTSmem = kTBar + 16 * kTStages + 1024;  // + alignment
constexpr int kTKAlign = 4;   // a TMA box starts a row on 16 bytes
constexpr int kTPromote = 4;  // k-steps wgmma sums before the f32 total

// B (k x m, row stride ldb) -> B^T's hi and lo parts, (m x kp) each,
// zero in columns [k, kp): a 32 x 32 block a CTA, through shared memory
// so that both the reads and the writes are whole rows of 128 bytes.
__global__ void __launch_bounds__(256)
split_bt_kernel(const float* __restrict__ b, long long ldb, int k, int m,
                int kp, float* __restrict__ hi, float* __restrict__ lo) {
  __shared__ float blk[32][33];
  const int k0 = blockIdx.x * 32, m0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int r = ty; r < 32; r += 8) {
    const int kk = k0 + r, mm = m0 + tx;
    blk[r][tx] = (kk < k && mm < m) ? b[kk * ldb + mm] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int mm = m0 + r, kk = k0 + tx;
    if (mm >= m || kk >= kp) continue;
    uint32_t h, l;
    split_tf32(blk[tx][r], h, l);
    hi[(long long)mm * kp + kk] = __uint_as_float(h);
    lo[(long long)mm * kp + kk] = __uint_as_float(l);
  }
}

// A (n x k, row stride lda) -> (n x kp) contiguous, zero in [k, kp): for
// an A that TMA cannot read in place.
__global__ void __launch_bounds__(256)
pad_a_kernel(const float* __restrict__ a, long long lda, int n, int k,
             int kp, float* __restrict__ out) {
  const long long total = (long long)n * kp;
  for (long long i = blockIdx.x * 256ll + threadIdx.x; i < total;
       i += (long long)gridDim.x * 256) {
    const long long r = i / kp;
    const int c = (int)(i - r * kp);
    out[i] = c < k ? a[r * lda + c] : 0.f;
  }
}

// The walk.  Plan mode (pl.proc_off set): CTA i walks its processor's
// cuboids in plan order and each cuboid's tiles row by row.  Single mode
// (pl.proc_off null; matmul): one cuboid, the whole (n, m, k) product
// into C, CTA i taking tiles i, i + gridDim.x, ...
__global__ void __launch_bounds__(kWThreads, 1)
plan_tf32x3_kernel(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap hi_map,
                   const __grid_constant__ CUtensorMap lo_map,
                   float* __restrict__ c, float* __restrict__ ws,
                   const Plan pl, int n, int m, int k) {
  using namespace flash_wgmma;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full = base + kTBar, empty = full + 8 * kTStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kWConsumers / 32);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const bool single = pl.proc_off == nullptr;
  const int c_lo = single ? 0 : pl.proc_off[blockIdx.x];
  const int c_hi = single ? 1 : pl.proc_off[blockIdx.x + 1];
  const int t0 = single ? blockIdx.x : 0, t_step = single ? gridDim.x : 1;
  auto cuboid = [&](int ci) {
    return single ? Cub{0, n, 0, m, 0, k, m} : cub_at(pl, ci);
  };
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    // ---- producer: one thread issues every load
    regs_dealloc<kWProducerRegs>();
    if (threadIdx.x != kWConsumers) return;
    prefetch_map(&a_map);
    prefetch_map(&hi_map);
    prefetch_map(&lo_map);
    int stage = 0;
    uint32_t phase = 0;
    for (int ci = c_lo; ci < c_hi; ++ci) {
      const Cub q = cuboid(ci);
      const int k_al = q.k0 - q.k0 % kTKAlign;
      const int tm = (q.m1 - q.m0 + kTN - 1) / kTN;
      const int tiles = (q.n1 - q.n0 + kTM - 1) / kTM * tm;
      for (int t = t0; t < tiles; t += t_step) {
        const int row0 = q.n0 + (t / tm) * kTM, col0 = q.m0 + (t % tm) * kTN;
        for (int kb = k_al; kb < q.k1; kb += kTK) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, kTStage);
          const uint32_t st = base + stage * kTStage;
          tma_load_2d(st, &a_map, bar, kb, row0);
          tma_load_2d(st + kTAStage, &hi_map, bar, kb, col0);
          tma_load_2d(st + kTAStage + kTBBox, &lo_map, bar, kb, col0);
          if (++stage == kTStages) {
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
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  float acc[64];   // up to kTPromote k-steps' products (wgmma)
  float tot[64];   // the tile's sum (rounded f32 adds)
  // A's parts of a k8 slice, two slices in flight: [slice & 1][hi 0-3,
  // lo 4-7]
  uint32_t fr[2][8];
  for (int ci = c_lo; ci < c_hi; ++ci) {
    const Cub q = cuboid(ci);
    const int nc = q.n1 - q.n0, mc = q.m1 - q.m0;
    const int k_al = q.k0 - q.k0 % kTKAlign;
    const int tm = (mc + kTN - 1) / kTN;
    const int tiles = (nc + kTM - 1) / kTM * tm;
    const Dest<float> d =
        single ? Dest<float>{c, m} : dest_of(pl, ci, q, c, ws, m);
    for (int t = t0; t < tiles; t += t_step) {
#pragma unroll
      for (int j = 0; j < 64; ++j) tot[j] = 0.f;
      int held = -1;   // the stage whose products may still be in flight
      int steps = 0;   // k-steps in acc since it was last added to tot
      for (int kb = k_al; kb < q.k1; kb += kTK) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t sb = base + stage * kTStage + kTAStage;
        const float* as =
            reinterpret_cast<const float*>(gen + stage * kTStage);
        // A's columns kept: [lo_k, hi_k) of this step's 32
        const int lo_k = q.k0 - kb, hi_k = q.k1 - kb;
        const bool edge = lo_k > 0 || hi_k < kTK;
#pragma unroll
        for (int s = 0; s < kTK / 8; ++s) {
          uint32_t (&f)[8] = fr[s & 1];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // row r's 16-byte unit j sits at unit j ^ (r % 8) (TMA's
            // 128-byte swizzle): a warp's 32 reads hit 32 banks
            const int r = 64 * wg + 16 * warp + g + 8 * (e & 1);
            const int col = 8 * s + t4 + 4 * (e >> 1);
            float x = as[r * kTK + (((col >> 2) ^ (r & 7)) << 2) + (col & 3)];
            if (edge && (col < lo_k || col >= hi_k)) x = 0.f;
            split_tf32(x, f[e], f[4 + e]);
          }
          wg_fence();
          const uint64_t dhi = desc_k(sb, kTN, 0, s);
          const uint64_t dlo = desc_k(sb + kTBBox, kTN, 0, s);
          mma_tf32_n128(acc, f + 4, dhi, s > 0 || steps > 0);   // A_lo B_hi
          mma_tf32_n128(acc, f, dlo, 1);           // A_hi B_lo
          mma_tf32_n128(acc, f, dhi, 1);           // A_hi B_hi
          wg_commit();
          wg_wait<1>();   // the previous slice's products have landed
          if (s == 0 && held >= 0) {
            if (lane == 0) mbar_arrive(empty + 8 * held);
            held = -1;
          }
        }
        if (++steps == kTPromote || kb + kTK >= q.k1) {
          wg_wait<0>();
          fence_regs<64>(acc);
          if (lane == 0) mbar_arrive(empty + 8 * stage);
#pragma unroll
          for (int j = 0; j < 64; ++j) tot[j] += acc[j];
          steps = 0;
        } else {
          held = stage;
        }
        if (++stage == kTStages) {
          stage = 0;
          phase ^= 1;
        }
      }

      // f32 pairs straight from the sums: a warp's store covers 8 rows x
      // 32 bytes, whole sectors
      const int rt = (t / tm) * kTM, ct = (t % tm) * kTN;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = rt + 64 * wg + 16 * warp + g + 8 * hh;
        if (row >= nc) continue;
        float* dst = d.p + (long long)row * d.ld;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          const int col = ct + 8 * nt + 2 * t4;
          const float x0 = tot[4 * nt + 2 * hh], x1 = tot[4 * nt + 2 * hh + 1];
          float* p = dst + col;
          if (col + 1 < mc && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
            *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
          } else {
            if (col < mc) p[0] = x0;
            if (col + 1 < mc) p[1] = x1;
          }
        }
      }
    }
  }
}

// A (rows x cols f32, row stride ld) as a 2-D tensor map, boxes of 32
// columns (128 bytes) x box_rows rows, 128-byte swizzle.
bool map_f32(CUtensorMap* map, const void* p, int rows, int cols,
             long long ld, int box_rows) {
  const flash_wgmma::EncodeTiled enc = flash_wgmma::encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kTK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA reads A in place when its rows are 16-byte aligned.
bool a_in_place(const void* a, long long lda) {
  return lda % 4 == 0 && (uintptr_t)a % 16 == 0;
}

long long split_floats(int n, int m, int k, long long lda, const void* a) {
  const long long kp = (k + 3) / 4 * 4;
  return 2 * kp * m + (a_in_place(a, lda) ? 0 : kp * n);
}

// The pre-passes into ws (B^T's hi and lo parts, then A padded where TMA
// cannot read it in place), the three maps, and the walk's launch checks.
// Returns the CUDA error (0 when none).
int tf32x3_prepare(const void* a, const void* b, float* ws,
                   long long ws_floats, int n, int m, int k, long long lda,
                   long long ldb, cudaStream_t st, CUtensorMap* am,
                   CUtensorMap* him, CUtensorMap* lom) {
  if (ws == nullptr || ws_floats < split_floats(n, m, k, lda, a) ||
      (uintptr_t)ws % 16)
    return (int)cudaErrorInvalidValue;
  // setmaxnreg moves registers from the producer to the consumers on the
  // assumption that each of the 384 threads got 168
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes fa;
    const cudaError_t e = cudaFuncGetAttributes(&fa, plan_tf32x3_kernel);
    if (e != cudaSuccess) return (int)e;
    regs = fa.numRegs;
  }
  if (regs != 168) return (int)cudaErrorInvalidConfiguration;
  static size_t opted = 48 * 1024;
  cudaError_t e = allow_smem(plan_tf32x3_kernel, kTSmem, &opted);
  if (e != cudaSuccess) return (int)e;
  const int kp = (k + 3) / 4 * 4;
  float* hi = ws;
  float* lo = ws + (long long)m * kp;
  split_bt_kernel<<<dim3((kp + 31) / 32, (m + 31) / 32), 256, 0, st>>>(
      static_cast<const float*>(b), ldb, k, m, kp, hi, lo);
  const void* a_src = a;
  long long a_ld = lda;
  int a_cols = k;
  if (!a_in_place(a, lda)) {
    float* pad = lo + (long long)m * kp;
    const long long total = (long long)n * kp;
    const int blocks = (int)((total + 255) / 256 < 65535 ? (total + 255) / 256
                                                         : 65535);
    pad_a_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(a), lda,
                                          n, k, kp, pad);
    a_src = pad;
    a_ld = kp;
    a_cols = kp;
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (!map_f32(am, a_src, n, a_cols, a_ld, kTM) ||
      !map_f32(him, hi, m, kp, kp, kTN) || !map_f32(lom, lo, m, kp, kp, kTN))
    return (int)cudaErrorInvalidValue;
  return 0;
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

// dtype 1 = bfloat16 (float32 takes matmul_tf32x3).  a (n, k) with row
// stride lda, b (k, m) with row stride ldb, c (n, m) contiguous; n, m >= 1,
// k >= 0.  Returns the CUDA error of the launch (0 when none).
extern "C" int matmul(int dtype, const void* a, const void* b, void* c,
                      int n, int m, int k, long long lda, long long ldb,
                      void* stream) {
  if (dtype != 1 || n < 1 || m < 1 || k < 0 ||
      (n + kBM / 2 - 1) / (kBM / 2) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = lda % 8 == 0 && ldb % 8 == 0;
  // the 16-byte phase of each operand, in elements (bf16 is 2 bytes)
  const int a_shift = vec ? (int)(((uintptr_t)a >> 1) & 7) : 0;
  const int b_shift = vec ? (int)(((uintptr_t)b >> 1) & 7) : 0;
  // 128-row tiles, or 64-row ones when 128-row tiles would give fewer than
  // two CTAs per SM (a PACO cuboid such as 1024 x 2048 makes 128)
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
  return (int)cudaGetLastError();
}

extern "C" {

// The plan variants, numbered as the wrapper's PLAN_VARIANTS.
enum { kPlanTf32x3 = 0, kPlanMmaSync = 1, kPlanWgmma = 2 };

// The output tile a variant walks, and the cells of the output whose
// parts are summed together: the wrapper builds its tables for them.
int matmul_plan_tile_rows(int variant) {
  return variant == kPlanWgmma ? kWM : variant == kPlanTf32x3 ? kTM : kBM;
}
int matmul_plan_tile_cols(int variant) {
  return variant == kPlanWgmma ? kWN : variant == kPlanTf32x3 ? kTN : kBN;
}
int matmul_plan_cell_rows() { return kCellRows; }
int matmul_plan_cell_cols() { return kCellCols; }

// The floats of workspace the float32 entries need beside C (and the
// plan's parts): B^T's TF32 hi and lo parts, (m x kp) each with kp = k
// rounded up to 4, and A padded to (n x kp) unless its row stride is a
// multiple of 4 and its base 16-byte aligned.
long long matmul_tf32x3_ws_floats(int n, int m, int k, long long lda,
                                  const void* a) {
  return split_floats(n, m, k, lda, a);
}

// float32 C = A @ B as three TF32 products (variant "wgmma_tf32x3"): the
// pre-passes into ws (ws_floats of it, matmul_tf32x3_ws_floats), then the
// walk over every tile, at most one CTA per SM.  a (n, k) row stride lda,
// b (k, m) row stride ldb, c (n, m) contiguous; n, m >= 1, k >= 0.
// Returns the CUDA error of the launches.
int matmul_tf32x3(const void* a, const void* b, void* c, void* ws,
                  long long ws_floats, int n, int m, int k, long long lda,
                  long long ldb, void* stream) {
  if (n < 1 || m < 1 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 0)
    return (int)cudaMemsetAsync(c, 0, sizeof(float) * (size_t)n * m, st);
  CUtensorMap am, him, lom;
  const int e = tf32x3_prepare(a, b, static_cast<float*>(ws), ws_floats, n,
                               m, k, lda, ldb, st, &am, &him, &lom);
  if (e) return e;
  const long long tiles =
      (long long)((n + kTM - 1) / kTM) * ((m + kTN - 1) / kTN);
  const int grid = (int)(tiles < sm_count() ? tiles : sm_count());
  plan_tf32x3_kernel<<<grid, kWThreads, kTSmem, st>>>(
      am, him, lom, static_cast<float*>(c), nullptr,
      Plan{nullptr, nullptr, nullptr, nullptr, nullptr}, n, m, k);
  return (int)cudaGetLastError();
}

// Every cuboid of a plan, one CTA per processor (n_ctas of them), then,
// when cuboids share outputs (n_cells > 0), the sums of their parts.
// bfloat16 only (dtype 1; float32 takes matmul_plan_tf32x3): variant 1,
// or 2 when TMA takes the operands (row strides multiples of 8, bases
// 16-byte aligned).  a (n, k) row stride lda, b (k, m) row stride ldb, c
// (n, m) contiguous; ws: the parts of the cuboids that share outputs; the
// table pointers as Plan says.  Returns the CUDA error of the launches.
int matmul_plan(int dtype, int variant, const void* a, const void* b,
                void* c, void* ws, const int* proc_off, const int* cub,
                const long long* ws_off, const int* cell, const int* cell_mem,
                int n_ctas, int n_cells, int n, int m, int k, long long lda,
                long long ldb, void* stream) {
  if (dtype != 1 || n_ctas < 1 || n_cells < 0 || n < 1 || m < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl{proc_off, cub, ws_off, cell, cell_mem};
  if (variant == kPlanWgmma) {
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
  } else if (variant == kPlanMmaSync) {
    static size_t opted = 48 * 1024;
    const cudaError_t e = allow_smem(plan_mma_kernel, kBf16Smem, &opted);
    if (e != cudaSuccess) return (int)e;
    plan_mma_kernel<<<n_ctas, kThreads, kBf16Smem, st>>>(
        static_cast<const unsigned short*>(a),
        static_cast<const unsigned short*>(b), static_cast<bf16*>(c),
        static_cast<bf16*>(ws), pl, lda, ldb, m);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_cells == 0) return (int)e;
  plan_sum_kernel<bf16><<<n_cells, kSumThreads, 0, st>>>(
      static_cast<const bf16*>(ws), static_cast<bf16*>(c), pl, m);
  return (int)cudaGetLastError();
}

// matmul_plan in float32, variant "wgmma_tf32x3": the pre-passes into
// split (split_len floats of it, matmul_tf32x3_ws_floats), the walk, one CTA
// per processor, then the k-cuts' sums.  Arguments otherwise as
// matmul_plan's (ws: the parts of the cuboids that share outputs).
int matmul_plan_tf32x3(const void* a, const void* b, void* c, void* ws,
                       void* split, long long split_len, const int* proc_off,
                       const int* cub, const long long* ws_off,
                       const int* cell, const int* cell_mem, int n_ctas,
                       int n_cells, int n, int m, int k, long long lda,
                       long long ldb, void* stream) {
  if (n_ctas < 1 || n_cells < 0 || n < 1 || m < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan pl{proc_off, cub, ws_off, cell, cell_mem};
  CUtensorMap am, him, lom;
  const int err = tf32x3_prepare(a, b, static_cast<float*>(split),
                                 split_len, n, m, k, lda, ldb, st, &am,
                                 &him, &lom);
  if (err) return err;
  plan_tf32x3_kernel<<<n_ctas, kWThreads, kTSmem, st>>>(
      am, him, lom, static_cast<float*>(c), static_cast<float*>(ws), pl, n,
      m, k);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_cells == 0) return (int)e;
  plan_sum_kernel<float><<<n_cells, kSumThreads, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(c), pl, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
