// Paged MLA latent attention on wgmma with TMA loads: the bf16 kernels for
// the full-width shapes (kv_lora 512, qk_rope 64, pages of a multiple of
// 64 positions), variant "wgmma" of paged_latent_prefill.cu (kernel 4)
// and of paged_latent_decode.cu (kernel 3), and variant "cluster" of the
// latent verify entry (4v).  All run one walk, `walk` below, over 64 query
// rows of one slot; they differ in their rows, their key ranges and their
// epilogues.
//
// Replaces src/repro/kernels/attention/attention.py:270
// paged_latent_prefill_pallas (body _paged_latent_prefill_kernel, :227)
// and :463 paged_latent_decode_pallas; paged_latent_prefill.cu and
// paged_latent_decode.cu give the functions and the layouts.
//
// What bounds them.  Prefill: operations.  A chunk of C positions x H heads
// at start s scores each visible (row, key) pair over 576 features and
// adds 512 value features: 2 (576 + 512) flops a pair, 34.2 GFLOP for
// deepseek-v2's serving chunk (C 128, H 128, start 896), 0.0346 ms at 989
// TFLOP/s bf16.  The latent it reads is small (1,152 bytes a key, 1.2 MB
// for 1,024 keys), but every CTA reads its whole causal key range again,
// from L2.  Decode: bytes.  One query a slot, 1,152 bytes a key shared by
// the 128 heads (~250 flops a byte, under the ~295 ridge): 5.1 MB of keys
// for 8 slots of 48..1,032 positions, 0.0020 ms at 3.35 TB/s; in practice
// the launch, the first loads and the merge set its time.  Verify:
// operations, as prefill.  The W x H rows of a slot share its keys: 8.6
// GFLOP for chip_smoke.py's 8 slots of W 8 at lengths 0..1,016, 0.0087 ms
// at 989 TFLOP/s, against 5.8 MB of keys and 18.9 MB of q and out.
//
// The walk (64 query rows, key positions [lo, hi) of one block-table row,
// each row masked at its own limit):
//  * one thread issues every load by TMA: Q (64 rows x 576, 72 KB, nine
//    64-column boxes of q_lat and q_rope, resident for the walk) and
//    64-key tiles of the latent (nine boxes of c_kv and k_rope at pool row
//    phys * page + offset: a tile lies inside one page) into a ring of two
//    stages, each guarded by an mbarrier the loads complete.  A stage is
//    refilled once both warpgroups' value products from it have landed
//    (the per-tile exchange of row maxima orders that), so the 72 KB from
//    L2 arrive during the next softmax, P V and S.  No producer warp: a
//    ninth warp would cap every thread at 168 registers.  Shared memory:
//    Q 72 KB + 2 x 72 KB of keys + 8 KB of P = 225 KB of the 227 KB; a
//    third stage does not fit (32-key tiles in three stages would halve
//    each wgmma's N and double the barriers a key for the same bytes in
//    flight);
//  * two consumer warpgroups.  S = Q K^T is split by keys: warpgroup w
//    scores keys [32 w, 32 w + 32) of the tile against all 64 rows
//    (wgmma m64n32k16, both operands from shared memory, 36 k-steps over
//    the 576 features).  Its online softmax runs in registers in the log2
//    domain; the two warpgroups exchange their row maxima through shared
//    memory (one named barrier), so both hold the same running max, and
//    each keeps the row sum of its own keys (added at the end).  The
//    exchange keeps the two in step; each scoring all 64 keys instead, so
//    that neither ever waits for the other, measured slower (the doubled
//    scoring cost more than the idle time it removed);
//  * the weights, rounded to bf16 where the mma.sync kernel rounds them
//    (before the value product, unnormalized), go to an 8 KB P tile in the
//    128-byte swizzle that wgmma reads; then O += P V with each warpgroup
//    owning half of the 512 value features (m64n256k16, V = the c_kv
//    columns of the same key tile: no second load), so the 64 x 512 f32
//    accumulator stays in registers (128 a thread);
//  * tile i's S is issued right behind tile i - 1's P V, so the tensor
//    cores run the two back to back;
//  * masked keys weigh 0 and the finite -1e30 initial max never makes a
//    NaN.
//
// Prefill (prefill_kernel): row r of the chunk is position r / H, head
// r % H, masked by its own causal limit start + r / H + 1, so a block may
// straddle positions (H < 64).  A full-width chunk launches 256 CTAs, each
// walking the keys up to its last row's position: 4x fewer key reads from
// L2 than 16-row blocks (295 MB a chunk, against 1.13 GB).  The grid takes
// the longest causal ranges first.  A chunk whose rows fill fewer CTAs
// than the card has processors splits its keys over 64-key-aligned
// ranges, and combine_kernel merges the f32 partials in split order
// (bitwise repeatable).  The epilogue normalizes the accumulator and
// leaves through shared memory (the Q region, free once the last S has
// landed), each warp staging its 16 rows 128 columns at a time and writing
// whole 16-byte pieces, as the matmul plan kernel does.
//
// Decode and verify (decode_kernel, verify_kernel: cluster_walk): one
// launch, the grid (ranks, row blocks of 64, slots) in clusters of ranks
// CTAs, one cluster per (slot, row block).  Decode: a slot's H heads are its
// rows (two blocks at H 128: each key tile is read twice, not eight times as
// by 16-row blocks), every row masked at the slot's length, clusters of
// kRanks = 4.  Verify (paged_latent_prefill.cu's paged_latent_verify,
// variant "cluster"): the W-token windows of B slots, slot b's rows its W x
// H (position, head) pairs, row r masked at its own causal limit lengths[b]
// + r / H + 1 (clamped to the table), its window's start read on the device;
// clusters of kVerifyRanks.  The splits are sized from the live keys, on the
// device: each rank reads the slot's length and takes a 64-key-aligned share
// of the tiles up to the block's last row's limit; a rank past the range
// loads no key and leaves no state.  After the walk each live rank puts its
// (m, l) and its 64 x 512 f32 accumulator in its own shared memory (over the
// key stages, free once the last product has landed; rows 520 floats apart,
// so the fragments' 8-byte stores meet no bank conflict).  Then every rank
// merges a slice of 512 / ranks features of the 64 rows, reading the live
// ranks' states through distributed shared memory in rank order, and writes
// it: no f32 partials go through device memory, no second kernel runs, and
// the result is bitwise the same on every call.  A decode slot with no valid
// key (length 0) walks its whole block-table row with every key scored 0:
// the uniform mean of its latents, which the TPU kernel and the plain
// version give by masking every score to the finite -1e30 (a verify row
// always sees its own position).
#pragma once

#include <cooperative_groups.h>

#include "flash_wgmma.cuh"

namespace latent_wgmma {

using namespace flash_wgmma;

constexpr int kKv = 512, kRope = 64;
constexpr int kBoxes = (kKv + kRope) / 64;  // 64-column boxes of a row: 9
constexpr int kRowsW = 64;                   // query rows a CTA
constexpr int kTk = 64;                      // keys a tile
constexpr int kHalf = kKv / 2;               // value features a warpgroup
constexpr int kAcc = 4 * kHalf / 8;          // accumulators a thread: 128
// two warpgroups and no producer warp: eight warps, two on each of the
// SM's four register files, so each thread may take 255 registers (a
// ninth warp caps them at 168, too few for the 128 accumulators and the
// scores: ptxas spilled and serialized the wgmmas)
constexpr int kThreadsW = 256;
constexpr int kStagesW = 2;
constexpr int kSmsW = 132;                   // H100 SXM
constexpr int kBlockBytes = 64 * 128;        // one 64 x 64 bf16 box
constexpr int kQ = 0;
constexpr int kTileBytes = kBoxes * kBlockBytes;   // 72 KB: Q, or a tile
constexpr int kK = kQ + kTileBytes;
constexpr int kP = kK + kStagesW * kTileBytes;     // 64 rows x 64 keys
constexpr int kX = kP + kBlockBytes;               // 2 x 64 floats
constexpr int kBar = kX + 2 * kRowsW * 4;
// q_full, then full per stage; + the 1024-byte alignment slack
constexpr size_t kSmemW = kBar + 8 * (1 + kStagesW) + 1024;
// decode: a rank's accumulator rows in shared memory (8 mod 32 floats)
constexpr int kAccStride = kKv + 8;
// decode: CTAs a cluster (8 ran slower, launch.paged_bench's ranks8 copy)
constexpr int kRanks = 4;
// verify: CTAs a cluster (launch.paged_bench's latent_verify_ranks* copies)
constexpr int kVerifyRanks = 2;
static_assert(kRowsW * kAccStride * 4 <= kStagesW * kTileBytes,
              "a rank's accumulator fits the key stages");

inline bool takes(int dtype, int kv, int rope, int page) {
  return dtype == 1 && kv == kKv && rope == kRope && page % kTk == 0;
}

// The key splits of a chunk: none when its 64-row blocks fill the card's
// processors, else as many 64-key-aligned ranges as bring the CTAs to
// about one a processor.
inline void splits(int start, int chunk, int heads, int* n_split,
                   int* split_keys) {
  const int blocks = (chunk * heads + kRowsW - 1) / kRowsW;
  const int keys = start + chunk;
  int sk = (keys + kTk - 1) / kTk * kTk;
  if (blocks < kSmsW) {
    const int want = (kSmsW + blocks - 1) / blocks;
    sk = ((keys + want - 1) / want + kTk - 1) / kTk * kTk;
  }
  *split_keys = sk;
  *n_split = (keys + sk - 1) / sk;
}

// d (64 x 32, f32) {=, +=} A (64 x 16) B^T (B 32 x 16), both bf16 from
// shared memory through K-major descriptors.
__device__ __forceinline__ void mma_ss_n32(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// This thread's row hh (0 or 1) of the CTA's 64: rows g and g + 8 of its
// warp's 16.
__device__ __forceinline__ int row_of(int hh) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * hh;
}

// The walk: the CTA's 64 query rows (rows q_row0 .. q_row0 + 63 of the q
// maps) against key positions [lo, hi) of the block-table row `table`,
// this thread's rows masked at limit[0], limit[1] (<= hi); ``uniform``
// scores every unmasked key 0 (a decode slot with no valid key).  On return,
// for this thread's two rows: m, the running max (log2 domain, the same in
// both warpgroups); l, the row sums of both warpgroups' keys (warpgroup
// 0's first); acc, its warpgroup's 256 value features, unnormalized.  Both
// warpgroups' products have landed and no load is in flight.
__device__ __forceinline__ void walk(
    uint32_t base, unsigned char* gen, const CUtensorMap* ql_map,
    const CUtensorMap* qr_map, const CUtensorMap* ckv_map,
    const CUtensorMap* kr_map, const int* __restrict__ table, int q_row0,
    int lo, int hi, const int* limit, int page, int n_pool,
    float scale_log2, bool uniform, float* m, float* l, float* acc) {
  const uint32_t q_full = base + kBar, full = q_full + 8;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStagesW; ++s) mbar_init(full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = hi > lo ? (hi - lo + kTk - 1) / kTk : 0;
  const int wg = threadIdx.x / 128;

  // One thread issues every TMA load: Q and the first two tiles here, tile
  // i + 1 in iteration i, once both warpgroups' P V of tile i - 1 has
  // landed (below).  It reads each tile's page id a tile ahead.
  auto phys_of = [&](int i) {
    return min(max(table[(lo + i * kTk) / page], 0), n_pool - 1);
  };
  auto load_tile = [&](int i, int phys) {
    const int stage = i % kStagesW;
    const uint32_t kt = base + kK + stage * kTileBytes;
    const int krow = phys * page + (lo + i * kTk) % page;
    mbar_expect_tx(full + 8 * stage, kTileBytes);
#pragma unroll
    for (int c = 0; c < kBoxes - 1; ++c)
      tma_load_2d(kt + c * kBlockBytes, ckv_map, full + 8 * stage, c * 64,
                  krow);
    tma_load_2d(kt + (kBoxes - 1) * kBlockBytes, kr_map, full + 8 * stage,
                0, krow);
  };
  const bool loader = threadIdx.x == 0;
  int next_phys = 0;
  if (loader && n_tiles > 0) {
    prefetch_map(ql_map);
    prefetch_map(qr_map);
    prefetch_map(ckv_map);
    prefetch_map(kr_map);
    mbar_expect_tx(q_full, kTileBytes);
#pragma unroll
    for (int c = 0; c < kBoxes - 1; ++c)
      tma_load_2d(base + kQ + c * kBlockBytes, ql_map, q_full, c * 64,
                  q_row0);
    tma_load_2d(base + kQ + (kBoxes - 1) * kBlockBytes, qr_map, q_full, 0,
                q_row0);
    load_tile(0, phys_of(0));
    if (n_tiles > 1) load_tile(1, phys_of(1));
    if (n_tiles > 2) next_phys = phys_of(2);
  }

  // ---- consumers: warpgroup wg scores keys [32 wg, 32 wg + 32) of each
  // tile and owns value features [256 wg, 256 wg + 256)
  const int t4 = threadIdx.x & 3;
  float* x_s = reinterpret_cast<float*>(gen + kX);   // [warpgroup][row]
  const int row[2] = {row_of(0), row_of(1)};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float s[16];
  if (n_tiles > 0) mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i % kStagesW;
    const uint32_t kt = base + kK + stage * kTileBytes;
    mbar_wait(full + 8 * stage, (i / kStagesW) & 1);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kBoxes * 4; ++ks)
      mma_ss_n32(s, desc_k(base + kQ, kRowsW, 0, ks),
                 desc_k(kt, kTk, 32 * wg, ks), ks > 0);
    wg_commit();
    wg_wait<0>();   // S, and the previous tile's P V, have landed
    fence_regs<16>(s);
    fence_regs<kAcc>(acc);

    // scores in the log2 domain, masked keys at -1e30; row maxima of this
    // warpgroup's 32 keys, then of both
    const int k0 = lo + i * kTk + 32 * wg;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int hh = (j >> 1) & 1;
      const int key = k0 + 8 * (j >> 2) + 2 * t4 + (j & 1);
      s[j] = key < limit[hh] ? (uniform ? 0.f : s[j] * scale_log2)
                             : kNegInf;
      mx[hh] = fmaxf(mx[hh], s[j]);
    }
    mx[0] = flash_mma::quad_max(mx[0]);
    mx[1] = flash_mma::quad_max(mx[1]);
    if (t4 == 0) {
      x_s[wg * kRowsW + row[0]] = mx[0];
      x_s[wg * kRowsW + row[1]] = mx[1];
    }
    bar_sync(1, 256);   // both warpgroups' P V of tile i - 1 have landed
    if (loader && i >= 1 && i + 1 < n_tiles) {
      load_tile(i + 1, next_phys);   // in flight during softmax, P V, S
      if (i + 2 < n_tiles) next_phys = phys_of(i + 2);
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(
          m[hh], fmaxf(x_s[row[hh]], x_s[kRowsW + row[hh]]));
      alpha[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
    }
    // the weights (a masked key weighs 0), rounded to bf16 into P: row r's
    // 16-byte unit u (keys 8u .. 8u + 7) at r * 128 + (u ^ (r % 8)) * 16
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float* x = s + 4 * nt + 2 * hh;
        const float p0 = x[0] <= kNegInf ? 0.f : exp2f(x[0] - m[hh]);
        const float p1 = x[1] <= kNegInf ? 0.f : exp2f(x[1] - m[hh]);
        rs[hh] += p0 + p1;
        const int r = row[hh], u = 4 * wg + nt;
        *reinterpret_cast<unsigned*>(gen + kP + r * 128 +
                                     ((u ^ (r & 7)) << 4) + 4 * t4) =
            flash_mma::pack_bf16(p0, p1);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      l[hh] = l[hh] * alpha[hh] + flash_mma::quad_sum(rs[hh]);
    fence_proxy_async();
    bar_sync(2, 256);   // P whole; both warpgroups read their maxima
#pragma unroll
    for (int i2 = 0; i2 < kAcc; ++i2) acc[i2] *= alpha[(i2 >> 1) & 1];
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < kTk / 16; ++ks)
      mma_ss_n256_tb(acc, desc_k(base + kP, kRowsW, 0, ks),
                     desc_mn(kt + 4 * wg * kBlockBytes, kTk, ks));
    wg_commit();
  }
  wg_wait<0>();
  fence_regs<kAcc>(acc);

  // the row sums of both warpgroups' keys, in warpgroup order
  if (t4 == 0) {
    x_s[wg * kRowsW + row[0]] = l[0];
    x_s[wg * kRowsW + row[1]] = l[1];
  }
  bar_sync(1, 256);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    l[hh] = x_s[row[hh]] + x_s[kRowsW + row[hh]];
}

// q_lat (n_rows, 512), q_rope (n_rows, 64), the pools (n_pool * page,
// 512) and (n_pool * page, 64), all as 2-D maps with 64 x 64 boxes;
// row_table (width,); out (n_rows, 512) bf16, or, split, part_acc (n_split,
// n_rows, 512) and part_ml (n_split, n_rows, 2) f32.  Grid (row blocks,
// n_split).  scale_log2 = scale * log2 e.
__global__ void __launch_bounds__(kThreadsW, 1)
prefill_kernel(const __grid_constant__ CUtensorMap ql_map,
               const __grid_constant__ CUtensorMap qr_map,
               const __grid_constant__ CUtensorMap ckv_map,
               const __grid_constant__ CUtensorMap kr_map,
               const int* __restrict__ row_table, bf16* __restrict__ out,
               float* __restrict__ part_acc, float* __restrict__ part_ml,
               int n_rows, int n_heads, int page, int width, int n_pool,
               int start, int split_keys, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));

  // longest causal range first: the last row block goes first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kRowsW;
  const int split = blockIdx.y;
  const int r_last = min(r0 + kRowsW, n_rows) - 1;
  const int lo = split * split_keys;
  const int hi =
      min(min(start + r_last / n_heads + 1, width * page), lo + split_keys);
  int limit[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    limit[hh] = min(start + (r0 + row_of(hh)) / n_heads + 1, hi);
  float m[2], lt[2], acc[kAcc];
  walk(base, gen, &ql_map, &qr_map, &ckv_map, &kr_map, row_table, r0, lo,
       hi, limit, page, n_pool, scale_log2, false, m, lt, acc);

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int row[2] = {row_of(0), row_of(1)};
  if (gridDim.y > 1) {   // f32 partials for combine_kernel
    const long long prow0 = (long long)split * n_rows + r0;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (r0 + row[hh] >= n_rows) continue;
      const long long prow = prow0 + row[hh];
#pragma unroll
      for (int nt = 0; nt < kHalf / 8; ++nt)
        *reinterpret_cast<float2*>(part_acc + prow * kKv + kHalf * wg +
                                   8 * nt + 2 * t4) =
            make_float2(acc[4 * nt + 2 * hh], acc[4 * nt + 2 * hh + 1]);
      if (wg == 0 && t4 == 0) {   // the max in natural-log units
        part_ml[prow * 2] = m[hh] * flash_mma::kLn2;
        part_ml[prow * 2 + 1] = lt[hh];
      }
    }
    return;
  }
  // Normalized bf16 rows through the warp's staging rows in the Q region
  // (free: every S has landed), 128 columns at a time, out as whole 16-byte
  // pieces (unit j of row r at unit j ^ (r % 8): no bank conflicts).
  const float inv[2] = {1.f / fmaxf(lt[0], 1e-30f), 1.f / fmaxf(lt[1], 1e-30f)};
  unsigned char* stg = gen + kQ + (4 * wg + warp) * 16 * 256;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = g + 8 * hh, nt = 16 * half + j;
        *reinterpret_cast<__nv_bfloat162*>(
            stg + r * 256 + ((j ^ (r & 7)) << 4) + 4 * t4) =
            __floats2bfloat162_rn(acc[4 * nt + 2 * hh] * inv[hh],
                                  acc[4 * nt + 2 * hh + 1] * inv[hh]);
      }
    __syncwarp();
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int r = 2 * it + (lane >> 4), unit = lane & 15;
      const int orow = r0 + warp * 16 + r;
      if (orow < n_rows)
        *reinterpret_cast<uint4*>(out + (long long)orow * kKv + kHalf * wg +
                                  128 * half + 8 * unit) =
            *reinterpret_cast<const uint4*>(stg + r * 256 +
                                            ((unit ^ (r & 7)) << 4));
    }
    __syncwarp();
  }
}

// The slot of the cluster that starts target-th (the card starts clusters
// roughly in the grid's order): the slots by decreasing length, ties by
// index, so that the longest walks start first and the short ones fill in
// behind them.  Each warp finds it for itself, 32 slots a round.
__device__ __forceinline__ int slot_by_length(const int* __restrict__ lengths,
                                              int n_slots, int target) {
  const int lane = threadIdx.x & 31;
  for (int s0 = 0; s0 < n_slots; s0 += 32) {
    const int s = s0 + lane;
    int before = -1;
    if (s < n_slots) {
      const int len = lengths[s];
      before = 0;
      for (int j = 0; j < n_slots; ++j) {
        const int lj = lengths[j];
        before += lj > len || (lj == len && j < s);
      }
    }
    const unsigned hit = __ballot_sync(0xffffffffu, before == target);
    if (hit) return s0 + __ffs(hit) - 1;
  }
  return target;
}

// The cluster walk of decode and verify.  q_lat (B * n_rows, 512),
// q_rope (B * n_rows, 64) and the pools as for prefill; tables (B, width),
// lengths (B,); out (B * n_rows, 512) bf16.  Decode (n_rows = H): every
// row sees the slot's keys [0, min(lengths[b], width * page)).  VERIFY
// (n_rows = W x H): row r sees [0, min(lengths[b] + r / H + 1, width *
// page)), its position's causal limit, and the clusters take the slots
// longest first (slot_by_length) and each slot's row blocks from its last,
// whose keys reach furthest.  Grid (RANKS, row blocks of 64, B) in
// clusters of RANKS along x; the two kernels below fix their cluster
// shapes at compile time.
template <int RANKS, bool VERIFY>
__device__ __forceinline__ void cluster_walk(
    const CUtensorMap* ql_map, const CUtensorMap* qr_map,
    const CUtensorMap* ckv_map, const CUtensorMap* kr_map,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    bf16* __restrict__ out, int n_rows, int n_heads, int page, int width,
    int n_pool, float scale_log2) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int rb = VERIFY ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int b =
      VERIFY ? slot_by_length(lengths, gridDim.z, blockIdx.z) : blockIdx.z;
  const int r0 = rb * kRowsW;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));

  // the block's live keys [0, n) (those of its last row) in 64-key tiles,
  // and this rank's share; each row masked at its own limit.  A decode
  // slot with none (length 0) walks the whole row, every key scored 0.
  const int length = lengths[b];
  const int wp = width * page;
  auto keys_of = [&](int r) {
    return max(min(VERIFY ? length + r / n_heads + 1 : length, wp), 0);
  };
  int n = keys_of(min(r0 + kRowsW, n_rows) - 1);
  const bool uniform = n == 0;
  if (uniform) n = wp;
  const int tiles = (n + kTk - 1) / kTk;
  const int share = (tiles + RANKS - 1) / RANKS;
  const int lo = min(rank * share * kTk, n);
  const int hi = min(n, lo + share * kTk);
  int limit[2] = {hi, hi};
  if (VERIFY) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      limit[hh] = min(keys_of(r0 + row_of(hh)), hi);
  }
  float m[2], l[2], acc[kAcc];
  walk(base, gen, ql_map, qr_map, ckv_map, kr_map,
       tables + (long long)b * width, b * n_rows + r0, lo, hi, limit, page,
       n_pool, scale_log2, uniform, m, l, acc);

  // the rank's state in its own shared memory: the accumulator over the
  // key stages, (m, l) over P
  float* acc_s = reinterpret_cast<float*>(gen + kK);
  float* ml_s = reinterpret_cast<float*>(gen + kP);
  if (hi > lo) {
    const int wg = threadIdx.x / 128, t4 = threadIdx.x & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row_of(hh);
#pragma unroll
      for (int nt = 0; nt < kHalf / 8; ++nt)
        *reinterpret_cast<float2*>(acc_s + r * kAccStride + kHalf * wg +
                                   8 * nt + 2 * t4) =
            make_float2(acc[4 * nt + 2 * hh], acc[4 * nt + 2 * hh + 1]);
      if (wg == 0 && t4 == 0) {
        ml_s[2 * r] = m[hh];
        ml_s[2 * r + 1] = l[hh];
      }
    }
  }
  cluster.sync();

  // the merge: features [rank F, rank F + F) of the 64 rows, 4 a thread at
  // a time, from the live ranks in rank order
  constexpr int kF = kKv / RANKS, kUnits = kF / 4;
  const int live = share > 0 ? (tiles + share - 1) / share : 0;
  for (int u = threadIdx.x; u < kRowsW * kUnits; u += kThreadsW) {
    const int r = u / kUnits, f = rank * kF + 4 * (u % kUnits);
    const int row = r0 + r;
    if (row >= n_rows) continue;
    float mr[RANKS], lr[RANKS];
    float4 ar[RANKS];
#pragma unroll
    for (int q = 0; q < RANKS; ++q) {
      mr[q] = kNegInf;
      lr[q] = 0.f;
      ar[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < live) {
        const float* ml = cluster.map_shared_rank(ml_s, q);
        mr[q] = ml[2 * r];
        lr[q] = ml[2 * r + 1];
        ar[q] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(acc_s, q) + r * kAccStride + f);
      }
    }
    float mm = kNegInf;
#pragma unroll
    for (int q = 0; q < RANKS; ++q) mm = fmaxf(mm, mr[q]);
    float ll = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < RANKS; ++q) {
      if (q >= live) break;
      const float w = exp2f(mr[q] - mm);
      ll += lr[q] * w;
      a.x += ar[q].x * w;
      a.y += ar[q].y * w;
      a.z += ar[q].z * w;
      a.w += ar[q].w * w;
    }
    const float inv = 1.f / fmaxf(ll, 1e-30f);
    __nv_bfloat162 v[2] = {__floats2bfloat162_rn(a.x * inv, a.y * inv),
                           __floats2bfloat162_rn(a.z * inv, a.w * inv)};
    *reinterpret_cast<uint2*>(out + ((long long)b * n_rows + row) * kKv +
                              f) = *reinterpret_cast<const uint2*>(v);
  }
  cluster.sync();   // no rank leaves while another reads its state
}

// Decode: q_lat (B * H, 512), q_rope (B * H, 64).
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreadsW, 1)
decode_kernel(const __grid_constant__ CUtensorMap ql_map,
              const __grid_constant__ CUtensorMap qr_map,
              const __grid_constant__ CUtensorMap ckv_map,
              const __grid_constant__ CUtensorMap kr_map,
              const int* __restrict__ tables,
              const int* __restrict__ lengths, bf16* __restrict__ out,
              int n_heads, int page, int width, int n_pool,
              float scale_log2) {
  cluster_walk<kRanks, false>(&ql_map, &qr_map, &ckv_map, &kr_map, tables,
                              lengths, out, n_heads, n_heads, page, width,
                              n_pool, scale_log2);
}

// Verify: q_lat (B * W * H, 512), q_rope (B * W * H, 64), n_rows = W * H.
__global__ void __cluster_dims__(kVerifyRanks, 1, 1)
    __launch_bounds__(kThreadsW, 1)
verify_kernel(const __grid_constant__ CUtensorMap ql_map,
              const __grid_constant__ CUtensorMap qr_map,
              const __grid_constant__ CUtensorMap ckv_map,
              const __grid_constant__ CUtensorMap kr_map,
              const int* __restrict__ tables,
              const int* __restrict__ lengths, bf16* __restrict__ out,
              int n_rows, int n_heads, int page, int width, int n_pool,
              float scale_log2) {
  cluster_walk<kVerifyRanks, true>(&ql_map, &qr_map, &ckv_map, &kr_map,
                                   tables, lengths, out, n_rows, n_heads,
                                   page, width, n_pool, scale_log2);
}

// The 2-D maps of the queries (n_rows rows) and of the latent pools.
inline bool maps(CUtensorMap* qlm, CUtensorMap* qrm, CUtensorMap* ckm,
                 CUtensorMap* krm, const void* q_lat, const void* q_rope,
                 const void* ckv, const void* kr, int n_rows, int pool_rows) {
  return map_2d(qlm, q_lat, n_rows, kKv, kKv, kRowsW) &&
         map_2d(qrm, q_rope, n_rows, kRope, kRope, kRowsW) &&
         map_2d(ckm, ckv, pool_rows, kKv, kKv, kTk) &&
         map_2d(krm, kr, pool_rows, kRope, kRope, kTk);
}

// The prefill launch, and combine_kernel's when split.
inline int launch(const void* q_lat, const void* q_rope, const void* ckv,
                  const void* kr, const int* row_table, void* out,
                  void* part_acc, void* part_ml, int chunk, int heads,
                  int page, int width, int n_pool, int start, float scale,
                  cudaStream_t stream) {
  if (chunk * heads == 0) return 0;
  static size_t opted_in = 48 * 1024;
  const cudaError_t e = allow_smem(prefill_kernel, kSmemW, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const int n_rows = chunk * heads;
  CUtensorMap qlm, qrm, ckm, krm;
  if (!maps(&qlm, &qrm, &ckm, &krm, q_lat, q_rope, ckv, kr, n_rows,
            n_pool * page))
    return (int)cudaErrorInvalidValue;
  int n_split, split_keys;
  splits(start, chunk, heads, &n_split, &split_keys);
  const dim3 grid((n_rows + kRowsW - 1) / kRowsW, n_split);
  prefill_kernel<<<grid, kThreadsW, kSmemW, stream>>>(
      qlm, qrm, ckm, krm, row_table, static_cast<bf16*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), n_rows,
      heads, page, width, n_pool, start, split_keys,
      scale * flash_mma::kLog2e);
  if (n_split > 1) {
    const cudaError_t e2 = cudaGetLastError();
    if (e2 != cudaSuccess) return (int)e2;
    combine_kernel<bf16><<<n_rows, 256, 0, stream>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml), static_cast<bf16*>(out), n_rows,
        kKv, n_split);
  }
  return (int)cudaGetLastError();
}

// The decode launch: one, no scratch.
inline int launch_decode(const void* q_lat, const void* q_rope,
                         const void* ckv, const void* kr, const int* tables,
                         const int* lengths, void* out, int batch, int heads,
                         int page, int width, int n_pool, float scale,
                         cudaStream_t stream) {
  if (batch * heads == 0) return 0;
  CUtensorMap qlm, qrm, ckm, krm;
  if (!maps(&qlm, &qrm, &ckm, &krm, q_lat, q_rope, ckv, kr, batch * heads,
            n_pool * page))
    return (int)cudaErrorInvalidValue;
  static size_t opted_in = 48 * 1024;
  const cudaError_t e = allow_smem(decode_kernel, kSmemW, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(kRanks, (heads + kRowsW - 1) / kRowsW, batch);
  decode_kernel<<<grid, kThreadsW, kSmemW, stream>>>(
      qlm, qrm, ckm, krm, tables, lengths, static_cast<bf16*>(out), heads,
      page, width, n_pool, scale * flash_mma::kLog2e);
  return (int)cudaGetLastError();
}

// The verify launch: q_lat (B, W, H, 512) and q_rope (B, W, H, 64) as
// B * W * H rows; one, no scratch.
inline int launch_verify(const void* q_lat, const void* q_rope,
                         const void* ckv, const void* kr, const int* tables,
                         const int* lengths, void* out, int batch, int w,
                         int heads, int page, int width, int n_pool,
                         float scale, cudaStream_t stream) {
  const int n_rows = w * heads;
  if (batch * n_rows == 0) return 0;
  CUtensorMap qlm, qrm, ckm, krm;
  if (!maps(&qlm, &qrm, &ckm, &krm, q_lat, q_rope, ckv, kr, batch * n_rows,
            n_pool * page))
    return (int)cudaErrorInvalidValue;
  static size_t opted_in = 48 * 1024;
  const cudaError_t e = allow_smem(verify_kernel, kSmemW, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(kVerifyRanks, (n_rows + kRowsW - 1) / kRowsW, batch);
  verify_kernel<<<grid, kThreadsW, kSmemW, stream>>>(
      qlm, qrm, ckm, krm, tables, lengths, static_cast<bf16*>(out), n_rows,
      heads, page, width, n_pool, scale * flash_mma::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace latent_wgmma
