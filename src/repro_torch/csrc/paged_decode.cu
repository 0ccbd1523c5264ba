// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/attention/attention.py:371
// paged_flash_decode_pallas (body _paged_decode_kernel): one decode query
// per slot and query head against the paged K/V pool, reached through the
// slot's block table.
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
// the card's ~295 flop/byte ridge: 17.6 MB for qwen3-0.6b's 8 slots of
// 48..1032 positions, 0.0053 ms at 3.35 TB/s.  Its time is set by how
// many of those bytes it keeps in flight and by what each launch costs
// besides them.  The design:
//  * one launch: the grid is (kRanks x Hkv, B) in clusters of kRanks = 8
//    CTAs, one cluster per (slot, kv head).  No second kernel merges
//    splits and no f32 partials go through device memory;
//  * the splits are sized from the work, on the device: each rank reads
//    the slot's length (and, in the same round trip, its block-table row)
//    and takes ceil(n / 8) of its n live key positions
//    [max(0, length - window), min(length, width * page)); a rank past
//    the range loads nothing and writes nothing (it only joins the
//    cluster's two barriers);
//  * a rank copies its keys' K and V rows into a two-stage ring of shared
//    memory with cp.async, 16 bytes a thread (a half-warp per 256-byte
//    row at D 128), both stages issued before the first is used: at the
//    serving shapes (512 CTAs of 128 threads and 53 KB, four a processor,
//    one wave) 96 of each rank's at most 129 keys are in flight at once;
//  * the arithmetic is small (CUDA cores would suffice for its flops), but
//    done with warp shuffles it cost as much as the loads: 80 shuffles per
//    8 keys, which the processor issues one warp at a time.  So bf16 at
//    D 64, 128 and 256 runs each warp's 16-key steps on mma.sync
//    (MmaWalk: S = Q K^T with the G queries as rows of a 16-row tile, the
//    weights rounded to bf16 as P in P V; rows padded by 16 bytes so
//    ldmatrix meets no bank conflict); float32 and other widths keep the
//    shuffle walk (CoreWalk: lanes across head_dim, f32 weights);
//  * the merge: the warps' states meet in shared memory in warp order,
//    then rank 0 reads the ranks' states through distributed shared memory
//    in rank order and writes the output, so the result is bitwise the
//    same on every call.
// Every position the walk visits is valid, so only a step's tail past the
// stage's keys is masked.  A slot with no valid position (length 0, or a
// window wholly past its table) walks its whole block-table row with every
// key weighed alike: the uniform mean of its values, which the TPU kernel
// and the plain version give by masking every score to the finite -1e30.
//
// paged_verify_cluster is the speculative-verify entry's bf16 family
// (variant "cluster" of attention.paged_flash_verify): the W-token windows
// of all B slots in one launch, as jax.vmap of
// src/repro/kernels/attention/attention.py:172 paged_flash_prefill_pallas
// over the slots runs them (slot b's scalar-prefetched start is
// lengths[b]),
//
// q      (B, W, Hq, D)         slot b's queries at positions lengths[b] + t
// tables (B, width) int32      block-table rows
// lengths(B,) int32            the windows' starts, read on the device
// out    (B, W, Hq, D)
//
// on the same cluster walk: one cluster of kVerifyRanks = 4 CTAs per (slot,
// kv head), whose W x G (position, head) rows fill the 16-row mma.sync tile
// that decode fills with G (VerifyWalk; it takes bf16 at D 64, 128 and 256
// with W x G <= 16: qwen3-0.6b's and gemma2-2b's verify, G 2 at W 8).  The
// ranks' shares are sized on the device from the slot's live keys [max(0,
// lengths[b] - window + 1), min(lengths[b] + W, width * page)), in whole
// 16-key steps (a short slot's keys take one rank), every row masked at its
// own causal limit lengths[b] + t + 1 and window start, the softcap applied
// before the mask.  Each rank merges a slice of the W x G x D outputs from
// every rank's state through distributed shared memory (merged by rank 0
// alone, 16 rows cost as much as the walk).  It reads each key's K/V once
// for the W rows (decode over B x W rows would read it W times), writes no
// f32 partial and runs no second kernel.  float32, other widths and
// windows of more rows keep paged_prefill.cu's paged_verify (the prefill
// kernels with the slot as a grid axis and host-sized key splits).

#include <cooperative_groups.h>

#include "flash_mma.cuh"   // the cp.async and quad-reduction helpers

namespace {

using namespace paged;
namespace cg = cooperative_groups;

constexpr int kRanks = 8;        // CTAs of a cluster: one (slot, kv head)
// verify's (8 ran slower: launch.paged_bench's verify_ranks* copies)
constexpr int kVerifyRanks = 4;
// 128 threads: at the serving instantiation's registers, four CTAs fit a
// processor, so the 512 CTAs of qwen3-0.6b's decode run in one wave (with
// 256 threads two did, and the decode took two waves)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;        // keys per warp step on CUDA cores
constexpr int kMmaKeys = 16;     // keys per warp step on tensor cores
constexpr int kStages = 2;
// Shared-memory rows are padded by 16 bytes, so that ldmatrix's eight rows
// (and the CUDA-core lanes' loads) meet no bank conflict; a stage holds 48
// such rows of K (and as many of V) at D 128 in bf16.
constexpr int kPad = 16;
constexpr int kStageBytes = 48 * (256 + kPad);
constexpr int kMaxG = 8;         // grouped query heads per kv head
constexpr int kMaxEpl = 8;       // head_dim <= 32 * kMaxEpl

// Shared memory: the stages, later reused for the warps' states, then the
// rank's merged state (read by rank 0 through the cluster) and its page
// ids.
__host__ __device__ inline size_t stage_region(int g_n, int d) {
  const size_t stages = (size_t)kStages * 2 * kStageBytes;
  const size_t warps = sizeof(float) * kWarps * g_n * (d + 2);
  return stages > warps ? stages : warps;
}

// A rank's merged state in floats: (m, l) per row, then its R x D
// accumulator; verify pads the former to whole float4s (its merges read
// the accumulator 16 bytes at a time).
__host__ __device__ inline int state_floats(int rows, int d, bool verify) {
  return (verify ? (2 * rows + 3) / 4 * 4 : 2 * rows) + rows * d;
}

inline size_t smem_bytes(int g_n, int d, int width) {
  return stage_region(g_n, d) + sizeof(float) * g_n * (d + 2) +
         sizeof(int) * width;
}

// Keys a stage holds: a multiple of 16 on tensor cores.
__host__ __device__ inline int stage_keys_of(int row_bytes, bool mma) {
  const int k = kStageBytes / (row_bytes + kPad);
  return mma ? k / kMmaKeys * kMmaKeys : k;
}

// A warp's walk on CUDA cores: lanes across head_dim (EPL elements each),
// batches of kBatch keys, the dot products reduced with warp shuffles.
template <typename T, int G_MAX, int EPL>
struct CoreWalk {
  float qr[G_MAX][EPL], acc[G_MAX][EPL], m[G_MAX], l[G_MAX];
  int e0;
  bool lane_on;

  __device__ void init(const T* q, long long row0, int g_n, int d, int lane,
                       bool any) {
    e0 = lane * EPL;
    lane_on = e0 < d;
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      m[g] = kNegInf;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = acc[g][e] = 0.f;
      if (g < g_n && lane_on && any)
        load_n<T, EPL>(q + (row0 + g) * d + e0, qr[g]);
    }
  }

  // The warp's batches of one stage: nk keys, rows rs elements apart;
  // ``uniform`` scores every key 0 (a slot with no valid key).
  __device__ void stage(const T* kb, const T* vb, int rs, int nk, int g_n,
                        int warp, float scale, float softcap, bool uniform) {
    for (int j0 = warp * kBatch; j0 < nk; j0 += kWarps * kBatch) {
      float kx[kBatch][EPL], vx[kBatch][EPL];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (j0 + j < nk && lane_on) {
          load_n<T, EPL>(kb + (j0 + j) * rs + e0, kx[j]);
          load_n<T, EPL>(vb + (j0 + j) * rs + e0, vx[j]);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) kx[j][e] = vx[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < G_MAX; ++g) {
        if (g >= g_n) break;
        float sc[kBatch];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) part += qr[g][e] * kx[j][e];
          sc[j] = warp_sum(part) * scale;
          if (softcap > 0.f) sc[j] = tanhf(sc[j] / softcap) * softcap;
          if (uniform) sc[j] = 0.f;
          if (j0 + j < nk) mx = fmaxf(mx, sc[j]);
        }
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const float p = j0 + j < nk ? expf(sc[j] - m_new) : 0.f;
          sum += p;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] += p * vx[j][e];
        }
        l[g] = l[g] * alpha + sum;
        m[g] = m_new;
      }
    }
  }

  // The warp's (m, l) and accumulator per query into w_ml, w_acc.
  __device__ void write(float* w_ml, float* w_acc, int g_n, int d, int warp,
                        int lane) const {
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g >= g_n) break;
      if (lane == 0) {
        w_ml[(warp * g_n + g) * 2] = m[g];
        w_ml[(warp * g_n + g) * 2 + 1] = l[g];
      }
      if (lane_on) {
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          w_acc[(warp * g_n + g) * d + e0 + e] = acc[g][e];
      }
    }
  }
};

// A warp's walk on tensor cores (bf16, D a multiple of 16): the G queries
// are rows of a 16-row tile (rows G..15 zero), and each step takes 16 keys:
// S = Q K^T (mma.sync m16n8k16, K by ldmatrix), the online softmax of row
// g = lane / 4 across its quad, P rounded to bf16 as the A operand of
// O += P V (V by ldmatrix.trans).  Rows past the stage's keys are zero
// (the copies zero-fill them) and masked.
template <int D>
struct MmaWalk {
  using bf16 = __nv_bfloat16;
  unsigned qa[D / 16][2];   // Q's A fragments, row g (row g + 8 is zero)
  float acc[D / 8][4];      // O, rows g and g + 8 (the latter unused)
  float m, l;
  int lane;

  __device__ void init(const bf16* q, long long row0, int g_n, int, int ln,
                       bool any) {
    lane = ln;
    m = kNegInf;
    l = 0.f;
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      qa[ks][0] = qa[ks][1] = 0u;
      if (g < g_n && any) {
        const bf16* qr = q + (row0 + g) * D + 16 * ks + 2 * t4;
        qa[ks][0] = *reinterpret_cast<const unsigned*>(qr);
        qa[ks][1] = *reinterpret_cast<const unsigned*>(qr + 8);
      }
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }

  __device__ void stage(const bf16* kb, const bf16* vb, int rs, int nk, int,
                        int warp, float scale, float softcap, bool uniform) {
    const int t4 = lane & 3;
    for (int j0 = warp * kMmaKeys; j0 < nk; j0 += kWarps * kMmaKeys) {
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      // matrix lane / 8: keys (lane / 16) * 8 .., dims ((lane / 8) % 2) * 8
      const bf16* kp = kb + (j0 + (lane >> 4) * 8 + (lane & 7)) * rs +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        unsigned bb[4];
        ldsm_x4(bb, kp + 16 * ks);
        const unsigned a[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
        mma_bf16(sc[0], a, bb);
        mma_bf16(sc[1], a, bb + 2);
      }
      // row g's scores: keys j0 + 8 nt + 2 t4 + e (e = 0, 1)
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[nt][e] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          sc[nt][e] = uniform ? 0.f : x;
          if (j0 + 8 * nt + 2 * t4 + e < nk) mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m, flash_mma::quad_max(mx));
      const float alpha = expf(m - m_new);
      float p[2][2], sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[nt][e] = j0 + 8 * nt + 2 * t4 + e < nk
                         ? expf(sc[nt][e] - m_new) : 0.f;
          sum += p[nt][e];
        }
      l = l * alpha + flash_mma::quad_sum(sum);
      m = m_new;
      const unsigned pa[4] = {flash_mma::pack_bf16(p[0][0], p[0][1]), 0u,
                              flash_mma::pack_bf16(p[1][0], p[1][1]), 0u};
      // V's B fragments: keys j0 + lane % 16, dims (lane / 16) * 8 ..
      const bf16* vp = vb + (j0 + (lane & 15)) * rs + (lane >> 4) * 8;
#pragma unroll
      for (int nt = 0; nt < D / 8; nt += 2) {
        acc[nt][0] *= alpha;
        acc[nt][1] *= alpha;
        acc[nt + 1][0] *= alpha;
        acc[nt + 1][1] *= alpha;
        unsigned bb[4];
        ldsm_x4_trans(bb, vp + nt * 8);
        mma_bf16(acc[nt], pa, bb);
        mma_bf16(acc[nt + 1], pa, bb + 2);
      }
    }
  }

  __device__ void write(float* w_ml, float* w_acc, int g_n, int, int warp,
                        int) const {
    const int g = lane >> 2, t4 = lane & 3;
    if (g >= g_n) return;
    if (t4 == 0) {
      w_ml[(warp * g_n + g) * 2] = m;
      w_ml[(warp * g_n + g) * 2 + 1] = l;
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      w_acc[(warp * g_n + g) * D + 8 * nt + 2 * t4] = acc[nt][0];
      w_acc[(warp * g_n + g) * D + 8 * nt + 2 * t4 + 1] = acc[nt][1];
    }
  }
};

// The verify window's walk on tensor cores (bf16, D 64, 128 or 256): all
// 16 rows of the tile are queries, row r = (position t = r / G, head
// g = r % G) of the slot's window, each masked at its own key range
// [rlo, rhi): its window's first key and its causal limit lengths[b] + t + 1
// (clamped to the table).  A row whose range is empty (a window wholly past
// the table) has the whole table as its range with every key scored 0: the
// plain version's uniform mean under the finite -1e30 mask.  The softmax
// runs in the log2 domain (scale and log2 e in one multiply); m leaves in
// natural units for the merges below.  Rows past the window (W G < 16)
// have an empty range and are never written.
template <int D>
struct VerifyWalk {
  using bf16 = __nv_bfloat16;
  unsigned qa[D / 16][4];   // Q's A fragments: rows g and g + 8
  float acc[D / 8][4];      // O, rows g (e 0, 1) and g + 8 (e 2, 3)
  float m[2], l[2];
  int rlo[2], rhi[2];
  bool uni[2];
  int lane;

  // q_row(r): the q (and out) row of tile row r; p0: row 0's position;
  // wp: the table's keys.
  template <typename ROW>
  __device__ void init(const bf16* q, ROW q_row, int rows, int g_n,
                       long long p0, int window, int wp, int ln, bool any) {
    lane = ln;
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = g + 8 * hh;
      m[hh] = kNegInf;
      l[hh] = 0.f;
      rlo[hh] = rhi[hh] = 0;
      uni[hh] = false;
      if (r < rows) {
        const long long p = p0 + r / g_n;
        const long long lo = p - window + 1;
        rlo[hh] = lo > 0 ? (int)min(lo, (long long)wp) : 0;
        rhi[hh] = (int)min(p + 1, (long long)wp);
        uni[hh] = rhi[hh] <= rlo[hh];
        if (uni[hh]) {
          rlo[hh] = 0;
          rhi[hh] = wp;
        }
      }
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = g + 8 * hh;
        qa[ks][hh] = qa[ks][hh + 2] = 0u;
        if (r < rows && any) {
          const bf16* qr = q + q_row(r) * D + 16 * ks + 2 * t4;
          qa[ks][hh] = *reinterpret_cast<const unsigned*>(qr);
          qa[ks][hh + 2] = *reinterpret_cast<const unsigned*>(qr + 8);
        }
      }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  }

  // The warp's 16-key steps of a stage of nk keys from key position t0.
  __device__ void stage(const bf16* kb, const bf16* vb, int rs, int nk,
                        int t0, int warp, float scale, float softcap) {
    const int t4 = lane & 3;
    for (int j0 = warp * kMmaKeys; j0 < nk; j0 += kWarps * kMmaKeys) {
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const bf16* kp = kb + (j0 + (lane >> 4) * 8 + (lane & 7)) * rs +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        unsigned bb[4];
        ldsm_x4(bb, kp + 16 * ks);
        const unsigned a[4] = {qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3]};
        mma_bf16(sc[0], a, bb);
        mma_bf16(sc[1], a, bb + 2);
      }
      // element e of n-tile nt: row g + 8 (e / 2), key j0 + 8 nt + 2 t4 +
      // e % 2; a masked key weighs 0 outright
      float mx[2] = {kNegInf, kNegInf};
      bool ok[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          const int j = j0 + 8 * nt + 2 * t4 + (e & 1);
          const int key = t0 + j;
          float cg;
          const float x =
              uni[hh] ? 0.f
                      : flash_mma::score_log2(sc[nt][e], scale, softcap, &cg);
          ok[nt][e] = j < nk && key >= rlo[hh] && key < rhi[hh];
          sc[nt][e] = x;
          if (ok[nt][e]) mx[hh] = fmaxf(mx[hh], x);
        }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], flash_mma::quad_max(mx[hh]));
        alpha[hh] = exp2f(m[hh] - m_new);
        m[hh] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hh = e >> 1;
          sc[nt][e] = ok[nt][e] ? exp2f(sc[nt][e] - m[hh]) : 0.f;
          sum[hh] += sc[nt][e];
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        l[hh] = l[hh] * alpha[hh] + flash_mma::quad_sum(sum[hh]);
      const unsigned pa[4] = {flash_mma::pack_bf16(sc[0][0], sc[0][1]),
                              flash_mma::pack_bf16(sc[0][2], sc[0][3]),
                              flash_mma::pack_bf16(sc[1][0], sc[1][1]),
                              flash_mma::pack_bf16(sc[1][2], sc[1][3])};
      const bf16* vp = vb + (j0 + (lane & 15)) * rs + (lane >> 4) * 8;
#pragma unroll
      for (int nt = 0; nt < D / 8; nt += 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[nt][e] *= alpha[e >> 1];
          acc[nt + 1][e] *= alpha[e >> 1];
        }
        unsigned bb[4];
        ldsm_x4_trans(bb, vp + nt * 8);
        mma_bf16(acc[nt], pa, bb);
        mma_bf16(acc[nt + 1], pa, bb + 2);
      }
    }
  }

  __device__ void write(float* w_ml, float* w_acc, int rows, int warp) const {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = g + 8 * hh;
      if (r >= rows) continue;
      if (t4 == 0) {
        w_ml[(warp * rows + r) * 2] = m[hh] * flash_mma::kLn2;
        w_ml[(warp * rows + r) * 2 + 1] = l[hh];
      }
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        w_acc[(warp * rows + r) * D + 8 * nt + 2 * t4] = acc[nt][2 * hh];
        w_acc[(warp * rows + r) * D + 8 * nt + 2 * t4 + 1] =
            acc[nt][2 * hh + 1];
      }
    }
  }
};

// WALK: CoreWalk or MmaWalk; MMA: whether it is MmaWalk (stages of a
// multiple of 16 keys, tails zero-filled).  VERIFY (with VerifyWalk): the
// slot's W-token window, rows (t, g) at positions lengths[b] + t, q and out
// (B, W, Hq, D).  The rank's merged state lies region_bytes into shared
// memory.  The two kernels below are this body with their cluster shapes
// fixed at compile time.
template <typename T, typename WALK, bool MMA, bool VERIFY>
__device__ __forceinline__ void cluster_walk(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, T* __restrict__ out, int hkv, int g_n,
    int d, int page, int width, int n_pool, float scale, int window,
    float softcap, int region_bytes, int n_pos) {
  constexpr int kR = VERIFY ? kVerifyRanks : kRanks;   // CTAs a cluster
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.x / kR;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = ((long long)b * hkv + h) * g_n;  // first q row
  // the query rows: decode's G heads, or the window's n_pos x G (t, g)
  // pairs; row r's q and out row (decode: row0 + r)
  const int q_rows = VERIFY ? n_pos * g_n : g_n;
  auto q_row = [&](int r) {
    return (((long long)b * n_pos + r / g_n) * hkv + h) * g_n + r % g_n;
  };
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* r_ml = reinterpret_cast<float*>(smem_raw + region_bytes);  // R x 2
  float* r_acc = r_ml + (state_floats(q_rows, d, VERIFY) - q_rows * d);
  // the page ids past both the stages and the rank's state
  int* phys_s = reinterpret_cast<int*>(smem_raw + max(
      (int)stage_region(q_rows, d),
      region_bytes + 4 * state_floats(q_rows, d, VERIFY)));          // width

  // The slot's page ids into shared memory, read together with its length
  // (one round trip to device memory, not two): the copies then wait on no
  // global table load.
  const int* table = block_tables + (long long)b * width;
  for (int i = threadIdx.x; i < width; i += kThreads)
    phys_s[i] = min(max(table[i], 0), n_pool - 1);

  // The slot's live keys [lo, hi) (64-bit so that a global layer's window
  // of INT32_MAX cannot overflow) and this rank's share [r_lo, r_hi).
  // A slot with none walks the whole row, every key weighed alike.
  const int length = lengths[b];
  int lo, hi;
  bool uniform;
  if constexpr (VERIFY) {
    // rows t at positions length + t: from the first row's window start to
    // the last row's causal limit; a last row that sees no key (a window
    // wholly past the table) takes the whole table, scored 0
    const long long p_last = (long long)length + n_pos - 1;
    const long long lo_first = (long long)length - window + 1;
    const long long lo_last = p_last - window + 1;
    const int wp = width * page;
    hi = (int)min(p_last + 1, (long long)wp);
    const bool dead_last = (lo_last > 0 ? lo_last : 0) >= hi;
    lo = dead_last || lo_first <= 0 ? 0 : (int)lo_first;
    if (dead_last) hi = wp;
    uniform = false;
  } else {
    const long long lo64 = (long long)length - (long long)window;
    lo = lo64 > 0 ? (int)lo64 : 0;
    hi = min(length, width * page);
    uniform = hi <= lo;
    if (uniform) {
      lo = 0;
      hi = width * page;
    }
  }
  const int n = hi - lo;
  // verify: shares of whole 16-key steps, so that a short window's keys
  // take one rank, not one key on each of eight
  const int share = VERIFY ? ((n + kR - 1) / kR + kMmaKeys - 1) /
                                 kMmaKeys * kMmaKeys
                           : (n + kR - 1) / kR;
  const int r_lo = lo + rank * share;
  const int n_mine = max(min(hi, r_lo + share) - r_lo, 0);

  const int row_bytes = d * (int)sizeof(T);
  const int rs = row_bytes + kPad;      // bytes between shared-memory rows
  const int stage_keys = stage_keys_of(row_bytes, MMA);
  const int n_stages = (n_mine + stage_keys - 1) / stage_keys;
  const int chunks = row_bytes / 16;   // 16-byte pieces of a K or V row
  __syncthreads();

  // Stage s's K and V rows -> buffer s % kStages, one commit group; on
  // tensor cores the rows up to the next multiple of 16 are zero-filled.
  auto issue = [&](int s) {
    unsigned char* kb = smem_raw + (s % kStages) * 2 * kStageBytes;
    unsigned char* vb = kb + kStageBytes;
    const int t0 = r_lo + s * stage_keys;
    const int nk = min(stage_keys, n_mine - s * stage_keys);
    const int rows = MMA ? (nk + kMmaKeys - 1) / kMmaKeys * kMmaKeys : nk;
    for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
      const int t = i / chunks;
      const int c = i - t * chunks;
      const int pos = t0 + min(t, nk - 1);
      const int phys = phys_s[pos / page];
      const long long off =
          (((long long)phys * page + pos % page) * hkv + h) * d;
      const int bytes = t < nk ? 16 : 0;
      flash_mma::cp_async16(kb + t * rs + c * 16,
                            reinterpret_cast<const unsigned char*>(
                                k_pages + off) + c * 16, bytes);
      flash_mma::cp_async16(vb + t * rs + c * 16,
                            reinterpret_cast<const unsigned char*>(
                                v_pages + off) + c * 16, bytes);
    }
    flash_mma::cp_async_commit();
  };
  for (int s = 0; s < kStages && s < n_stages; ++s) issue(s);

  WALK walk;
  if constexpr (VERIFY)
    walk.init(q, q_row, q_rows, g_n, length, window, width * page, lane,
              n_mine > 0);
  else
    walk.init(q, row0, g_n, d, lane, n_mine > 0);
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages)
      flash_mma::cp_async_wait<1>();
    else
      flash_mma::cp_async_wait<0>();
    __syncthreads();
    const T* kb =
        reinterpret_cast<const T*>(smem_raw + (s % kStages) * 2 * kStageBytes);
    const T* vb = kb + kStageBytes / sizeof(T);
    if constexpr (VERIFY)
      walk.stage(kb, vb, rs / (int)sizeof(T),
                 min(stage_keys, n_mine - s * stage_keys),
                 r_lo + s * stage_keys, warp, scale, softcap);
    else
      walk.stage(kb, vb, rs / (int)sizeof(T),
                 min(stage_keys, n_mine - s * stage_keys), g_n, warp, scale,
                 softcap, uniform);
    __syncthreads();   // the buffer is the stage after next's
    if (s + kStages < n_stages) issue(s + kStages);
  }

  // The warps' states meet in the stage region, in warp order: the rank's
  // (m, l) per query and its unnormalized accumulator.
  float* w_ml = reinterpret_cast<float*>(smem_raw);   // kWarps x R x 2
  float* w_acc = w_ml + kWarps * q_rows * 2;          // kWarps x R x D
  if constexpr (VERIFY) {
    walk.write(w_ml, w_acc, q_rows, warp);
    __syncthreads();
    // 16 bytes a thread at a time: the warps' states in warp order, then,
    // after the cluster's barrier, every rank merges a slice of the R x D
    // elements from the live ranks' states in rank order, reading them
    // through distributed shared memory, and writes it (16 rows are eight
    // times decode's G 2: merged by rank 0 alone, they cost as much as
    // the walk)
    const int units = q_rows * d / 4;
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const int g = 4 * u / d;
      const int dd = 4 * u - g * d;
      float mm = kNegInf;
      for (int w = 0; w < kWarps; ++w)
        mm = fmaxf(mm, w_ml[(w * q_rows + g) * 2]);
      float ll = 0.f;
      float4 aa = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(w_ml[(w * q_rows + g) * 2] - mm);
        const float4 a = *reinterpret_cast<const float4*>(
            w_acc + (w * q_rows + g) * d + dd);
        ll += w_ml[(w * q_rows + g) * 2 + 1] * wt;
        aa.x += a.x * wt;
        aa.y += a.y * wt;
        aa.z += a.z * wt;
        aa.w += a.w * wt;
      }
      *reinterpret_cast<float4*>(r_acc + 4 * u) = aa;
      if (dd == 0) {
        r_ml[g * 2] = mm;
        r_ml[g * 2 + 1] = ll;
      }
    }
    cluster.sync();
    const int live = share > 0 ? (n + share - 1) / share : 1;
    const int per = (units + kR - 1) / kR;
    const int u_end = min(units, (rank + 1) * per);
    for (int u = rank * per + threadIdx.x; u < u_end; u += kThreads) {
      const int g = 4 * u / d;
      const int dd = 4 * u - g * d;
      float mr[kR], lr[kR];
      float4 ar[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        mr[r] = kNegInf;
        lr[r] = 0.f;
        ar[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < live) {
          const float* ml = cluster.map_shared_rank(r_ml, r);
          mr[r] = ml[g * 2];
          lr[r] = ml[g * 2 + 1];
          ar[r] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(r_acc, r) + 4 * u);
        }
      }
      float mm = kNegInf;
#pragma unroll
      for (int r = 0; r < kR; ++r) mm = fmaxf(mm, mr[r]);
      float ll = 0.f;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (r >= live) break;
        const float wt = expf(mr[r] - mm);
        ll += lr[r] * wt;
        a.x += ar[r].x * wt;
        a.y += ar[r].y * wt;
        a.z += ar[r].z * wt;
        a.w += ar[r].w * wt;
      }
      const float inv = 1.f / fmaxf(ll, 1e-30f);
      T* o = out + q_row(g) * d + dd;
      store_val(o, a.x * inv);
      store_val(o + 1, a.y * inv);
      store_val(o + 2, a.z * inv);
      store_val(o + 3, a.w * inv);
    }
    cluster.sync();   // no rank leaves while another reads its state
  } else {
    walk.write(w_ml, w_acc, g_n, d, warp, lane);
    __syncthreads();
    for (int i = threadIdx.x; i < g_n * d; i += kThreads) {
      const int g = i / d;
      const int dd = i - g * d;
      float mm = kNegInf;
      for (int w = 0; w < kWarps; ++w)
        mm = fmaxf(mm, w_ml[(w * g_n + g) * 2]);
      float ll = 0.f, aa = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float wt = expf(w_ml[(w * g_n + g) * 2] - mm);
        ll += w_ml[(w * g_n + g) * 2 + 1] * wt;
        aa += w_acc[(w * g_n + g) * d + dd] * wt;
      }
      r_acc[i] = aa;
      if (dd == 0) {
        r_ml[g * 2] = mm;
        r_ml[g * 2 + 1] = ll;
      }
    }

    // Rank 0 merges the ranks that hold keys, in rank order, through
    // distributed shared memory; the others wait until it has read them.
    cluster.sync();
    if (rank == 0) {
      const int live = share > 0 ? (n + share - 1) / share : 1;
      for (int i = threadIdx.x; i < g_n * d; i += kThreads) {
        const int g = i / d;
        // every rank's state read first, so the remote loads are in flight
        // together
        float mr[kR], lr[kR], ar[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          mr[r] = kNegInf;
          lr[r] = ar[r] = 0.f;
          if (r < live) {
            const float* ml = cluster.map_shared_rank(r_ml, r);
            mr[r] = ml[g * 2];
            lr[r] = ml[g * 2 + 1];
            ar[r] = cluster.map_shared_rank(r_acc, r)[i];
          }
        }
        float mm = kNegInf;
#pragma unroll
        for (int r = 0; r < kR; ++r) mm = fmaxf(mm, mr[r]);
        float ll = 0.f, aa = 0.f;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r >= live) break;
          const float wt = expf(mr[r] - mm);
          ll += lr[r] * wt;
          aa += ar[r] * wt;
        }
        store_val(out + row0 * d + i, aa / fmaxf(ll, 1e-30f));
      }
    }
    cluster.sync();
  }
}

template <typename T, typename WALK, bool MMA>
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int hkv, int g_n, int d, int page, int width, int n_pool,
                    float scale, int window, float softcap,
                    int region_bytes) {
  cluster_walk<T, WALK, MMA, false>(q, k_pages, v_pages, block_tables,
                                    lengths, out, hkv, g_n, d, page, width,
                                    n_pool, scale, window, softcap,
                                    region_bytes, 1);
}

template <int D>
__global__ void __cluster_dims__(kVerifyRanks, 1, 1)
    __launch_bounds__(kThreads)
paged_verify_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int hkv, int g_n,
                    int page, int width, int n_pool, float scale, int window,
                    float softcap, int region_bytes, int n_pos) {
  cluster_walk<__nv_bfloat16, VerifyWalk<D>, true, true>(
      q, k_pages, v_pages, tables, lengths, out, hkv, g_n, D, page, width,
      n_pool, scale, window, softcap, region_bytes, n_pos);
}

template <typename T, typename WALK, bool MMA>
int launch_decode(const void* q, const void* k_pages, const void* v_pages,
                  const int* block_tables, const int* lengths, void* out,
                  int batch, int hkv, int g_n, int d, int page, int width,
                  int n_pool, float scale, int window, float softcap,
                  cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  const size_t smem = smem_bytes(g_n, d, width);
  const cudaError_t e =
      allow_smem(paged_decode_kernel<T, WALK, MMA>, smem, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(kRanks * hkv, batch);
  paged_decode_kernel<T, WALK, MMA><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), block_tables, lengths,
      static_cast<T*>(out), hkv, g_n, d, page, width, n_pool, scale, window,
      softcap, (int)stage_region(g_n, d));
  return (int)cudaGetLastError();
}

// The verify launch (bf16, D 64, 128 or 256, W x G <= 16 rows): the same
// grid of clusters, one per (slot, kv head).  The rank's merged state goes
// after the warps' states inside the stage region where both fit (at D
// 128: 33 + 8 KB of the stages' 52 KB), so that shared memory holds back
// no CTA that the registers admit (163 a thread at D 128: three a
// processor, qwen3-0.6b's 256 CTAs in one wave).
template <int D>
int launch_verify(const void* q, const void* k_pages, const void* v_pages,
                  const int* tables, const int* lengths, void* out,
                  int batch, int n_pos, int hkv, int g_n, int page,
                  int width, int n_pool, float scale, int window,
                  float softcap, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  auto kernel = paged_verify_kernel<D>;
  const int rows = n_pos * g_n;
  const size_t stages = (size_t)kStages * 2 * kStageBytes;
  const size_t warps = sizeof(float) * kWarps * rows * (D + 2);
  const size_t state = sizeof(float) * state_floats(rows, D, true);
  const size_t region = stages >= warps + state ? warps
                                                : stage_region(rows, D);
  const size_t smem = (region + state > stage_region(rows, D)
                           ? region + state : stage_region(rows, D)) +
                      sizeof(int) * width;
  static size_t opted_in = 48 * 1024;
  const cudaError_t e = allow_smem(kernel, smem, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(kVerifyRanks * hkv, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), tables, lengths,
      static_cast<bf16*>(out), hkv, g_n, page, width, n_pool, scale, window,
      softcap, (int)region, n_pos);
  return (int)cudaGetLastError();
}

// Whether the verify launch takes a window of n_pos positions x g_n heads.
bool verify_takes(int dtype, int d, int g_n, int n_pos) {
  return dtype == 1 && (d == 64 || d == 128 || d == 256) && g_n >= 1 &&
         n_pos >= 1 && n_pos * g_n <= kMmaKeys;
}

// Head_dim elements per lane: the fewest of 1, 2, 4, 8 that cover d with
// 32 lanes (the wrapper checks that it divides d).
int lane_elems(int d) {
  int epl = 1;
  while (epl < kMaxEpl && 32 * epl < d) epl *= 2;
  return epl;
}

// The kernel family: 1 (tensor cores: bf16 at D 64, 128 or 256), else 0
// (CUDA cores).
int variant(int dtype, int d) {
  return dtype == 1 && (d == 64 || d == 128 || d == 256) ? 1 : 0;
}

#define REPRO_DECODE_ARGS                                                   \
  q, k_pages, v_pages, block_tables, lengths, out, batch, hkv, g_n, d,      \
      page, width, n_pool, scale, window, softcap, stream

template <typename T, int G_MAX>
int dispatch_epl(const void* q, const void* k_pages, const void* v_pages,
                 const int* block_tables, const int* lengths, void* out,
                 int batch, int hkv, int g_n, int d, int page, int width,
                 int n_pool, float scale, int window, float softcap,
                 cudaStream_t stream) {
#define REPRO_DECODE_EPL(N)                                                 \
  if (lane_elems(d) == N)                                                   \
    return launch_decode<T, CoreWalk<T, G_MAX, N>, false>(REPRO_DECODE_ARGS);
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
             int batch, int hkv, int g_n, int d, int page, int width,
             int n_pool, float scale, int window, float softcap,
             cudaStream_t stream) {
  if (g_n <= 2) return dispatch_epl<T, 2>(REPRO_DECODE_ARGS);
  return dispatch_epl<T, kMaxG>(REPRO_DECODE_ARGS);
}

}  // namespace

extern "C" {

// Limits the wrapper reads before it launches.
int paged_decode_max_g() { return kMaxG; }
int paged_decode_max_d() { return 32 * kMaxEpl; }
int paged_decode_variant(int dtype, int d) { return variant(dtype, d); }

// dtype: 0 = float32, 1 = bfloat16.  softcap <= 0 means no softcap; a
// window of INT32_MAX means a global layer.  Returns cudaGetLastError().
int paged_decode(int dtype, const void* q, const void* k_pages,
                 const void* v_pages, const int* block_tables,
                 const int* lengths, void* out, int batch, int hkv, int g_n,
                 int d, int page, int width, int n_pool, float scale,
                 int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_n < 1 || g_n > kMaxG || d > 32 * kMaxEpl || d % lane_elems(d) ||
      (d * (dtype == 0 ? 4 : 2)) % 16)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || hkv == 0) return 0;
  using bf16 = __nv_bfloat16;
  if (variant(dtype, d) == 1) {
    if (d == 64) return launch_decode<bf16, MmaWalk<64>, true>(
        q, k_pages, v_pages, block_tables, lengths, out, batch, hkv, g_n, d,
        page, width, n_pool, scale, window, softcap, s);
    if (d == 128) return launch_decode<bf16, MmaWalk<128>, true>(
        q, k_pages, v_pages, block_tables, lengths, out, batch, hkv, g_n, d,
        page, width, n_pool, scale, window, softcap, s);
    return launch_decode<bf16, MmaWalk<256>, true>(
        q, k_pages, v_pages, block_tables, lengths, out, batch, hkv, g_n, d,
        page, width, n_pool, scale, window, softcap, s);
  }
  if (dtype == 0)
    return dispatch<float>(q, k_pages, v_pages, block_tables, lengths, out,
                           batch, hkv, g_n, d, page, width, n_pool, scale,
                           window, softcap, s);
  if (dtype == 1)
    return dispatch<bf16>(q, k_pages, v_pages, block_tables, lengths, out,
                          batch, hkv, g_n, d, page, width, n_pool, scale,
                          window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

// The speculative-verify entry's cluster family: q and out (B, W, Hq, D)
// bf16, slot b's window at positions lengths[b] + t, tables (B, width).
// paged_verify_cluster_takes says which shapes it takes (bf16, D 64, 128
// or 256, W x G <= 16); the rest go to paged_prefill.cu's paged_verify.
// No scratch.  Returns cudaGetLastError().
int paged_verify_cluster_takes(int dtype, int d, int g_n, int n_pos) {
  return verify_takes(dtype, d, g_n, n_pos);
}

int paged_verify_cluster(const void* q, const void* k_pages,
                         const void* v_pages, const int* tables,
                         const int* lengths, void* out, int batch, int n_pos,
                         int hq, int hkv, int d, int page, int width,
                         int n_pool, float scale, int window, float softcap,
                         void* stream) {
  if (hkv < 1 || hq % hkv || !verify_takes(1, d, hq / hkv, n_pos))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = d == 64    ? launch_verify<64>
                : d == 128 ? launch_verify<128>
                           : launch_verify<256>;
  return launch(q, k_pages, v_pages, tables, lengths, out, batch, n_pos, hkv,
                hq / hkv, page, width, n_pool, scale, window, softcap, s);
}

}  // extern "C"
