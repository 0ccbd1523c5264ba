// Dense flash attention for Hopper: the bf16 forward at D 64, 112, 128 and
// 256 and backward at D 64, 112 and 128 on wgmma, with TMA loads, a
// producer warp and a persistent grid (flash_wgmma256.cuh has the backward
// at D 256).
//
// Replaces src/repro/kernels/attention/attention.py:72
// flash_attention_pallas (fwd_kernel), and for the backward its gradient
// (dq_kernel and dkv_kernel: the JAX package has no backward kernel, XLA
// differentiates its jnp attention).  flash_fwd.cu and flash_bwd.cu give
// the function, the layouts and the masks.  Both take Sq query positions
// against Sk keys (a cross-attention when they differ).
//
// What bounds them: operations.  The causal forward does
// 4 B Hq S (S + 1) / 2 D flops: 137 GFLOP at the training shape (B 2,
// Hq 16, S 4096, D 128), 0.139 ms at 989 TFLOP/s bf16.  The backward's
// two passes do 7 products of that size, 3.5 times the forward (0.49 ms),
// where a backward that adds dQ up with atomics does 5 (2.5 times,
// 0.35 ms): recomputing two products buys a dQ that is bitwise the same
// on every call.
//
// What the design does about it:
//  * every product is wgmma (m64nNk16, bf16 in, f32 accumulation), the
//    only way to the tensor cores' full rate.  S = Q K^T reads both
//    operands from shared memory (K-major); O += P V takes P from
//    registers, converted to bf16 in place (S's accumulator layout is the
//    A operand's), and V from shared memory as an MN-major operand (the
//    transpose bit);
//  * a CTA is two consumer warpgroups of 64 rows each (128 query rows, or
//    128 keys in the dK/dV pass) and one producer warp that issues every
//    load by TMA into a ring of stages guarded by mbarriers: full barriers
//    for the consumers, empty ones (one arrival per consumer warp) for the
//    producer.  setmaxnreg moves registers from the producer's warpgroup
//    to the consumers;
//  * the forward walks 128-key tiles, and each K/V tile serves the G
//    query heads of its kv head: a 4-D tensor map (D, H, S, B) with box
//    (64, G, bq, 1) brings the G heads x bq = 128 / G positions of a query
//    block in one request, position-major (row r is head r % G at
//    position c0 + r / G); a G that does not divide 128 leaves rows
//    unused.  The 128-byte swizzle caps a box at 64 columns, so a D-128
//    row comes in two boxes, stored as two column blocks;
//  * D 112 (zamba2's shared block) runs the D-128 kernels padded: the
//    tensor maps keep the tensor's 112 columns (a 224-byte row, a
//    multiple of 16), so the second 64-column box of Q, K, V and dO comes
//    with columns 112-127 zero-filled by TMA.  Zero columns add nothing to
//    Q K^T, dO V^T or the products that sum over D, and every layout,
//    descriptor and expected byte count stays the D-128 one (TMA counts a
//    box's zero-filled bytes, as it does for rows past S).  The epilogues
//    store the 112 true columns at a 112-element row stride.  It costs
//    128 / 112 = 1.14 times the products the true width needs;
//  * D 256 (gemma2-2b) runs the forward with tiles of its own
//    (FwdTraits<256>): each warpgroup holds a 64 x 256 f32 O (128
//    registers a thread), so it walks 64-key tiles (S 32 registers, P 16 as
//    bf16), takes 240 registers a consumer thread, and writes O through
//    shared memory (the epilogue staging below) in 16-byte stores;
//  * TMA zero-fills rows past Sq (queries) or Sk (keys: the K and V maps
//    span Sk rows a batch element, which a cross-attention sets apart from
//    Sq), so the ragged last tile needs no predicated loads (the mask
//    still applies);
//  * within a warpgroup, the forward issues tile i's S = Q K^T together
//    with tile i - 1's O += P V and runs tile i's softmax while that
//    product is in flight (the dQ pass likewise overlaps tile i's S and dP
//    with tile i - 1's dQ += dS K); K and V of a stage are freed by
//    separate barriers, as soon as the last product reading each lands;
//  * the grid is persistent: one CTA per SM walks (block, kv head, batch)
//    items, longest key (or query) range first, in rounds of gridDim.x
//    taken in alternating directions (a snake), so that no CTA takes the
//    longest item of every round; the producer runs ahead into the next
//    item while the consumers finish one;
//  * as in the mma.sync kernels (flash_mma.cuh, whose softmax and mask
//    helpers these reuse): only the tiles the masks leave are walked,
//    element masks only on partly visible tiles, the softmax in the log2
//    domain, a finite -1e30 initial max with masked keys weighing 0;
//  * a whole-sequence call whose items fill few of the card's processors
//    (seamless-m4t-medium's cross-attention: 64 items, each walking 1024
//    keys alone on half the card) takes the split family instead of the
//    persistent grid: the forward's and the dQ pass's bodies with RANKS
//    2 (4 in a copy built with FLASH_MAX_RANKS 4), one cluster an item,
//    the ranks walking contiguous shares of its key tiles and merging
//    through distributed shared memory in rank order (in the forward the
//    two consumer groups take turns to issue products); the split dQ
//    pass also forms Delta (the section "key splits over a cluster"
//    below says how).
//
// The backward takes two passes and no atomics, so every sum has a fixed
// order.  dq_kernel walks 64-key tiles per query block like the forward
// (S and dP = dO V^T, then dQ += dS K; three accumulators of 128 keys
// would not fit in registers); dkv_kernel holds 128 keys and walks the G
// heads and the 64-query tiles that see them (S^T = K Q^T, dP^T = V dO^T,
// dV += P^T dO, dK += dS^T Q), so dK and dV sum over the G heads in
// registers.  Its producer warp also copies each query tile's 64 floats of
// log-sum-exp and Delta into the stage with plain loads (zero past Sq):
// a 1-D TMA box of them would start at an address that is not 16-byte
// aligned for most Sq, and ran past the array at its end.  A key block
// that no query sees (past Sq under the causal mask, or out of every
// window, where Sq < Sk) is an item with no query tile: neither side
// touches its K/V stage, and its dK and dV rows are stored as zeros.
//
// Key blocks (the template flag KB; sequence-parallel attention): the
// keys are one block of a longer sequence, key j at position k_off + j,
// the queries at 0 .. Sq - 1.  Only the masks see the offset, so the
// kernels shift the positions they compare (query positions by -k_off in
// the forward and the dQ pass, key positions by +k_off in the dK/dV
// pass) and keep every address as it is; with KB false the shift is the
// constant 0 and the kernels are the whole-sequence ones.  A query block
// that sees no key of the block is an item with no tile: neither side
// touches its stages, and its rows are stored as zeros (the forward's
// log-sum-exp as -inf).  The forward writes O in f32 and the dQ pass dQ
// in f32: partials that the ranks' merge adds before it rounds once.
//
// Ablations (launch.flash_bench --ablate builds copies of the flash
// libraries with one of these defined; they compute garbage):
// FLASH_ABLATE_NO_PRODUCTS skips every wgmma product, FLASH_ABLATE_NO_LOADS
// every TMA load (its barriers complete by a plain arrival),
// FLASH_ABLATE_NO_MERGE the ranks' merge (partials staged, the cluster's
// barriers kept, nothing read or stored), FLASH_ABLATE_NO_WALK every
// rank's share of the key tiles.  Undefined, they leave the source as is.
#pragma once

#include <cuda.h>   // CUtensorMap and the types of cuTensorMapEncodeTiled

#include <type_traits>

#include "flash_mma.cuh"

namespace flash_wgmma {

using namespace paged;
using flash_mma::bf16;

constexpr int kConsumers = 2;                    // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1); // + the producer's group
constexpr int kRows = 64 * kConsumers;           // query rows or keys
constexpr int kStages = 2;     // forward; the dQ and dK/dV passes take 3
constexpr int kTkFwd = 128;   // keys per tile, forward
constexpr int kTkDq = 64;     // keys per tile, dQ pass
constexpr int kTqDkv = 64;    // queries per tile, dK/dV pass
constexpr int kArrivals = 4 * kConsumers;        // one per consumer warp
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// A wait this long (about ten seconds) is a fault: trap, do not hang.
constexpr long long kHangCycles = 1ll << 34;

// Calls f(std::integral_constant<int, D>{}) for a head_dim D the kernels
// take (64, 112 and 128: the one list of them) and returns what f returns;
// `otherwise` for any other d.
template <class F>
int dispatch_d(int d, F&& f, int otherwise) {
  switch (d) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
  }
  return otherwise;
}

inline bool takes(int d) {
  return dispatch_d(d, [](auto) { return 1; }, 0);
}

// The width a kernel for the true head_dim DT lays out and multiplies in
// shared memory: whole 64-column boxes (112 -> 128).
__host__ __device__ constexpr int padded(int dt) {
  return (dt + 63) / 64 * 64;
}

// ---------------------------------------------------------------------------
// mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
#ifdef FLASH_ABLATE_NO_LOADS  // a plain arrival: no load completes bytes
  (void)bytes;
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
  return;
#endif
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Expect `bytes` more of TMA traffic on the barrier's phase, no arrival.
__device__ __forceinline__ void mbar_add_tx(uint32_t bar, uint32_t bytes) {
#ifdef FLASH_ABLATE_NO_LOADS
  return;
#endif
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
#ifdef FLASH_ABLATE_NO_LOADS
  if (c0 < 0)
#endif
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this thread's committed product groups are in
// flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tell the compiler that the asynchronous products may have written the
// accumulators up to here, so it reads them only after the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor with the 128-byte swizzle that the TMA
// loads write.  Tiles are stored as column blocks of R rows x 64 bf16 (128
// bytes a row, 8-row atoms of 1024 bytes, each block 1024-byte aligned).
//  * K-major (S = Q K^T and its kin: the reduction runs along the row):
//    sbo = 1024 (the next 8 rows), lbo unused; the k-th 16-column step
//    starts 32 k bytes into the block, then moves to the next block.
//  * MN-major (P V and its kin: the reduction runs down the rows, N along
//    them): sbo = 1024 (the next 8 reduction rows), lbo = R x 128 (the next
//    64 of N, in the next column block); the k-th 16-row step starts
//    16 x 128 k bytes in.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)(1024u >> 4) << 32) | (1ull << 62);
}

// The A operand of k-step `ks` of a product whose A is a 64 x 16 slice of
// an R-row tile at `tile`, rows from `row0` (K-major).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int row0,
                                           int ks) {
  return sw128_desc(tile + (ks >> 2) * rows * 128 + row0 * 128 + (ks & 3) * 32,
                    16);
}

// The MN-major B operand of k-step `ks` (16 rows of an R-row tile).
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int ks) {
  return sw128_desc(tile + ks * 16 * 128, rows * 128);
}

// d (64 x 32, f32) {=, +=} A (64 x 16) B^T (B 32 x 16), both bf16 from
// shared memory through K-major descriptors.
__device__ __forceinline__ void mma_ss_n32(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) {=, +=} A (64 x 16) B^T (B 64 x 16), both bf16 from
// shared memory through K-major descriptors.
__device__ __forceinline__ void mma_ss_n64(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128, f32) {=, +=} A (64 x 16) B^T (B 128 x 16), both bf16 from
// shared memory through K-major descriptors.
__device__ __forceinline__ void mma_ss_n128(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers: a[4] per thread, the
// accumulator layout of a product packed in pairs) B (16 x 64, bf16 in
// shared memory through an MN-major descriptor: the transpose bit).
__device__ __forceinline__ void mma_rs_n64(float* d, const unsigned* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers: a[4] per thread, the
// accumulator layout of a product packed in pairs) B (16 x 128, bf16 in
// shared memory through an MN-major descriptor: the transpose bit).
__device__ __forceinline__ void mma_rs_n128(float* d, const unsigned* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}


// d (64 x 256, f32) += A (64 x 16, bf16 in registers: a[4] per thread, the
// accumulator layout of a product packed in pairs) B (16 x 256, bf16 in
// shared memory through an MN-major descriptor: the transpose bit).
__device__ __forceinline__ void mma_rs_n256(float* d, const unsigned* a,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 256, f32) += A (64 x 16) B (16 x 256): A K-major and B MN-major
// (the transpose bit), both bf16 from shared memory through descriptors.
__device__ __forceinline__ void mma_ss_n256_tb(float* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63, "
      " %64, %65, %66, %67, %68, %69, %70, %71, "
      " %72, %73, %74, %75, %76, %77, %78, %79, "
      " %80, %81, %82, %83, %84, %85, %86, %87, "
      " %88, %89, %90, %91, %92, %93, %94, %95, "
      " %96, %97, %98, %99, %100, %101, %102, %103, "
      " %104, %105, %106, %107, %108, %109, %110, %111, "
      " %112, %113, %114, %115, %116, %117, %118, %119, "
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma_ss(float* d, uint64_t da, uint64_t db,
                                       int accumulate) {
  if constexpr (N == 32)
    mma_ss_n32(d, da, db, accumulate);
  else if constexpr (N == 64)
    mma_ss_n64(d, da, db, accumulate);
  else
    mma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void mma_rs(float* d, const unsigned* a,
                                       uint64_t db) {
  if constexpr (N == 64)
    mma_rs_n64(d, a, db, 1);
  else if constexpr (N == 128)
    mma_rs_n128(d, a, db, 1);
  else
    mma_rs_n256(d, a, db, 1);
}

// d (64 x N) {=, +=} the 64 rows from row0 of tile a (R_A rows) times the
// rows of tile b (N rows) transposed, over the D features: S = Q K^T.
template <int D, int N>
__device__ __forceinline__ void product_abt(float* d, uint32_t a, int r_a,
                                            int row0, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#ifdef FLASH_ABLATE_NO_PRODUCTS
    if (r_a < 0)
#endif
    mma_ss<N>(d, desc_k(a, r_a, row0, ks), desc_k(b, N, 0, ks), ks > 0);
}

// The f32 accumulator p of a 64 x K product as the bf16 A operand of K / 16
// k-steps (the accumulator layout is the A operand's, in pairs).
template <int K>
__device__ __forceinline__ void pack_a(const float* p, unsigned (*a)[4]) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[ks][j] = flash_mma::pack_bf16(p[8 * ks + 2 * j], p[8 * ks + 2 * j + 1]);
}

// d (64 x D) += P (64 x K, bf16 A fragments a) times the K rows of tile b
// (D wide): O += P V.
template <int D, int K>
__device__ __forceinline__ void product_ab(float* d, const unsigned (*a)[4],
                                          uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks)
#ifdef FLASH_ABLATE_NO_PRODUCTS
    if (b == 0u)
#endif
    mma_rs<D>(d, a[ks], desc_mn(b, K, ks));
}

// As product_ab, with P the f32 accumulator of a product, rounded to bf16.
template <int D, int K>
__device__ __forceinline__ void product_pb(float* d, const float* p,
                                           uint32_t b) {
  unsigned a[K / 16][4];
  pack_a<K>(p, a);
  product_ab<D, K>(d, a, b);
}

// The item this CTA takes in round r of the persistent grid: rounds of
// gridDim.x items, CTA c taking the c-th of an even round and the c-th from
// the end of an odd one, so that with items sorted longest first no CTA
// takes the longest of every round.
__device__ __forceinline__ int item_index(int r) {
  const int c = (r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  return r * gridDim.x + c;
}

// The (block, kv head, batch element) items of a persistent grid, item
// `it` of n_blk x hb (hb = Hkv x B), blocks in the order `descending` says.
struct Item {
  int blk, h, b;
};

__device__ __forceinline__ Item item_at(int it, int n_blk, int hkv, int hb,
                                        bool descending) {
  const int slot = it / hb, rest = it - slot * hb;
  return {descending ? n_blk - 1 - slot : slot, rest % hkv, rest / hkv};
}

// Keys [k_lo, k_lo + n_tiles * tk) some row of the query block at c0 may
// see (the last tile may run past them: masked).  k_lim is the key count
// Sk, or min(Sq, Sk) under the causal mask: no row sees a key past the
// last query position.  (One bound computed on the host keeps this the
// expression of the kernel that took one length: with a second min
// against Sk here, ptxas scheduled the forward's wgmma products slower at
// the training shape; PERF.md section 6.)
__host__ __device__ __forceinline__ void key_range(int c0, int bq, int k_lim,
                                                   int causal, int window,
                                                   int tk, int* k_lo,
                                                   int* k_hi, int* n_tiles) {
  const long long lo = (long long)c0 - (long long)window + 1;
  *k_lo = lo > 0 ? (int)lo : 0;
  *k_hi = causal ? min(c0 + bq, k_lim) : k_lim;
  *n_tiles = (*k_hi - *k_lo + tk - 1) / tk;
}

// Queries [q_lo, q_hi) of the sq that may see some key of the block at
// k0 (of sk keys), and the 64-query tiles over them: none when the block
// lies past every query's keys (q_hi <= q_lo: past Sq under the causal
// mask, or beyond every window, where Sq < Sk).
// The keys sit at positions shift + k0 .. (a key block's offset; 0 for
// a whole sequence).
__device__ __forceinline__ void query_range(int k0, int sq, int sk,
                                            int causal, int window,
                                            int shift, int* q_lo, int* q_hi,
                                            int* n_tiles) {
  const int k_last = min(k0 + kRows, sk) - 1 + shift;
  const long long hi = (long long)k_last + (long long)window;
  *q_lo = causal ? k0 + shift : 0;
  *q_hi = hi < sq ? (int)hi : sq;
  *n_tiles = *q_hi > *q_lo ? (*q_hi - *q_lo + kTqDkv - 1) / kTqDkv : 0;
}

// key_range for the query block at c0 of a kernel with the key-block flag
// KB: the block's rows compare at c0 - shift, and a range that holds no
// key has no tile (with KB false, key_range as it is).
template <bool KB>
__device__ __forceinline__ void block_key_range(int c0, int shift, int bq,
                                                int k_lim, int causal,
                                                int window, int tk,
                                                int* k_lo, int* k_hi,
                                                int* n_tiles) {
  key_range(c0 - shift, bq, k_lim, causal, window, tk, k_lo, k_hi, n_tiles);
  if (KB && *k_hi <= *k_lo) *n_tiles = 0;
}

// A kernel's f32 output under the key-block flag, else its bf16 one.
template <bool KB>
using OutT = std::conditional_t<KB, float, bf16>;

// Two adjacent columns of a row of O or dQ.
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ uint32_t aligned_smem_base(const void* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// The consumer's rows: this thread's two rows (g and g + 8 of its warp's
// 16) of the CTA's 128, position-major over the block at c0.  pos is the
// position the masks compare, the row's position less `shift` (a key
// block's offset; 0 for a whole sequence): row r of the tensors sits at
// pos + shift.
struct Rows {
  int r[2], pos[2];
  bool live[2];
  int p_min, p_max;
};

__device__ __forceinline__ Rows rows_of(int r0, int c0, int g_n, int bq,
                                        int sq, int shift) {
  Rows w;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    w.r[hh] = r0 + 8 * hh;
    w.pos[hh] = c0 + w.r[hh] / g_n - shift;
    w.live[hh] = w.r[hh] < g_n * bq && c0 + w.r[hh] / g_n < sq;
  }
  // the positions of the warp's 16 rows (unused rows only widen them)
  w.p_min = __reduce_min_sync(0xffffffffu, min(w.pos[0], w.pos[1]));
  w.p_max = __reduce_max_sync(0xffffffffu, max(w.pos[0], w.pos[1]));
  return w;
}

// ---------------------------------------------------------------------------
// epilogue staging (D 256)
// ---------------------------------------------------------------------------

// At D 256 the forward's O and the dQ pass's dQ go out through shared
// memory: a warpgroup writes its accumulator, row-scaled, into 64-row x
// 128-byte pieces whose 16-byte units are swizzled by the row (unit u of
// row r at u ^ (r % 8), so neither the fragment writes nor the row reads
// conflict), then copies each row out in 16-byte stores, 128 contiguous
// bytes for every 8 threads.

constexpr int kD256 = 256;
constexpr int kPiece = 64 * 128;   // an epilogue piece: 64 rows x 128 bytes

__device__ __forceinline__ void st_shared_pair(uint32_t addr, float a,
                                               float b, float) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a),
               "f"(b)
               : "memory");
}

__device__ __forceinline__ void st_shared_pair(uint32_t addr, float a,
                                               float b, bf16) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(flash_mma::pack_bf16(a, b))
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Columns of T a piece row holds: 32 f32 or 64 bf16.
template <class T>
constexpr int kPieceCols = 128 / (int)sizeof(T);

// Byte offset of 16-byte unit u of row rl in a piece (the row's swizzle).
__device__ __forceinline__ uint32_t piece_at(int rl, int u) {
  return rl * 128 + ((u ^ (rl & 7)) << 4);
}

// Piece p of a warpgroup's 64 x 256 accumulator (columns p kPieceCols<T>
// ..), each row times mul[hh], into the piece at `piece`: this thread's
// rows g and g + 8 of its warp's 16, columns 8 nt + 2 (lane % 4) and the
// next.  Called in unrolled loops, so that p is a constant and acc stays
// in registers.
template <class T>
__device__ __forceinline__ void stage_piece(uint32_t piece, const float* acc,
                                            int p, const float* mul,
                                            int warp, int lane) {
  constexpr int NT = kPieceCols<T> / 8;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = warp * 16 + g + 8 * hh;
      const int byte = (j * 8 + 2 * t4) * (int)sizeof(T);
      const int nt = p * NT + j;
      st_shared_pair(piece + piece_at(rl, byte >> 4) + (byte & 15),
                     acc[4 * nt + 2 * hh] * mul[hh],
                     acc[4 * nt + 2 * hh + 1] * mul[hh], T{});
    }
}

// 16-byte unit u of the piece's columns col0 .. of output row orow.
template <class T>
__device__ __forceinline__ void store_unit(T* out, long long orow, int col0,
                                           int u, uint4 v) {
  *reinterpret_cast<uint4*>(out + orow * kD256 + col0 +
                            u * (16 / (int)sizeof(T))) = v;
}

// Piece p out to its columns of the warpgroup's rows: thread t copies unit
// t % 8 of rows (t / 8) + 16 i, orow[i] being that row's index into the
// (.., 256) output, or -1 where the row is not stored.
template <class T>
__device__ __forceinline__ void copy_piece(uint32_t piece, T* out, int p,
                                           const long long* orow, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = (tid >> 3) + 16 * i, u = tid & 7;
    if (orow[i] < 0) continue;
    store_unit(out, orow[i], p * kPieceCols<T>, u,
               ld_shared16(piece + piece_at(rl, u)));
  }
}

// The output rows of the query block at c0 (position-major over G heads)
// that thread tid of warpgroup wg copies (see stage_piece): row r of the
// CTA is head h G + r % G at position c0 + r / G.
__device__ __forceinline__ void out_rows(long long* orow, int wg, int tid,
                                         int c0, int g_n, int bq, int sq,
                                         int hq, const Item& w) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 64 * wg + (tid >> 3) + 16 * i;
    const int pos = c0 + r / g_n;
    orow[i] = r < g_n * bq && pos < sq
                  ? ((long long)w.b * sq + pos) * hq + w.h * g_n + r % g_n
                  : -1;
  }
}

// ---------------------------------------------------------------------------
// key splits over a cluster (the split families, kernels 5x and 5bx)
// ---------------------------------------------------------------------------

// Where the (block, kv head, batch) items of a whole-sequence call fill
// few of the card's processors (seamless-m4t-medium's cross-attention: 64
// items), the forward and the dQ pass take the split families: a grid of
// (RANKS, items) CTAs in clusters of RANKS along x, one cluster an item,
// whose ranks walk contiguous shares of the item's key tiles with the
// bodies above and merge their partials through distributed shared memory
// in rank order (so every sum keeps a fixed order), then store once.  No
// f32 partial goes to device memory.  The rank count is fixed at compile
// time, one __global__ wrapper per count over one __device__ body (a
// runtime cluster attribute cost kernels 1 and 3 1-2.5%); the host picks
// it (split_ranks).  The library's clusters are of 2 ranks: clusters of 4
// lost to 2 at seamless's cross shape (256 CTAs in two waves), and a GPC
// need not hold the items' clusters of 4 at once where they fit the SMs.
// launch.flash_bench --ablate times a copy built with FLASH_MAX_RANKS 4.
#ifndef FLASH_MAX_RANKS
#define FLASH_MAX_RANKS 2
#endif
constexpr int kMaxRanks = FLASH_MAX_RANKS;
constexpr int kMergeBar = 3;   // named barrier of the two consumer groups
constexpr int kTurnBar = 4;    // 4 + g: consumer group g's turn to issue

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// Every thread of the cluster that has not exited; not aligned, so a
// warp's lanes may arrive apart (the producer's idle lanes come early).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address of this CTA's shared-memory word `addr` in rank r's.
__device__ __forceinline__ uint32_t rank_addr(uint32_t addr, int r) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(r));
  return out;
}

__device__ __forceinline__ float4 ld_rank16(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_rank8(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// The split forward's two consumer groups take turns issuing their
// products (take_turn waits for this group's, pass_turn hands it to the
// other), so that one group's softmax runs while the other's products do:
// otherwise both wait on the same stages and reach their softmax together
// (0.0130 -> 0.0122 ms at seamless's cross shape; the same turns in the
// dQ and dK/dV passes moved nothing and were not kept: PERF.md section 6).
// Group 1 hands group 0 its first turn (first_turn), and group 0 takes
// the one turn left over at the end (last_turn).  No-ops on the
// persistent grid.
template <int RANKS>
__device__ __forceinline__ void take_turn(int wg) {
  if constexpr (RANKS > 1) bar_sync(kTurnBar + wg, kConsumers * 128);
}

template <int RANKS>
__device__ __forceinline__ void pass_turn(int wg) {
  if constexpr (RANKS > 1) bar_arrive(kTurnBar + 1 - wg, kConsumers * 128);
}

template <int RANKS>
__device__ __forceinline__ void first_turn(int wg) {
  if constexpr (RANKS > 1)
    if (wg == 1) bar_arrive(kTurnBar, kConsumers * 128);
}

template <int RANKS>
__device__ __forceinline__ void last_turn(int wg) {
  if constexpr (RANKS > 1)
    if (wg == 0) bar_sync(kTurnBar, kConsumers * 128);
}

// This rank's share of an item's *n_tiles key tiles: a contiguous
// ceil(n / RANKS) of them from the returned first; *n_tiles becomes its
// count (0 for a rank past the item's last tile).
template <int RANKS>
__device__ __forceinline__ int rank_share(int rank, int* n_tiles) {
  const int share = (*n_tiles + RANKS - 1) / RANKS;
  const int first = min(rank * share, *n_tiles);
#ifdef FLASH_ABLATE_NO_WALK
  *n_tiles = 0;
#else
  *n_tiles = min(*n_tiles, first + share) - first;
#endif
  return first;
}

// The item a CTA takes in round r: the persistent grid's (item_index), or
// under a split one item a cluster, blockIdx.y (rounds past it: none).
template <int RANKS>
__device__ __forceinline__ int item_of(int r, int n_items) {
  if constexpr (RANKS == 1)
    return item_index(r);
  else
    return r == 0 ? (int)blockIdx.y : n_items;
}

// A rank's partial in its own shared memory, over its key stages once its
// walk is done: the 128 rows' f32 accumulators at a row stride of D + 8
// floats (the fragments' 8-byte writes and the merge's 16-byte reads meet
// no bank twice), then each row's (m, l).
template <int D>
struct Partial {
  static constexpr int kStride = D + 8;
  static constexpr int kMl = kRows * kStride * 4;
  static constexpr int kBytes = kMl + kRows * 8;
};

// This thread's two rows of acc (and, with ML, their m and l) into the
// partial at `at`.
template <int D, bool ML>
__device__ __forceinline__ void stage_partial(uint32_t at, const float* acc,
                                              const Rows& rw, const float* m,
                                              const float* l, int t4) {
  using P = Partial<D>;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rw.r[hh];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      st_shared_pair(at + (r * P::kStride + 8 * nt + 2 * t4) * 4,
                     acc[4 * nt + 2 * hh], acc[4 * nt + 2 * hh + 1], 0.f);
    if (ML && t4 == 0) st_shared_pair(at + P::kMl + r * 8, m[hh], l[hh], 0.f);
  }
}

// Row r's output row and head of the query block at c0 (position-major
// over the G heads of kv head w.h), or -1 where the row holds no query.
__device__ __forceinline__ long long out_row(int r, int c0, int g_n, int bq,
                                             int sq, int hq, const Item& w,
                                             int* head) {
  const int pos = c0 + r / g_n;
  *head = w.h * g_n + r % g_n;
  return r < g_n * bq && pos < sq
             ? ((long long)w.b * sq + pos) * hq + *head
             : -1;
}

// Four bf16 of an output row from f32.
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// What the forward's shape takes at the width D it multiplies: keys a
// tile, the registers setmaxnreg gives the producer's warpgroup and the
// consumers, the softcap's tanh (FAST: flash_mma::score_log2_fast) and the
// epilogue (STAGED: O through shared-memory pieces, kOut bytes of them;
// else straight from the accumulator fragments).
template <int D>
struct FwdTraits {
  static constexpr int kTk = kTkFwd;
  static constexpr int kProducerRegs = ::flash_wgmma::kProducerRegs;
  static constexpr int kConsumerRegs = ::flash_wgmma::kConsumerRegs;
  static constexpr bool kFast = false, kStaged = false;
  static constexpr int kOut = 0;
};

// D 256 (gemma2-2b): 64-key tiles, so that S is 32 registers and P 16
// beside a 64 x 256 f32 O of 128; 240 registers a consumer thread and 24
// for the producer's warpgroup (2 x 128 x 240 + 128 x 24 = 64,512 of
// 65,536); shared memory Q 64 KB + two stages of K + V at 64 KB + two
// pieces a warpgroup (32 KB) = 224 KB.  The f32 O of a key block
// (128 x 256 x 4 = 128 KB a CTA) goes out in 16-byte stores, 128
// contiguous bytes for every 8 threads, where the fragment-wise stores
// wrote 8 bytes at a time.
template <>
struct FwdTraits<kD256> {
  static constexpr int kTk = 64;
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static constexpr bool kFast = true, kStaged = true;
  static constexpr int kOut = kConsumers * 2 * kPiece;
};

template <int D>
struct FwdSmem {
  static constexpr int kQ = 0;                       // kRows x D
  static constexpr int kTile = FwdTraits<D>::kTk * D * 2;   // a K or V tile
  static constexpr int kK = kQ + kRows * D * 2;      // kStages K tiles
  static constexpr int kV = kK + kStages * kTile;    // kStages V tiles
  static constexpr int kOut = kV + kStages * kTile;  // the staged epilogue's
  static constexpr int kBar = kOut + FwdTraits<D>::kOut;
  // q_full, q_empty, then k_full, v_full, k_empty, v_empty per stage
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kStages) + 1024;
};

// The split forward's merge: rank `rank` of RANKS takes rows [rank 128 /
// RANKS, ..) of the block, 4 true columns a thread at a time, and weighs
// every rank's partial (from the partials at `at` in each rank's shared
// memory) by exp2(m_r - max m), in rank order, into one O rounded once and
// the row's log-sum-exp.
template <int DT, int RANKS>
__device__ __forceinline__ void merge_fwd(uint32_t at, int rank, bf16* o,
                                          float* lse, int c0, int g_n,
                                          int bq, int sq, int hq,
                                          const Item& w) {
  constexpr int D = padded(DT), U = DT / 4, kPer = kRows / RANKS;
  using P = Partial<D>;
  uint32_t src[RANKS];
#pragma unroll
  for (int q = 0; q < RANKS; ++q) src[q] = rank_addr(at, q);
#ifdef FLASH_ABLATE_NO_MERGE
  if (rank < 0)
#endif
  for (int u = threadIdx.x; u < kPer * U; u += kConsumers * 128) {
    const int r = rank * kPer + u / U, f = 4 * (u % U);
    int head;
    const long long orow = out_row(r, c0, g_n, bq, sq, hq, w, &head);
    if (orow < 0) continue;
    float mr[RANKS], lr[RANKS];
    float4 ar[RANKS];
#pragma unroll
    for (int q = 0; q < RANKS; ++q) {
      const float2 ml = ld_rank8(src[q] + P::kMl + r * 8);
      mr[q] = ml.x;
      lr[q] = ml.y;
      ar[q] = ld_rank16(src[q] + (r * P::kStride + f) * 4);
    }
    float mm = mr[0];
#pragma unroll
    for (int q = 1; q < RANKS; ++q) mm = fmaxf(mm, mr[q]);
    float ll = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < RANKS; ++q) {
      const float x = exp2f(mr[q] - mm);
      ll += lr[q] * x;
      a.x += ar[q].x * x;
      a.y += ar[q].y * x;
      a.z += ar[q].z * x;
      a.w += ar[q].w * x;
    }
    const float inv = 1.f / fmaxf(ll, 1e-30f);
    store4(o + orow * DT + f,
           make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    if (f == 0)
      lse[((long long)w.b * hq + head) * sq + c0 + r / g_n] =
          (mm + log2f(fmaxf(ll, 1e-30f))) * flash_mma::kLn2;
  }
}

// DT: the tensors' head_dim; D = padded(DT) in shared memory and in the
// products.  KB: the keys are a block at k_off (the header says how).
// RANKS: 1 the persistent grid (fwd_kernel), else one cluster of RANKS
// an item, its key tiles split over the ranks (fwd_split*_kernel; whole
// sequence, D up to 128).
template <int DT, bool KB, int RANKS>
__device__ __forceinline__ void fwd_body(
    const CUtensorMap* q_map, const CUtensorMap* k_map,
    const CUtensorMap* v_map, OutT<KB>* __restrict__ o,
    float* __restrict__ lse, int batch, int sq, int k_lim, int hq, int hkv,
    int bq, float scale, int causal, int window, float softcap, int k_off) {
  constexpr int D = padded(DT);
  using L = FwdSmem<D>;
  using Tr = FwdTraits<D>;
  constexpr int TK = Tr::kTk;
  static_assert(RANKS == 1 || (!KB && !Tr::kStaged &&
                               Partial<D>::kBytes <= 2 * kStages * L::kTile),
                "a split rank's partial fits its key stages");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, v_full = k_full + 8 * kStages;
  // K and V of a stage are freed apart: K once its S has landed, V once
  // its P V has (an iteration later)
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kArrivals);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kArrivals);
      mbar_init(v_empty + 8 * s, kArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int g_n = hq / hkv, hb = hkv * batch;
  const int n_blk = (sq + bq - 1) / bq, n_items = n_blk * hb;
  const int shift = KB ? k_off : 0;
  const int rank = RANKS > 1 ? cluster_rank() : 0;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread issues every load (under a split, every
    // thread of the group also takes the merge's two cluster barriers)
    regs_dealloc<Tr::kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) {
      if constexpr (RANKS > 1) {
        cluster_sync();
        cluster_sync();
      }
      return;
    }
    prefetch_map(q_map);
    prefetch_map(k_map);
    prefetch_map(v_map);
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int r = 0, it; (it = item_of<RANKS>(r, n_items)) < n_items; ++r) {
      const Item w = item_at(it, n_blk, hkv, hb, causal);
      const int c0 = w.blk * bq;
      int k_lo, k_hi, n_tiles;
      block_key_range<KB>(c0, shift, bq, k_lim, causal, window, TK, &k_lo,
                          &k_hi, &n_tiles);
      if constexpr (RANKS > 1) k_lo += rank_share<RANKS>(rank, &n_tiles) * TK;
      // no key of the block (or of the rank's share): no loads
      if ((KB || RANKS > 1) && n_tiles == 0) continue;
      mbar_wait(q_empty, q_phase ^ 1);
      q_phase ^= 1;
      mbar_expect_tx(q_full, (D / 64) * g_n * bq * 128);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_4d(base + L::kQ + c * kRows * 128, q_map, q_full, c * 64,
                    w.h * g_n, c0, w.b);
      for (int i = 0; i < n_tiles; ++i) {
        const int t0 = k_lo + i * TK;
        const uint32_t kt = base + L::kK + stage * L::kTile;
        const uint32_t vt = base + L::kV + stage * L::kTile;
        mbar_wait(k_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(k_full + 8 * stage, L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(kt + c * TK * 128, k_map, k_full + 8 * stage, c * 64,
                      w.h, t0, w.b);
        mbar_wait(v_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(v_full + 8 * stage, L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(vt + c * TK * 128, v_map, v_full + 8 * stage, c * 64,
                      w.h, t0, w.b);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    if constexpr (RANKS > 1) {
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- consumers: warpgroup wg holds rows 64 wg .. 64 wg + 63
  regs_alloc<Tr::kConsumerRegs>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int t4 = lane & 3;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  int stage = 0;
  uint32_t phase = 0, q_phase = 0;
  for (int r = 0, it; (it = item_of<RANKS>(r, n_items)) < n_items; ++r) {
    const Item w = item_at(it, n_blk, hkv, hb, causal);
    const int c0 = w.blk * bq;
    int k_lo, k_hi, n_tiles;
    block_key_range<KB>(c0, shift, bq, k_lim, causal, window, TK, &k_lo,
                        &k_hi, &n_tiles);
    if constexpr (RANKS > 1) k_lo += rank_share<RANKS>(rank, &n_tiles) * TK;
    const Rows rw = rows_of(r0, c0, g_n, bq, sq, shift);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // else the rows saw no key (of the block, or of the rank's share):
    // zeros below, or weight 0 in the ranks' merge
    if ((!KB && RANKS == 1) || n_tiles > 0) {
      float s[TK / 2];
      unsigned p_prev[TK / 16][4];   // tile i - 1's weights, bf16
      mbar_wait(q_full, q_phase);
      q_phase ^= 1;
      // Tile i's S = Q K^T is issued together with tile i - 1's O += P V, and
      // tile i's softmax runs while that product is in flight; O takes tile
      // i's rescale once it has landed.  Tile 0 goes first on its own, so
      // that the loop has no branch around its products (ptxas serializes
      // the products when a path might touch their registers in flight).
      float alpha[2];
      auto softmax = [&](int i) {   // tile i's weights into s, rescale alpha
        const int t0 = k_lo + i * TK;
        const int n = min(TK, k_hi - t0);
        float rs[2] = {0.f, 0.f};
        auto sc = reinterpret_cast<float(*)[4]>(s);
        if (n == TK && flash_mma::all_visible(rw.p_min, rw.p_max, t0,
                                              t0 + TK - 1, causal, window))
          flash_mma::online_softmax<false, TK / 8, Tr::kFast>(
              sc, m, alpha, rs, rw.pos, t0, n, scale, softcap, causal,
              window, t4);
        else
          flash_mma::online_softmax<true, TK / 8, Tr::kFast>(
              sc, m, alpha, rs, rw.pos, t0, n, scale, softcap, causal,
              window, t4);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          l[hh] = l[hh] * alpha[hh] + flash_mma::quad_sum(rs[hh]);
      };
      first_turn<RANKS>(wg);
      mbar_wait(k_full + 8 * stage, phase);
      take_turn<RANKS>(wg);
      wg_fence();
      product_abt<D, TK>(s, base + L::kQ, kRows, wg * 64,
                         base + L::kK + stage * L::kTile);
      wg_commit();
      pass_turn<RANKS>(wg);
      wg_wait<0>();
      fence_regs<TK / 2>(s);
      if (lane == 0) {
        mbar_arrive(k_empty + 8 * stage);
        if (n_tiles == 1) mbar_arrive(q_empty);
      }
      softmax(0);
      pack_a<TK>(s, p_prev);
      int v_stage = stage;
      uint32_t v_phase = phase;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      for (int i = 1; i < n_tiles; ++i) {
        mbar_wait(k_full + 8 * stage, phase);
        take_turn<RANKS>(wg);
        wg_fence();
        product_abt<D, TK>(s, base + L::kQ, kRows, wg * 64,
                           base + L::kK + stage * L::kTile);
        wg_commit();
        mbar_wait(v_full + 8 * v_stage, v_phase);
        product_ab<D, TK>(acc, p_prev, base + L::kV + v_stage * L::kTile);
        wg_commit();
        pass_turn<RANKS>(wg);
        wg_wait<1>();   // S has landed; P V may still run
        fence_regs<TK / 2>(s);
        if (lane == 0) {
          mbar_arrive(k_empty + 8 * stage);
          if (i == n_tiles - 1) mbar_arrive(q_empty);
        }
        softmax(i);
        wg_wait<0>();
        fence_regs<D / 2>(acc);
        if (lane == 0) mbar_arrive(v_empty + 8 * v_stage);
#pragma unroll
        for (int i2 = 0; i2 < D / 2; ++i2) acc[i2] *= alpha[(i2 >> 1) & 1];
        pack_a<TK>(s, p_prev);
        v_stage = stage;
        v_phase = phase;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_wait(v_full + 8 * v_stage, v_phase);
      take_turn<RANKS>(wg);
      wg_fence();
      product_ab<D, TK>(acc, p_prev, base + L::kV + v_stage * L::kTile);
      wg_commit();
      pass_turn<RANKS>(wg);
      last_turn<RANKS>(wg);
      wg_wait<0>();
      fence_regs<D / 2>(acc);
      if (lane == 0) mbar_arrive(v_empty + 8 * v_stage);
    }

    if constexpr (RANKS > 1) {
      // the ranks' partials over their key stages, once both groups are
      // done with them, then the merge through the cluster
      bar_sync(kMergeBar, kConsumers * 128);
      stage_partial<D, true>(base + L::kK, acc, rw, m, l, t4);
      cluster_sync();
      merge_fwd<DT, RANKS>(base + L::kK, rank, o, lse, c0, g_n, bq, sq, hq,
                           w);
      cluster_sync();   // no rank leaves while another reads its partial
    } else {
      if constexpr (Tr::kStaged) {
        // O through the group's two pieces, two pieces a round (four rounds
        // for an f32 O, two for bf16)
        using T = OutT<KB>;
        const int tid = threadIdx.x & 127;
        const uint32_t staging = base + L::kOut + wg * 2 * kPiece;
        const float inv[2] = {1.f / fmaxf(l[0], 1e-30f),
                              1.f / fmaxf(l[1], 1e-30f)};
        long long orow[4];
        out_rows(orow, wg, tid, c0, g_n, bq, sq, hq, w);
#pragma unroll
        for (int rd = 0; rd < D / kPieceCols<T> / 2; ++rd) {
          bar_sync(1 + wg, 128);   // the last round's copies have read them
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            stage_piece<T>(staging + h2 * kPiece, acc, 2 * rd + h2, inv, warp,
                           lane);
          bar_sync(1 + wg, 128);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2)
            copy_piece<T>(staging + h2 * kPiece, o, 2 * rd + h2, orow, tid);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!rw.live[hh]) continue;
        const int head = w.h * g_n + rw.r[hh] % g_n;
        const int pos = rw.pos[hh] + shift;
        if constexpr (!Tr::kStaged) {
          const long long orow = ((long long)w.b * sq + pos) * hq + head;
          const float inv = 1.f / fmaxf(l[hh], 1e-30f);
#pragma unroll
          for (int nt = 0; nt < DT / 8; ++nt)   // the true columns only
            store2(o + orow * DT + nt * 8 + 2 * t4, acc[4 * nt + 2 * hh] * inv,
                   acc[4 * nt + 2 * hh + 1] * inv);
        }
        if (t4 == 0)   // m is in the log2 domain; a row of a key block that
                       // saw no key has weight 0 in the merge
          lse[((long long)w.b * hq + head) * sq + pos] =
              KB && l[hh] == 0.f
                  ? -INFINITY
                  : (m[hh] + log2f(fmaxf(l[hh], 1e-30f))) * flash_mma::kLn2;
      }
    }
  }
}

template <int DT, bool KB>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap q_map,
           const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map,
           OutT<KB>* __restrict__ o, float* __restrict__ lse, int batch,
           int sq, int k_lim, int hq, int hkv, int bq, float scale,
           int causal, int window, float softcap, int k_off) {
  fwd_body<DT, KB, 1>(&q_map, &k_map, &v_map, o, lse, batch, sq, k_lim, hq,
                      hkv, bq, scale, causal, window, softcap, k_off);
}

// The split forward, clusters of R ranks: grid (R, items).
#define REPRO_FWD_SPLIT(R)                                                  \
  template <int DT>                                                         \
  __global__ void __cluster_dims__(R, 1, 1) __launch_bounds__(kThreads, 1)  \
  fwd_split##R##_kernel(const __grid_constant__ CUtensorMap q_map,          \
                        const __grid_constant__ CUtensorMap k_map,          \
                        const __grid_constant__ CUtensorMap v_map,          \
                        bf16* __restrict__ o, float* __restrict__ lse,      \
                        int batch, int sq, int k_lim, int hq, int hkv,      \
                        int bq, float scale, int causal, int window,        \
                        float softcap) {                                    \
    fwd_body<DT, false, R>(&q_map, &k_map, &v_map, o, lse, batch, sq, k_lim, \
                           hq, hkv, bq, scale, causal, window, softcap, 0); \
  }
REPRO_FWD_SPLIT(2)
REPRO_FWD_SPLIT(4)
#undef REPRO_FWD_SPLIT

// ---------------------------------------------------------------------------
// backward, pass 1: dQ
// ---------------------------------------------------------------------------

// The dQ pass holds K a whole iteration (until dS K has landed): a third
// stage keeps the next K's load a full iteration ahead of its use.
constexpr int kDqStages = 3;

template <int D>
struct DqSmem {
  static constexpr int kQ = 0;                       // kRows x D
  static constexpr int kG = kQ + kRows * D * 2;      // dO, kRows x D
  static constexpr int kTile = kTkDq * D * 2;
  static constexpr int kK = kG + kRows * D * 2;      // kDqStages K tiles
  static constexpr int kV = kK + kDqStages * kTile;  // kDqStages V tiles
  static constexpr int kBar = kV + kDqStages * kTile;
  // q_full, q_empty, then k_full, v_full, k_empty, v_empty per stage
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kDqStages) + 1024;
};

// The split dQ pass also brings the block's O rows (beside dO, after the
// barriers) and forms Delta = rowsum(dO O) itself: no Delta launch.
template <int D>
struct DqSplitSmem {
  static constexpr int kO =
      (DqSmem<D>::kBar + 8 * (2 + 4 * kDqStages) + 1023) / 1024 * 1024;
  static constexpr int kBytes = kO + kRows * D * 2 + 1024;
};

// Row r's dO . O over the D columns of the two swizzled tiles (column
// blocks of 128 rows x 128 bytes): this thread's 16-byte units t4 and
// t4 + 4 of each block, summed over the quad.
template <int D>
__device__ __forceinline__ float row_dot(uint32_t a, uint32_t b, int r,
                                         int t4) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t off =
          c * kRows * 128 + r * 128 + (((t4 + 4 * j) ^ (r & 7)) << 4);
      const uint4 x = ld_shared16(a + off), y = ld_shared16(b + off);
      const unsigned xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z,
                                                              y.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 u = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xs[e]));
        const float2 v = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&ys[e]));
        s += u.x * v.x + u.y * v.y;
      }
    }
  return flash_mma::quad_sum(s);
}

// The split dQ pass's merge: rank `rank` of RANKS takes rows [rank 128 /
// RANKS, ..) and adds every rank's partial dQ in rank order, then scales
// and rounds once.
template <int DT, int RANKS>
__device__ __forceinline__ void merge_dq(uint32_t at, int rank, bf16* dq,
                                         int c0, int g_n, int bq, int sq,
                                         int hq, float scale, const Item& w) {
  constexpr int D = padded(DT), U = DT / 4, kPer = kRows / RANKS;
  using P = Partial<D>;
  uint32_t src[RANKS];
#pragma unroll
  for (int q = 0; q < RANKS; ++q) src[q] = rank_addr(at, q);
#ifdef FLASH_ABLATE_NO_MERGE
  if (rank < 0)
#endif
  for (int u = threadIdx.x; u < kPer * U; u += kConsumers * 128) {
    const int r = rank * kPer + u / U, f = 4 * (u % U);
    int head;
    const long long orow = out_row(r, c0, g_n, bq, sq, hq, w, &head);
    if (orow < 0) continue;
    float4 a = ld_rank16(src[0] + (r * P::kStride + f) * 4);
#pragma unroll
    for (int q = 1; q < RANKS; ++q) {
      const float4 x = ld_rank16(src[q] + (r * P::kStride + f) * 4);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    store4(dq + orow * DT + f,
           make_float4(a.x * scale, a.y * scale, a.z * scale, a.w * scale));
  }
}

// sq query positions; k_lim as in key_range (Sk, or min(Sq, Sk) causal;
// under KB the keys are a block at k_off and dq is f32).  RANKS: 1 the
// persistent grid (dq_kernel, Delta from `delta`), else one cluster of
// RANKS an item (dq_split*_kernel; whole sequence, D up to 128): the
// ranks split the item's key tiles, form Delta from the O rows of o_map,
// rank 0 writes it to delta_out for the dK/dV pass, and dQ merges on chip.
template <int DT, bool KB, int RANKS>
__device__ __forceinline__ void dq_body(
    const CUtensorMap* q_map, const CUtensorMap* g_map,
    const CUtensorMap* k_map, const CUtensorMap* v_map,
    const CUtensorMap* o_map, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ delta_out,
    OutT<KB>* __restrict__ dq, int batch, int sq, int k_lim, int hq,
    int hkv, int bq, float scale, int causal, int window, float softcap,
    int k_off) {
  constexpr int D = padded(DT);
  using L = DqSmem<D>;
  constexpr int TK = kTkDq;
  static_assert(RANKS == 1 || (!KB && Partial<D>::kBytes <=
                                          2 * kDqStages * L::kTile),
                "a split rank's partial fits its key stages");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t q_full = base + L::kBar, q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8, v_full = k_full + 8 * kDqStages;
  // V of a stage is free once its dP has landed, K once its dQ has (an
  // iteration later)
  const uint32_t k_empty = v_full + 8 * kDqStages;
  const uint32_t v_empty = k_empty + 8 * kDqStages;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kArrivals);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kArrivals);
      mbar_init(v_empty + 8 * s, kArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int g_n = hq / hkv, hb = hkv * batch;
  const int n_blk = (sq + bq - 1) / bq, n_items = n_blk * hb;
  const int shift = KB ? k_off : 0;
  const int rank = RANKS > 1 ? cluster_rank() : 0;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) {
      if constexpr (RANKS > 1) {
        cluster_sync();
        cluster_sync();
      }
      return;
    }
    prefetch_map(q_map);
    prefetch_map(g_map);
    prefetch_map(k_map);
    prefetch_map(v_map);
    int stage = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int r = 0, it; (it = item_of<RANKS>(r, n_items)) < n_items; ++r) {
      const Item w = item_at(it, n_blk, hkv, hb, causal);
      const int c0 = w.blk * bq;
      int k_lo, k_hi, n_tiles;
      block_key_range<KB>(c0, shift, bq, k_lim, causal, window, TK, &k_lo,
                          &k_hi, &n_tiles);
      if constexpr (RANKS > 1) k_lo += rank_share<RANKS>(rank, &n_tiles) * TK;
      // no key of the block (or of the rank's share): no loads
      if ((KB || RANKS > 1) && n_tiles == 0) continue;
      mbar_wait(q_empty, q_phase ^ 1);
      q_phase ^= 1;
      mbar_expect_tx(q_full, (RANKS > 1 ? 3 : 2) * (D / 64) * g_n * bq * 128);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_load_4d(base + L::kQ + c * kRows * 128, q_map, q_full, c * 64,
                    w.h * g_n, c0, w.b);
        tma_load_4d(base + L::kG + c * kRows * 128, g_map, q_full, c * 64,
                    w.h * g_n, c0, w.b);
        if constexpr (RANKS > 1)
          tma_load_4d(base + DqSplitSmem<D>::kO + c * kRows * 128, o_map,
                      q_full, c * 64, w.h * g_n, c0, w.b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int t0 = k_lo + i * TK;
        const uint32_t kt = base + L::kK + stage * L::kTile;
        const uint32_t vt = base + L::kV + stage * L::kTile;
        mbar_wait(k_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(k_full + 8 * stage, L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(kt + c * TK * 128, k_map, k_full + 8 * stage, c * 64,
                      w.h, t0, w.b);
        mbar_wait(v_empty + 8 * stage, phase ^ 1);
        mbar_expect_tx(v_full + 8 * stage, L::kTile);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(vt + c * TK * 128, v_map, v_full + 8 * stage, c * 64,
                      w.h, t0, w.b);
        if (++stage == kDqStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    if constexpr (RANKS > 1) {
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int t4 = lane & 3;
  const int r0 = wg * 64 + warp * 16 + (lane >> 2);
  int stage = 0;
  uint32_t phase = 0, q_phase = 0;
  for (int r = 0, it; (it = item_of<RANKS>(r, n_items)) < n_items; ++r) {
    const Item w = item_at(it, n_blk, hkv, hb, causal);
    const int c0 = w.blk * bq;
    int k_lo, k_hi, n_tiles;
    block_key_range<KB>(c0, shift, bq, k_lim, causal, window, TK, &k_lo,
                        &k_hi, &n_tiles);
    if constexpr (RANKS > 1) k_lo += rank_share<RANKS>(rank, &n_tiles) * TK;
    const Rows rw = rows_of(r0, c0, g_n, bq, sq, shift);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // else the rows saw no key (of the block, or of the rank's share):
    // zeros below, or nothing added in the ranks' merge
    if ((!KB && RANKS == 1) || n_tiles > 0) {
      float lse2[2], dl[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long li =
            ((long long)w.b * hq + w.h * g_n + rw.r[hh] % g_n) * sq +
            rw.pos[hh] + shift;
        lse2[hh] = rw.live[hh] ? lse[li] * flash_mma::kLog2e : 0.f;
        if constexpr (RANKS == 1) dl[hh] = rw.live[hh] ? delta[li] : 0.f;
      }
      float s[TK / 2], dp[TK / 2];
      unsigned ds_prev[TK / 16][4];   // tile i - 1's dS, bf16
      mbar_wait(q_full, q_phase);
      q_phase ^= 1;
      if constexpr (RANKS > 1) {
        // Delta of the two rows from the dO and O tiles; rank 0 (which
        // always holds a share) stores it for the dK/dV pass
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float x = row_dot<D>(base + L::kG, base + DqSplitSmem<D>::kO,
                                     rw.r[hh], t4);
          dl[hh] = rw.live[hh] ? x : 0.f;
          if (rank == 0 && t4 == 0 && rw.live[hh])
            delta_out[((long long)w.b * hq + w.h * g_n + rw.r[hh] % g_n) *
                          sq + rw.pos[hh]] = x;
        }
      }
      // As in the forward: tile i's S and dP are issued together with tile
      // i - 1's dQ += dS K, and tile i's dS is formed while that product
      // runs; tile 0 goes first on its own.
      auto issue_s_dp = [&]() {   // S and dP of the tile in `stage`
        mbar_wait(k_full + 8 * stage, phase);
        wg_fence();
        product_abt<D, TK>(s, base + L::kQ, kRows, wg * 64,
                           base + L::kK + stage * L::kTile);
        mbar_wait(v_full + 8 * stage, phase);
        product_abt<D, TK>(dp, base + L::kG, kRows, wg * 64,
                           base + L::kV + stage * L::kTile);
        wg_commit();
      };
      auto grad = [&](int i) {   // s <- tile i's dS (times the softcap's slope)
        const int t0 = k_lo + i * TK;
        const int n = min(TK, k_hi - t0);
        auto sc = reinterpret_cast<float(*)[4]>(s);
        auto dpc = reinterpret_cast<float(*)[4]>(dp);
        if (n == TK && flash_mma::all_visible(rw.p_min, rw.p_max, t0,
                                              t0 + TK - 1, causal, window))
          flash_mma::grad_tile<false, TK / 8>(sc, dpc, lse2, dl, rw.pos, t0, n,
                                              scale, softcap, causal, window,
                                              t4);
        else
          flash_mma::grad_tile<true, TK / 8>(sc, dpc, lse2, dl, rw.pos, t0, n,
                                             scale, softcap, causal, window,
                                             t4);
      };
      issue_s_dp();
      wg_wait<0>();
      fence_regs<TK / 2>(s);
      fence_regs<TK / 2>(dp);
      if (lane == 0) {
        mbar_arrive(v_empty + 8 * stage);
        if (n_tiles == 1) mbar_arrive(q_empty);
      }
      grad(0);
      pack_a<TK>(s, ds_prev);
      int k_stage = stage;
      if (++stage == kDqStages) {
        stage = 0;
        phase ^= 1;
      }
      for (int i = 1; i < n_tiles; ++i) {
        issue_s_dp();
        product_ab<D, TK>(acc, ds_prev, base + L::kK + k_stage * L::kTile);
        wg_commit();
        wg_wait<1>();   // S and dP have landed; dQ may still run
        fence_regs<TK / 2>(s);
        fence_regs<TK / 2>(dp);
        if (lane == 0) {
          mbar_arrive(v_empty + 8 * stage);
          if (i == n_tiles - 1) mbar_arrive(q_empty);
        }
        grad(i);
        wg_wait<0>();
        fence_regs<D / 2>(acc);
        if (lane == 0) mbar_arrive(k_empty + 8 * k_stage);
        pack_a<TK>(s, ds_prev);
        k_stage = stage;
        if (++stage == kDqStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_fence();
      product_ab<D, TK>(acc, ds_prev, base + L::kK + k_stage * L::kTile);
      wg_commit();
      wg_wait<0>();
      fence_regs<D / 2>(acc);
      if (lane == 0) mbar_arrive(k_empty + 8 * k_stage);
    }

    if constexpr (RANKS > 1) {
      // as the split forward's: partials over the key stages, then the
      // merge through the cluster
      bar_sync(kMergeBar, kConsumers * 128);
      stage_partial<D, false>(base + L::kK, acc, rw, nullptr, nullptr, t4);
      cluster_sync();
      merge_dq<DT, RANKS>(base + L::kK, rank, dq, c0, g_n, bq, sq, hq, scale,
                          w);
      cluster_sync();   // no rank leaves while another reads its partial
    } else {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (!rw.live[hh]) continue;
        const long long orow = ((long long)w.b * sq + rw.pos[hh] + shift) * hq +
                               w.h * g_n + rw.r[hh] % g_n;
#pragma unroll
        for (int nt = 0; nt < DT / 8; ++nt)
          store2(dq + orow * DT + nt * 8 + 2 * t4, acc[4 * nt + 2 * hh] * scale,
                 acc[4 * nt + 2 * hh + 1] * scale);
      }
    }
  }
}

template <int DT, bool KB>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap q_map,
          const __grid_constant__ CUtensorMap g_map,
          const __grid_constant__ CUtensorMap k_map,
          const __grid_constant__ CUtensorMap v_map,
          const float* __restrict__ lse, const float* __restrict__ delta,
          OutT<KB>* __restrict__ dq, int batch, int sq, int k_lim, int hq,
          int hkv, int bq, float scale, int causal, int window,
          float softcap, int k_off) {
  dq_body<DT, KB, 1>(&q_map, &g_map, &k_map, &v_map, nullptr, lse, delta,
                     nullptr, dq, batch, sq, k_lim, hq, hkv, bq, scale,
                     causal, window, softcap, k_off);
}

// The split dQ pass, clusters of R ranks: grid (R, items).
#define REPRO_DQ_SPLIT(R)                                                   \
  template <int DT>                                                         \
  __global__ void __cluster_dims__(R, 1, 1) __launch_bounds__(kThreads, 1)  \
  dq_split##R##_kernel(const __grid_constant__ CUtensorMap q_map,           \
                       const __grid_constant__ CUtensorMap g_map,           \
                       const __grid_constant__ CUtensorMap k_map,           \
                       const __grid_constant__ CUtensorMap v_map,           \
                       const __grid_constant__ CUtensorMap o_map,           \
                       const float* __restrict__ lse,                       \
                       float* __restrict__ delta, bf16* __restrict__ dq,    \
                       int batch, int sq, int k_lim, int hq, int hkv,       \
                       int bq, float scale, int causal, int window,         \
                       float softcap) {                                     \
    dq_body<DT, false, R>(&q_map, &g_map, &k_map, &v_map, &o_map, lse,      \
                          nullptr, delta, dq, batch, sq, k_lim, hq, hkv, bq, \
                          scale, causal, window, softcap, 0);               \
  }
REPRO_DQ_SPLIT(2)
REPRO_DQ_SPLIT(4)
#undef REPRO_DQ_SPLIT

// ---------------------------------------------------------------------------
// backward, pass 2: dK and dV
// ---------------------------------------------------------------------------

// Each 64-query tile of the dK/dV pass streams 32 KB of Q and dO (at
// D 128) through the ring; three stages keep two tiles in flight.
constexpr int kDkvStages = 3;

template <int D>
struct DkvSmem {
  static constexpr int kK = 0;                       // kRows keys x D
  static constexpr int kV = kK + kRows * D * 2;      // kRows keys x D
  static constexpr int kTile = kTqDkv * D * 2;       // a Q or dO tile
  // a stage: Q tile, dO tile, then the tile's log-sum-exp and Delta
  static constexpr int kLse = 2 * kTile, kDelta = kLse + 4 * kTqDkv;
  static constexpr int kStage = (kDelta + 4 * kTqDkv + 1023) / 1024 * 1024;
  static constexpr int kStages0 = kV + kRows * D * 2;
  static constexpr int kBar = kStages0 + kDkvStages * kStage;
  // kv_full, kv_empty, then full, empty per stage
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kDkvStages) + 1024;
};

// sq query positions against sk keys (under KB a block at k_off).
template <int DT, bool KB>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap q_map,
           const __grid_constant__ CUtensorMap g_map,
           const __grid_constant__ CUtensorMap k_map,
           const __grid_constant__ CUtensorMap v_map,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int batch, int sq,
           int sk, int hq, int hkv, float scale, int causal, int window,
           float softcap, int k_off) {
  constexpr int D = padded(DT);
  using L = DkvSmem<D>;
  constexpr int TQ = kTqDkv;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_smem_base(smem_raw);
  const uint32_t kv_full = base + L::kBar, kv_empty = kv_full + 8;
  const uint32_t full = kv_empty + 8, empty = full + 8 * kDkvStages;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kArrivals);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(full + 8 * s, 32);   // the producer warp's lanes
      mbar_init(empty + 8 * s, kArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int g_n = hq / hkv, hb = hkv * batch;
  const int n_blk = (sk + kRows - 1) / kRows, n_items = n_blk * hb;
  const int shift = KB ? k_off : 0;
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one warp.  Lane 0 issues the TMA loads of the tiles;
    // every lane copies its share of the tile's log-sum-exp and Delta (64
    // floats each, zero past Sq), then arrives on the stage's full barrier.
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x >= kConsumers * 128 + 32) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      prefetch_map(&q_map);
      prefetch_map(&g_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
    }
    int stage = 0;
    uint32_t phase = 0, kv_phase = 0;
    for (int r = 0, it; (it = item_index(r)) < n_items; ++r) {
      // causal: the first key blocks see the most queries
      const Item w = item_at(it, n_blk, hkv, hb, !causal);
      const int k0 = w.blk * kRows;
      int q_lo, q_hi, n_qt;
      query_range(k0, sq, sk, causal, window, shift, &q_lo, &q_hi, &n_qt);
      if (n_qt == 0) continue;   // no query sees these keys: no K/V stage
      if (lane == 0) {
        mbar_wait(kv_empty, kv_phase ^ 1);
        mbar_expect_tx(kv_full, 2 * kRows * D * 2);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(base + L::kK + c * kRows * 128, &k_map, kv_full,
                      c * 64, w.h, k0, w.b);
          tma_load_4d(base + L::kV + c * kRows * 128, &v_map, kv_full,
                      c * 64, w.h, k0, w.b);
        }
      }
      kv_phase ^= 1;
      for (int j = 0; j < g_n * n_qt; ++j) {
        const int gi = j / n_qt, head = w.h * g_n + gi;
        const int t0 = q_lo + (j - gi * n_qt) * TQ;
        const uint32_t st = base + L::kStages0 + stage * L::kStage;
        const uint32_t bar = full + 8 * stage;
        // this lane's log-sum-exp and Delta, loaded before the wait
        const long long row = ((long long)w.b * hq + head) * sq;
        float lse_r[TQ / 32], delta_r[TQ / 32];
#pragma unroll
        for (int c = 0; c < TQ / 32; ++c) {
          const bool ok = t0 + lane + 32 * c < sq;
          lse_r[c] = ok ? lse[row + t0 + lane + 32 * c] : 0.f;
          delta_r[c] = ok ? delta[row + t0 + lane + 32 * c] : 0.f;
        }
        mbar_wait(empty + 8 * stage, phase ^ 1);
        if (lane == 0) {
          mbar_add_tx(bar, 2 * L::kTile);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(st + c * TQ * 128, &q_map, bar, c * 64, head, t0,
                        w.b);
            tma_load_4d(st + L::kTile + c * TQ * 128, &g_map, bar, c * 64,
                        head, t0, w.b);
          }
        }
        float* lse_s = reinterpret_cast<float*>(
            smem_raw + (st + L::kLse - smem_u32(smem_raw)));
        float* delta_s = reinterpret_cast<float*>(
            smem_raw + (st + L::kDelta - smem_u32(smem_raw)));
#pragma unroll
        for (int c = 0; c < TQ / 32; ++c) {
          lse_s[lane + 32 * c] = lse_r[c];
          delta_s[lane + 32 * c] = delta_r[c];
        }
        mbar_arrive(bar);   // after this lane's stores
        if (++stage == kDkvStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int t4 = lane & 3;
  const int row0 = wg * 64 + warp * 16;   // this warp's first key
  int stage = 0;
  uint32_t phase = 0, kv_phase = 0;
  for (int r = 0, it; (it = item_index(r)) < n_items; ++r) {
    const Item w = item_at(it, n_blk, hkv, hb, !causal);
    const int k0 = w.blk * kRows;
    int q_lo, q_hi, n_qt;
    query_range(k0, sq, sk, causal, window, shift, &q_lo, &q_hi, &n_qt);
    // kp: the two keys' rows; kpos: their positions, which the masks see
    int kp[2], kpos[2];
    bool key_ok[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      kp[hh] = k0 + row0 + (lane >> 2) + 8 * hh;
      kpos[hh] = kp[hh] + shift;
      key_ok[hh] = kp[hh] < sk;
    }
    const int k_min = k0 + row0 + shift, k_max = k_min + 15;
    const bool warp_keys_ok = k_max - shift < sk;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    if (n_qt > 0) {   // else the producer loaded nothing: store zeros
      mbar_wait(kv_full, kv_phase);
      kv_phase ^= 1;
    }
    const int n_tiles = g_n * n_qt;
    for (int j = 0; j < n_tiles; ++j) {
      const int gi = j / n_qt;
      const int t0 = q_lo + (j - gi * n_qt) * TQ;
      const int n = min(TQ, q_hi - t0);
      const uint32_t st = base + L::kStages0 + stage * L::kStage;
      const float* lse_t = reinterpret_cast<const float*>(
          smem_raw + (st + L::kLse - smem_u32(smem_raw)));
      const float* delta_t = reinterpret_cast<const float*>(
          smem_raw + (st + L::kDelta - smem_u32(smem_raw)));
      float s[TQ / 2], dp[TQ / 2];
      mbar_wait(full + 8 * stage, phase);
      wg_fence();
      product_abt<D, TQ>(s, base + L::kK, kRows, wg * 64, st);   // K Q^T
      product_abt<D, TQ>(dp, base + L::kV, kRows, wg * 64,
                         st + L::kTile);                          // V dO^T
      wg_commit();
      wg_wait<0>();
      fence_regs<TQ / 2>(s);
      fence_regs<TQ / 2>(dp);
      if (j == n_tiles - 1 && lane == 0) mbar_arrive(kv_empty);

      auto sc = reinterpret_cast<float(*)[4]>(s);
      auto dpc = reinterpret_cast<float(*)[4]>(dp);
      if (n == TQ && warp_keys_ok &&
          flash_mma::all_visible(t0, t0 + TQ - 1, k_min, k_max, causal,
                                 window))
        flash_mma::grad_tile_t<false, TQ / 8>(sc, dpc, lse_t, delta_t, kpos,
                                              key_ok, t0, n, scale, softcap,
                                              causal, window, t4);
      else
        flash_mma::grad_tile_t<true, TQ / 8>(sc, dpc, lse_t, delta_t, kpos,
                                             key_ok, t0, n, scale, softcap,
                                             causal, window, t4);
      wg_fence();
      product_pb<D, TQ>(dv_acc, s, st + L::kTile);   // dV += P^T dO
      product_pb<D, TQ>(dk_acc, dp, st);             // dK += dS^T Q
      wg_commit();
      wg_wait<0>();
      fence_regs<D / 2>(dv_acc);
      fence_regs<D / 2>(dk_acc);
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (++stage == kDkvStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    const long long kv_base = (long long)w.b * sk * hkv + w.h;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!key_ok[hh]) continue;
      const long long orow = kv_base + (long long)kp[hh] * hkv;
#pragma unroll
      for (int nt = 0; nt < DT / 8; ++nt) {
        const int col = nt * 8 + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(dk + orow * DT + col) =
            __floats2bfloat162_rn(dk_acc[4 * nt + 2 * hh] * scale,
                                  dk_acc[4 * nt + 2 * hh + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + orow * DT + col) =
            __floats2bfloat162_rn(dv_acc[4 * nt + 2 * hh],
                                  dv_acc[4 * nt + 2 * hh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launches
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a libcuda function: fetch it through the
// runtime's entry-point query, so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (B, S, H, D) bf16 tensor as the 4-D map (D, H, S, B), boxes of 64
// features x box_heads heads x box_rows positions, 128-byte swizzle.
inline bool map_bshd(CUtensorMap* m, const void* p, int batch, int s_len,
                     int heads, int d, int box_heads, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s_len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s_len * heads * d * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_heads, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major bf16 (rows, cols) operand with row stride ld as a 2-D tensor
// map, boxes of 64 columns x box_rows rows, 128-byte swizzle.
inline bool map_2d(CUtensorMap* map, const void* p, int rows, int cols,
            long long ld, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// The persistent grid: one CTA per SM, or one per item if fewer.
inline int grid_size(long long n_items) {
  const int sms = sm_count();
  return (int)(n_items < sms ? n_items : sms);
}

// The key bound of key_range (Sk, or causal the last query's position +
// 1 less a key block's offset, at most Sk).
inline int key_limit(int sq, int sk, int causal, int k_off) {
  return causal ? max(0, min(sq - k_off, sk)) : sk;
}

// The rank count of a whole-sequence call's split family: 1 where its
// (block, kv head, batch) items fill the card's sms processors; else the
// largest of kMaxRanks, .., 2 that keeps items x ranks within the
// processors and leaves the longest item at least two of its key tiles
// (tk keys each, as key_range counts them) a rank; else 1.
// attention.split_ranks mirrors it for the CPU tests.
inline int split_ranks(int batch, int sq, int sk, int hq, int hkv,
                       int causal, int window, int tk, int sms) {
  const int bq = kRows / (hq / hkv);
  const int n_blk = (sq + bq - 1) / bq;
  const long long n_items = (long long)n_blk * hkv * batch;
  if (n_items >= sms) return 1;
  const int k_lim = key_limit(sq, sk, causal, 0);
  int tiles = 0;
  for (int blk = 0; blk < n_blk; ++blk) {
    int lo, hi, n;
    key_range(blk * bq, bq, k_lim, causal, window, tk, &lo, &hi, &n);
    tiles = max(tiles, n);
  }
  for (int r = kMaxRanks; r > 1; r /= 2)
    if (n_items * r <= sms && tiles >= 2 * r) return r;
  return 1;
}

// The forward's (tk 128) and the dQ pass's (tk 64) on this card.
inline int fwd_ranks(int batch, int sq, int sk, int hq, int hkv, int causal,
                     int window) {
  return split_ranks(batch, sq, sk, hq, hkv, causal, window, kTkFwd,
                     sm_count());
}

inline int bwd_ranks(int batch, int sq, int sk, int hq, int hkv, int causal,
                     int window) {
  return split_ranks(batch, sq, sk, hq, hkv, causal, window, kTkDq,
                     sm_count());
}

// DT: the tensors' head_dim (64, 112, 128 or 256); the maps span its
// columns, so a padded kernel's last box is zero-filled past them.  KB:
// the keys are a block at k_off, O is f32.
template <int DT, bool KB>
int launch_fwd_d(const void* q, const void* k, const void* v, void* o,
                 float* lse, int batch, int sq, int sk, int hq, int hkv,
                 float scale, int causal, int window, float softcap,
                 int k_off, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  const size_t smem = FwdSmem<padded(DT)>::kBytes;
  const cudaError_t e = allow_smem(fwd_kernel<DT, KB>, smem, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const int g_n = hq / hkv, bq = kRows / g_n;
  CUtensorMap qm, km, vm;
  if (!map_bshd(&qm, q, batch, sq, hq, DT, g_n, bq) ||
      !map_bshd(&km, k, batch, sk, hkv, DT, 1,
                FwdTraits<padded(DT)>::kTk) ||
      !map_bshd(&vm, v, batch, sk, hkv, DT, 1, FwdTraits<padded(DT)>::kTk))
    return (int)cudaErrorInvalidValue;
  const long long n_items = (long long)((sq + bq - 1) / bq) * hkv * batch;
  if (n_items == 0) return 0;
  fwd_kernel<DT, KB><<<grid_size(n_items), kThreads, smem, stream>>>(
      qm, km, vm, static_cast<OutT<KB>*>(o), lse, batch, sq,
      key_limit(sq, sk, causal, k_off), hq, hkv, bq, scale, causal, window,
      softcap, k_off);
  return (int)cudaGetLastError();
}

// The split forward (whole sequence, D 64, 112 or 128): one cluster of
// RANKS an item.
template <int DT, int RANKS, class K>
int launch_fwd_split(K kernel, const void* q, const void* k, const void* v,
                     void* o, float* lse, int batch, int sq, int sk, int hq,
                     int hkv, float scale, int causal, int window,
                     float softcap, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  const size_t smem = FwdSmem<padded(DT)>::kBytes;
  const cudaError_t e = allow_smem(kernel, smem, &opted_in);
  if (e != cudaSuccess) return (int)e;
  const int g_n = hq / hkv, bq = kRows / g_n;
  CUtensorMap qm, km, vm;
  if (!map_bshd(&qm, q, batch, sq, hq, DT, g_n, bq) ||
      !map_bshd(&km, k, batch, sk, hkv, DT, 1, kTkFwd) ||
      !map_bshd(&vm, v, batch, sk, hkv, DT, 1, kTkFwd))
    return (int)cudaErrorInvalidValue;
  const int n_items = (sq + bq - 1) / bq * hkv * batch;
  kernel<<<dim3(RANKS, n_items), kThreads, smem, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), lse, batch, sq,
      key_limit(sq, sk, causal, 0), hq, hkv, bq, scale, causal, window,
      softcap);
  return (int)cudaGetLastError();
}

// The split forward at `ranks` (2, or 4 up to kMaxRanks); ranks 1 is the
// caller's: launch_fwd_d.
template <int DT>
int launch_fwd_ranked(int ranks, const void* q, const void* k,
                      const void* v, void* o, float* lse, int batch, int sq,
                      int sk, int hq, int hkv, float scale, int causal,
                      int window, float softcap, cudaStream_t stream) {
  if (ranks == 2)
    return launch_fwd_split<DT, 2>(fwd_split2_kernel<DT>, q, k, v, o, lse,
                                   batch, sq, sk, hq, hkv, scale, causal,
                                   window, softcap, stream);
  if constexpr (kMaxRanks >= 4)
    if (ranks == 4)
      return launch_fwd_split<DT, 4>(fwd_split4_kernel<DT>, q, k, v, o, lse,
                                     batch, sq, sk, hq, hkv, scale, causal,
                                     window, softcap, stream);
  return (int)cudaErrorInvalidValue;
}

// The dK/dV pass, ceil(Sk / 128) key blocks, Delta (B, Hq, Sq) f32 in
// `delta`.  KB: the keys are a block at k_off.
template <int DT, bool KB>
int launch_dkv(const void* q, const void* k, const void* v, const void* d_o,
               const float* lse, const float* delta, void* dk, void* dv,
               int batch, int sq, int sk, int hq, int hkv, float scale,
               int causal, int window, float softcap, int k_off,
               cudaStream_t stream) {
  static size_t opted_dkv = 48 * 1024;
  const size_t smem_dkv = DkvSmem<padded(DT)>::kBytes;
  const cudaError_t e = allow_smem(dkv_kernel<DT, KB>, smem_dkv, &opted_dkv);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap qt, gt, kb, vb;
  if (!map_bshd(&qt, q, batch, sq, hq, DT, 1, kTqDkv) ||
      !map_bshd(&gt, d_o, batch, sq, hq, DT, 1, kTqDkv) ||
      !map_bshd(&kb, k, batch, sk, hkv, DT, 1, kRows) ||
      !map_bshd(&vb, v, batch, sk, hkv, DT, 1, kRows))
    return (int)cudaErrorInvalidValue;
  const long long n_k = (long long)((sk + kRows - 1) / kRows) * hkv * batch;
  dkv_kernel<DT, KB><<<grid_size(n_k), kThreads, smem_dkv, stream>>>(
      qt, gt, kb, vb, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), batch, sq, sk, hq, hkv, scale, causal, window,
      softcap, k_off);
  return (int)cudaGetLastError();
}

// The two passes, sq query positions against sk keys; Delta (B, Hq, Sq)
// f32 is already in `delta`.  The dQ pass takes the forward's key bound
// (key_limit), the dK/dV pass ceil(Sk / 128) key blocks.  KB: the keys
// are a block at k_off, dQ is f32.
template <int DT, bool KB>
int launch_bwd_d(const void* q, const void* k, const void* v,
                 const void* d_o, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, int batch, int sq, int sk,
                 int hq, int hkv, float scale, int causal, int window,
                 float softcap, int k_off, cudaStream_t stream) {
  constexpr int D = padded(DT);
  static size_t opted_dq = 48 * 1024;
  const size_t smem_dq = DqSmem<D>::kBytes;
  const cudaError_t e = allow_smem(dq_kernel<DT, KB>, smem_dq, &opted_dq);
  if (e != cudaSuccess) return (int)e;
  const int g_n = hq / hkv, bq = kRows / g_n;
  CUtensorMap qm, gm, km, vm;
  if (!map_bshd(&qm, q, batch, sq, hq, DT, g_n, bq) ||
      !map_bshd(&gm, d_o, batch, sq, hq, DT, g_n, bq) ||
      !map_bshd(&km, k, batch, sk, hkv, DT, 1, kTkDq) ||
      !map_bshd(&vm, v, batch, sk, hkv, DT, 1, kTkDq))
    return (int)cudaErrorInvalidValue;
  const long long n_q = (long long)((sq + bq - 1) / bq) * hkv * batch;
  if (n_q == 0) return 0;
  dq_kernel<DT, KB><<<grid_size(n_q), kThreads, smem_dq, stream>>>(
      qm, gm, km, vm, lse, delta, static_cast<OutT<KB>*>(dq), batch, sq,
      key_limit(sq, sk, causal, k_off), hq, hkv, bq, scale, causal, window,
      softcap, k_off);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_dkv<DT, KB>(q, k, v, d_o, lse, delta, dk, dv, batch, sq, sk,
                            hq, hkv, scale, causal, window, softcap, k_off,
                            stream);
}

// The split backward (whole sequence, D 64, 112 or 128): the dQ pass in
// clusters of RANKS, which also forms Delta into `delta`, then the dK/dV
// pass; two launches.
template <int DT, int RANKS, class K>
int launch_bwd_split(K kernel, const void* q, const void* k, const void* v,
                     const void* o, const void* d_o, const float* lse,
                     float* delta, void* dq, void* dk, void* dv, int batch,
                     int sq, int sk, int hq, int hkv, float scale, int causal,
                     int window, float softcap, cudaStream_t stream) {
  constexpr int D = padded(DT);
  static size_t opted_dq = 48 * 1024;
  const size_t smem_dq = DqSplitSmem<D>::kBytes;
  const cudaError_t e = allow_smem(kernel, smem_dq, &opted_dq);
  if (e != cudaSuccess) return (int)e;
  const int g_n = hq / hkv, bq = kRows / g_n;
  CUtensorMap qm, gm, km, vm, om;
  if (!map_bshd(&qm, q, batch, sq, hq, DT, g_n, bq) ||
      !map_bshd(&gm, d_o, batch, sq, hq, DT, g_n, bq) ||
      !map_bshd(&om, o, batch, sq, hq, DT, g_n, bq) ||
      !map_bshd(&km, k, batch, sk, hkv, DT, 1, kTkDq) ||
      !map_bshd(&vm, v, batch, sk, hkv, DT, 1, kTkDq))
    return (int)cudaErrorInvalidValue;
  const int n_q = (sq + bq - 1) / bq * hkv * batch;
  kernel<<<dim3(RANKS, n_q), kThreads, smem_dq, stream>>>(
      qm, gm, km, vm, om, lse, delta, static_cast<bf16*>(dq), batch, sq,
      key_limit(sq, sk, causal, 0), hq, hkv, bq, scale, causal, window,
      softcap);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_dkv<DT, false>(q, k, v, d_o, lse, delta, dk, dv, batch, sq,
                               sk, hq, hkv, scale, causal, window, softcap, 0,
                               stream);
}

// The split backward at `ranks` (2, or 4 up to kMaxRanks); ranks 1 is the
// caller's: Delta, then launch_bwd_d.
template <int DT>
int launch_bwd_ranked(int ranks, const void* q, const void* k, const void* v,
                      const void* o, const void* d_o, const float* lse,
                      float* delta, void* dq, void* dk, void* dv, int batch,
                      int sq, int sk, int hq, int hkv, float scale,
                      int causal, int window, float softcap,
                      cudaStream_t stream) {
  if (ranks == 2)
    return launch_bwd_split<DT, 2>(dq_split2_kernel<DT>, q, k, v, o, d_o,
                                   lse, delta, dq, dk, dv, batch, sq, sk, hq,
                                   hkv, scale, causal, window, softcap,
                                   stream);
  if constexpr (kMaxRanks >= 4)
    if (ranks == 4)
      return launch_bwd_split<DT, 4>(dq_split4_kernel<DT>, q, k, v, o, d_o,
                                     lse, delta, dq, dk, dv, batch, sq, sk,
                                     hq, hkv, scale, causal, window, softcap,
                                     stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash_wgmma
