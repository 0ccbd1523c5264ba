// The LCS dynamic-programming table of PACO LCS, tile by tile, in one
// launch: the tile kernel of the port.
//
// Replaces the TPU kernel repro/kernels/lcs/lcs.py: lcs_tile_pallas (body
// _lcs_kernel), which computes one (M, N) tile per call from its top row,
// left column and corner and returns the bottom row and right column.  It
// computes exactly that kernel's function, on any int32 inputs (borders
// that are not valid DP tables included): for each row i,
//     a[j]   = max(prev[j], diag[j] + (t[j] == s[i]))   diag = prev shifted
//                                                       right by one, led
//                                                       by the corner or
//                                                       left[i - 1]
//     cur[j] = max(cummax(a)[j], left[i]),  right[i] = cur[N - 1].
// Sums wrap as int32 sums do in PyTorch and XLA.
//
// The cell recurrence.  Write X[i, j] for cur[j] of row i, X[i, -1] for
// left[i], X[-1, j] for top[j] and X[-1, -1] for the corner.  Then
//     X[i, j] = max(X[i, j - 1], X[i - 1, j], X[i - 1, j - 1] + eq[i, j]).
// By induction along the row: cummax(a)[j] = max(cummax(a)[j - 1], a[j]),
// so cur[j] = max(left[i], a[0], ..., a[j]) = max(cur[j - 1], a[j]) with
// cur[-1] = left[i], and a[j] is max(X[i - 1, j], X[i - 1, j - 1] + eq).
// Only max (associative and commutative on int32) and the one wrapping add
// of each cell appear on both sides, so the two agree on every int32 input.
//
// A whole table of s (m) against t (n), cut into (tm x tn) tiles (the last
// tile row and column may be ragged), is one launch.  PACO's tiling
// decides the tile: PACO, PO and PA differ only in it (tiles of 256, 128
// and 8192 at n = 65,536).  A tile is one CTA: the unit PACO gives a
// processor.
//
// The schedule: a persistent grid, sized from the tiles and the card (the
// widest set of tiles that can run at once is min(ti, tj), capped by what
// fits on the SMs).  CTAs claim tiles in anti-diagonal order from an atomic
// counter.  A CTA waits for its tile's top and left neighbours' done flags
// (per tile column and tile row, acquire at gpu scope), reads the borders,
// sweeps the tile, writes its borders and releases its flags.  A tile's
// neighbours were claimed earlier, by CTAs that are running: no deadlock,
// whatever the grid.  There is no barrier between diagonals, as in the
// paper's schedule.  Along a tile column the tiles run one after another,
// so one buffer of bottom rows (length n), one of right columns (length m)
// and one corner per tile column (X[i0 - 1, j0 - 1], which tile (i - 1, j)
// writes: its left column's last entry) are enough.  The wrapper zeroes the
// flags and the claim counter each call.
//
// Inside a tile, a skewed sweep.  Lane k of warp w owns a run of RUN
// columns of the warp's strip of 32 * RUN columns (4 for tiles of at most
// 128 columns, else 8; launch.lcs_bench times the other choice), and
// handles row r at step r + k.  Its RUN columns of row r - 1 and its t
// values stay in registers.  X[r, c0 - 1], the last column of lane k - 1's
// run, comes with one __shfl_up_sync a step (that lane finished row r the
// step before), and X[r - 1, c0 - 1] is what came the step before.  A cell
// is one __vimax3_s32 (Hopper's three-way integer max) over a wrapping add
// (__viaddmax_s32's add wraps too on the H100, launch.lcs_bench's probe,
// but it saves no instruction here).
// Lane 0 of warp 0 takes left[r] from shared memory; lane 0 of warp w > 0
// takes the right column of warp w - 1's strip, handed over through shared
// memory in blocks of kBlock rows, kSlots blocks in flight per strip
// boundary, each block guarded by a "full" and an "empty" mbarrier: the
// strips run as a pipeline, 32 + kBlock steps apart.  s and left are staged
// in shared memory before the sweep; the right column is collected in
// shared memory and written out once.  The sweep is a template on the
// strip's role (consumer, producer, ragged last column), so a one-warp
// tile's loop holds no ring code.  Row st + 1's (s, left) pair is read a
// step ahead by every lane (one broadcast load) for lane 0, and a lane's s
// moves on to the next lane with a second shuffle (lane k needs s[st -
// k]): a load of its own per lane sat on the step's chain.  The steps with
// every lane inside the tile (all but the first and last 31) carry no
// masks.  Shared words go by 32-bit address (ld.shared): through generic
// pointers the loop re-read the CTA's shared window every step.
//
// What bounds it: integer operations, about four per cell (compare, add,
// max) at the card's INT32 rate, 1.03 ms for a 65,536^2 table; bytes are
// only the borders and sequences.  In practice the chain: a step is two
// shuffles, a broadcast load and RUN dependent maxima, and a table takes
// the chain of ti + tj - 1 tiles, each waiting for whole neighbours (13.8
// ms at p = 132 on the H100, launch.lcs_bench).  A tile that starts its
// row r once its left neighbour has published row r would shorten it.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxRows = 8192;               // rows of a tile
constexpr int kMaxCols = 8 * kMaxThreads;    // columns of a tile
constexpr int kBlock = 16;      // rows a hand-off block between strips
constexpr int kSlots = 4;       // hand-off blocks in flight a boundary
constexpr long long kHangCycles = 1ll << 34;

__device__ __forceinline__ int wrap_add(int x, int y) {
  return (int)((unsigned)x + (unsigned)y);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed; trap after
// ~10 s instead of hanging.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kHangCycles) __trap();
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Spin until *flag >= want (one thread); trap after ~10 s.
__device__ __forceinline__ void wait_flag(const int* flag, int want) {
  const long long t0 = clock64();
  while (ld_acquire(flag) < want) {
    if (clock64() - t0 > kHangCycles) __trap();
    __nanosleep(32);
  }
}

// Tiles on anti-diagonal d of a ti x tj grid.
__device__ __forceinline__ int diag_count(int d, int ti, int tj) {
  return min(min(d + 1, ti), min(tj, ti + tj - 1 - d));
}

// One step of a lane's sweep: row r of its RUN columns from X[r, c0 - 1]
// = x, its row-r value of s and X[r - 1, c0 - 1] = diag.  EDGE: some lane
// of the warp is outside the tile's rows this step (the first and last 31
// steps); `active` lanes update, the others keep their state.
template <int RUN, bool EDGE>
__device__ __forceinline__ void sweep_step(int (&prev)[RUN],
                                           const int (&tv)[RUN], int& diag,
                                           int& last, int x, int si,
                                           bool active) {
  int cur = x, dg = diag;
#pragma unroll
  for (int q = 0; q < RUN; ++q) {
    const int p = prev[q];
    cur = __vimax3_s32(cur, p, wrap_add(dg, tv[q] == si ? 1 : 0));
    dg = p;
    prev[q] = EDGE && !active ? p : cur;
  }
  diag = EDGE && !active ? diag : x;
  last = cur;
}

// prev[at] for a run-time at < RUN, without local memory.
template <int RUN>
__device__ __forceinline__ int pick(const int (&prev)[RUN], int at) {
  int v = prev[0];
#pragma unroll
  for (int q = 1; q < RUN; ++q) v = at == q ? prev[q] : v;
  return v;
}

// Shared-memory words by 32-bit address: no generic-to-shared conversion
// (and no re-read of the CTA's shared window) inside the sweep.
__device__ __forceinline__ int lds(uint32_t a) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// Two words, 8-byte aligned.
__device__ __forceinline__ int2 lds2(uint32_t a) {
  int2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts(uint32_t a, int v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// A strip boundary's hand-off ring: hand[kSlots][kBlock] words, and the
// "full" and "empty" mbarriers of its slots.
struct Ring {
  uint32_t hand, full, empty;
};

__device__ __forceinline__ Ring ring(const int* hand, const uint64_t* bars,
                                     int n_bound, int b) {
  const uint32_t full0 = smem_addr(bars);
  return {smem_addr(hand) + 4u * b * kSlots * kBlock, full0 + 8u * b * kSlots,
          full0 + 8u * (n_bound + b) * kSlots};
}

// What a lane's sweep of one tile reads: the tile's (s, left) pairs, the
// address its right-column word goes to at step st (right + right_step *
// st: its row's word for the lane that owns the tile's last column, the
// spare word for the others), the spare word, the last column's place in
// the owner's run, the tile's rows, the lane, and the hand-off blocks its
// CTA has run before this tile.
struct Strip {
  uint32_t sl, right, right_step, spare;
  int right_at, rows, lane;
  unsigned blk;
};

// The sweep of one warp's strip of a tile: step st does row st - lane.
// CONSUMER: lane 0's left column comes from warp - 1 through `in` (else
// from the tile's left column); PRODUCER: lane 31 hands its last column on
// to warp + 1 through `out`; RAGGED: the tile's last column is not the
// last of its owner's run.  Row st + 1's (s, left) pair is read a step
// ahead by every lane (one broadcast load) for lane 0; a lane's s value
// moves on to the next lane with the step's second shuffle (lane k needs
// s[st - k]), so no lane loads its own; the steps where every lane is
// inside the tile carry no masks.
template <int RUN, bool CONSUMER, bool PRODUCER, bool RAGGED>
__device__ __forceinline__ void sweep(int (&prev)[RUN], const int (&tv)[RUN],
                                      int& diag, const Strip& sp,
                                      const Ring& in, const Ring& out) {
  const int lane = sp.lane, rows = sp.rows;
  auto fetch = [&](int j) -> int {   // a consumer's X[j, c0 - 1]
    if (j >= rows) return 0;
    const unsigned g = sp.blk + j / kBlock;
    const uint32_t slot = g % kSlots;
    if (j % kBlock == 0) bar_wait(in.full + 8 * slot, (g / kSlots) & 1);
    const int v = lds(in.hand + 4 * (slot * kBlock + j % kBlock));
    if (lane == 0 && (j % kBlock == kBlock - 1 || j == rows - 1))
      bar_arrive(in.empty + 8 * slot);
    return v;
  };
  int last = 0;   // X[r, c0 + RUN - 1] of the row done last step
  const int2 first = lds2(sp.sl);
  int x_next = CONSUMER ? fetch(0) : first.y;
  int s_me = first.x;   // s[st - lane], for lane 0 s[0]
  auto step = [&](int st, auto edge) {
    constexpr bool EDGE = decltype(edge)::value;
    const int2 pair = lds2(sp.sl + 8 * min(st + 1, rows - 1));
    const int up = __shfl_up_sync(0xffffffffu, last, 1);
    const int x = lane == 0 ? x_next : up;
    const int si = s_me;
    const int s_up = __shfl_up_sync(0xffffffffu, s_me, 1);
    s_me = lane == 0 ? pair.x : s_up;
    x_next = CONSUMER ? fetch(st + 1) : (st + 1 < rows ? pair.y : 0);
    const int r = st - lane;
    const bool in_tile = !EDGE || (r >= 0 && r < rows);
    sweep_step<RUN, EDGE>(prev, tv, diag, last, x, si, in_tile);
    sts(in_tile ? sp.right + sp.right_step * st : sp.spare,
        RAGGED ? pick<RUN>(prev, sp.right_at) : last);
    if (PRODUCER) {
      const int r31 = st - 31;   // the row lane 31 did this step
      if (r31 >= 0 && r31 < rows) {
        const unsigned g = sp.blk + r31 / kBlock;
        const uint32_t slot = g % kSlots;
        // the slot's previous block must have been read
        if (r31 % kBlock == 0 && g >= kSlots)
          bar_wait(out.empty + 8 * slot, (g / kSlots - 1) & 1);
        sts(lane == 31 ? out.hand + 4 * (slot * kBlock + r31 % kBlock)
                       : sp.spare,
            last);
        if (lane == 31 && (r31 % kBlock == kBlock - 1 || r31 == rows - 1))
          bar_arrive(out.full + 8 * slot);
      }
    }
  };
  // the first 31 steps, the steps with every lane inside, the last 31
  const int steps = rows + 31;
  const int mid0 = min(31, steps), mid1 = max(mid0, rows);
  for (int st = 0; st < mid0; ++st) step(st, std::true_type{});
  for (int st = mid0; st < mid1; ++st) step(st, std::false_type{});
  for (int st = mid1; st < steps; ++st) step(st, std::true_type{});
}

// state: rows (n) | cols (m) | corners (tj) | colprog (tj) | rowprog (ti) |
// counter (1), int32.  rows, cols and corners hold the borders (the
// table's top row, left column and X[-1, j0 - 1] before the launch; the
// bottom row and right column after it); colprog[j] is the number of tiles
// done in tile column j, rowprog[i] in tile row i.
template <int RUN>
__global__ void __launch_bounds__(kMaxThreads)
lcs_kernel(const int* __restrict__ s, const int* __restrict__ t,
           int* __restrict__ state, int m, int n, int tm, int tn, int ti,
           int tj) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int claim_sh;
  const int nw = blockDim.x >> 5;
  const int n_bound = nw - 1;   // strip boundaries
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // mbarriers: full[b][slot] then empty[b][slot]; then the tile's (s,
  // left) pairs and right column; then the hand-off ring
  // hand[b][slot][kBlock]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* sl_sh = reinterpret_cast<int*>(bars + 2 * n_bound * kSlots);
  int* right_sh = sl_sh + 2 * tm;
  int* hand = right_sh + tm + 1;   // right_sh[tm]: a spare word
  const uint32_t full0 = smem_addr(bars);

  int* rows = state;
  int* cols = rows + n;
  int* corners = cols + m;
  int* colprog = corners + tj;
  int* rowprog = colprog + tj;
  int* counter = rowprog + ti;

  if (threadIdx.x == 0)
    for (int i = 0; i < 2 * n_bound * kSlots; ++i) bar_init(full0 + 8 * i);
  __syncthreads();

  const int n_tiles = ti * tj;
  const int c0 = (warp * 32 + lane) * RUN;   // this lane's first column
  int d = 0, d_base = 0;   // the claim cursor: diagonal d starts at d_base
  unsigned blk = 0;        // hand-off blocks this CTA has run, all tiles
  for (;;) {
    if (threadIdx.x == 0) claim_sh = atomicAdd(counter, 1);
    __syncthreads();
    const int k = claim_sh;
    if (k >= n_tiles) break;
    while (k >= d_base + diag_count(d, ti, tj)) {
      d_base += diag_count(d, ti, tj);
      ++d;
    }
    const int i = max(0, d - tj + 1) + (k - d_base), j = d - i;
    const int row0 = i * tm, col0 = j * tn;
    const int rows_here = min(tm, m - row0), cols_here = min(tn, n - col0);

    // what waits on no neighbour: s into shared memory, t into registers
#pragma unroll 4
    for (int r = threadIdx.x; r < rows_here; r += blockDim.x)
      sl_sh[2 * r] = s[row0 + r];
    int tv[RUN];
#pragma unroll
    for (int q = 0; q < RUN; ++q)
      tv[q] = c0 + q < cols_here ? t[col0 + c0 + q] : 0;

    // the top neighbour (i - 1, j) and the left one (i, j - 1)
    if (threadIdx.x == 0) {
      if (i > 0) wait_flag(colprog + j, i);
      if (j > 0) wait_flag(rowprog + i, j);
    }
    __syncthreads();
    // borders through L2 (__ldcg): another SM wrote them
#pragma unroll 4
    for (int r = threadIdx.x; r < rows_here; r += blockDim.x)
      sl_sh[2 * r + 1] = __ldcg(cols + row0 + r);
    int prev[RUN];
#pragma unroll
    for (int q = 0; q < RUN; ++q)
      prev[q] = c0 + q < cols_here ? __ldcg(rows + col0 + c0 + q) : 0;
    // X[-1, c0 - 1]: the corner, or the top row one column left
    int diag = c0 == 0 ? __ldcg(corners + j)
                       : (c0 <= cols_here ? __ldcg(rows + col0 + c0 - 1) : 0);
    __syncthreads();   // staged, and every border read before any write

    // the sweep of this warp's strip
    const bool consumer = warp > 0, producer = warp < n_bound;
    const bool ragged = cols_here % RUN != 0;
    const int last_col = cols_here - 1;
    const bool right_owner = last_col / RUN == warp * 32 + lane;
    const uint32_t right_a = smem_addr(right_sh), spare = right_a + 4 * tm;
    const Ring in = ring(hand, bars, n_bound, warp - 1);
    const Ring out = ring(hand, bars, n_bound, warp);
    const Strip strip = {smem_addr(sl_sh),
                         right_owner ? right_a - 4 * lane : spare,
                         right_owner ? 4u : 0u, spare, last_col % RUN,
                         rows_here, lane, blk};
#define REPRO_LCS_SWEEP(C, P)                                    \
  (ragged ? sweep<RUN, C, P, true>(prev, tv, diag, strip, in, out) \
          : sweep<RUN, C, P, false>(prev, tv, diag, strip, in, out))
    if (!consumer && !producer) REPRO_LCS_SWEEP(false, false);
    else if (!consumer) REPRO_LCS_SWEEP(false, true);
    else if (!producer) REPRO_LCS_SWEEP(true, false);
    else REPRO_LCS_SWEEP(true, true);
#undef REPRO_LCS_SWEEP
    blk += (rows_here + kBlock - 1) / kBlock;
    __syncthreads();   // right_sh whole

    // the tile's borders, then its flags
#pragma unroll
    for (int q = 0; q < RUN; ++q)
      if (c0 + q < cols_here) rows[col0 + c0 + q] = prev[q];
#pragma unroll 4
    for (int r = threadIdx.x; r < rows_here; r += blockDim.x)
      cols[row0 + r] = right_sh[r];
    if (threadIdx.x == 0) corners[j] = sl_sh[2 * rows_here - 1];
    __syncthreads();   // thread 0's release covers the CTA's stores
    if (threadIdx.x == 0) {
      st_release(colprog + j, i + 1);
      st_release(rowprog + i, j + 1);
    }
  }
}

// The run a launch takes: 4 for tiles of at most 128 columns (one full
// warp) and 8 above.
int run_of(int tn) { return tn <= 128 ? 4 : 8; }

size_t smem_bytes(int tm, int warps) {
  const int n_bound = warps - 1;
  return 16 * (size_t)n_bound * kSlots + 4 * (3 * (size_t)tm + 1) +
         4 * (size_t)n_bound * kSlots * kBlock;
}

template <int RUN>
int launch(const int* s, const int* t, int* state, int m, int n, int tm,
           int tn, cudaStream_t stream) {
  const int ti = (m + tm - 1) / tm, tj = (n + tn - 1) / tn;
  const int warps = (tn + 32 * RUN - 1) / (32 * RUN);
  const int threads = 32 * warps;
  const size_t smem = smem_bytes(tm, warps);
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        lcs_kernel<RUN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lcs_kernel<RUN>, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int most = ti < tj ? ti : tj;
  const int grid = most < per_sm * sms ? most : per_sm * sms;
  lcs_kernel<RUN><<<grid, threads, smem, stream>>>(s, t, state, m, n, tm, tn,
                                                   ti, tj);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The widest and tallest tile one CTA takes.
int lcs_tile_max_n() { return kMaxCols; }
int lcs_tile_max_m() { return kMaxRows; }
int lcs_run(int tn) { return run_of(tn); }

// The whole (m x n) table of s (m,) against t (n,), int32 on the device,
// in (tm x tn) tiles (ragged at the far edges), in one launch on `stream`.
// state (n + m + 2 tj + ti + 1,) int32 as lcs_kernel lays it out: borders
// in, borders out, flags and counter zero.  Returns the CUDA error of the
// launch.
int lcs_table(const int* s, const int* t, int* state, int m, int n, int tm,
              int tn, void* stream) {
  if (m < 1 || n < 1 || tm < 1 || tn < 1 || tm > kMaxRows || tn > kMaxCols)
    return (int)cudaErrorInvalidValue;
  if ((long long)((m + tm - 1) / tm) * ((n + tn - 1) / tn) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (run_of(tn) == 4) return launch<4>(s, t, state, m, n, tm, tn, st);
  return launch<8>(s, t, state, m, n, tm, tn, st);
}

}  // extern "C"
