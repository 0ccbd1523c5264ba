// LCS dynamic-programming tiles of one anti-diagonal of the PACO
// wavefront, one CTA per tile: the base case of PACO LCS.
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
// One launch covers a whole anti-diagonal of tiles: the JAX wrapper calls
// the kernel once per tile from a Python double loop
// (repro/kernels/lcs/ops.py), 65,536 calls at n = 65,536 with tiles of
// 256, where this takes 511 launches.  PACO's p processors map onto the
// SMs: every tile of a diagonal is independent.  Borders live in two
// device arrays, each in two halves that alternate with the diagonal's
// parity (diagonal d reads half (d + 1) & 1 and writes half d & 1, so no
// tile overwrites a border another tile of its diagonal still reads): the
// bottom rows at the tile-row boundary (length n) and the right columns at
// the tile-column boundary (length m).  Tile (i, j) also needs the corner
// X[i0 - 1, j0 - 1]: that is the last entry of the left column of tile
// (i - 1, j), which writes it to corners[j] of its half.  Each CTA computes
// its own offsets from the diagonal index and blockIdx.
//
// Inside a CTA each thread owns a run of kRun = 8 columns: its t values and
// its part of the previous row stay in registers.  A row is one block-wide
// inclusive max-scan: the thread's run scanned in registers, then a warp
// scan with __shfl_up_sync, then, with more than one warp, a max over the
// warp totals in shared memory (one __syncthreads a row, the totals double
// buffered by row parity).  The next row's diagonal entry at a run's first
// column comes from the neighbouring thread by __shfl_up_sync, or, at a
// warp's first lane, from the left border and the warp prefix (a row is a
// running max, so the last column of the warp before holds exactly that).
// s[i] and left[i] are loaded one row ahead.
//
// What bounds it: integer operations, about four per cell (compare, add,
// max, running max) at the card's INT32 rate (64 per clock per SM); bytes
// are only the borders and sequences, O(n + m) per tile against O(n m)
// cells.  Each row costs a chain of dependent shuffles, so a CTA is bound
// by latency; many CTAs per SM, one per tile, hide part of it.  Faster
// designs (bit-parallel LCS, a diagonal sweep inside the tile) are later
// work.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kRun = 8;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ int wrap_add(int x, int y) {
  return (int)((unsigned)x + (unsigned)y);
}

__global__ void __launch_bounds__(kMaxThreads)
lcs_diag_kernel(const int* __restrict__ s, const int* __restrict__ t,
                const int* __restrict__ rows_in,
                const int* __restrict__ cols_in,
                const int* __restrict__ corners_in, int* __restrict__ rows_out,
                int* __restrict__ cols_out, int* __restrict__ corners_out,
                int tm, int tn, int d, int i_lo) {
  __shared__ int totals[2][32];
  const int ti = i_lo + blockIdx.x, tj = d - ti;
  const int* s_t = s + (long long)ti * tm;
  const int* t_t = t + (long long)tj * tn;
  const int* top = rows_in + (long long)tj * tn;
  const int* left = cols_in + (long long)ti * tm;
  int* bottom = rows_out + (long long)tj * tn;
  int* right = cols_out + (long long)ti * tm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool multi_warp = blockDim.x > 32;
  const int c0 = threadIdx.x * kRun;
  const unsigned full = 0xffffffffu;

  int tv[kRun], prev[kRun];
#pragma unroll
  for (int r = 0; r < kRun; ++r) {
    const bool ok = c0 + r < tn;
    tv[r] = ok ? t_t[c0 + r] : 0;
    prev[r] = ok ? top[c0 + r] : INT_MIN;
  }
  // X[i0 - 1, c0 - 1]: the corner, or the top row one column left
  int diag0 = c0 == 0 ? corners_in[tj] : (c0 <= tn ? top[c0 - 1] : INT_MIN);

  int s_next = s_t[0], l_next = left[0];
  for (int row = 0; row < tm; ++row) {
    const int si = s_next, li = l_next;
    if (row + 1 < tm) {
      s_next = s_t[row + 1];
      l_next = left[row + 1];
    }
    // a = max(prev, diag + eq), scanned along the run
    int loc[kRun];
    int run = INT_MIN, dg = diag0;
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      const int a = max(prev[r], wrap_add(dg, tv[r] == si ? 1 : 0));
      dg = prev[r];
      run = max(run, a);
      loc[r] = run;
    }
    // warp inclusive scan of the runs' maxima
    int incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(full, incl, o);
      if (lane >= o) incl = max(incl, v);
    }
    int excl = __shfl_up_sync(full, incl, 1);
    if (lane == 0) excl = INT_MIN;
    // the maximum over the warps before this one
    int wpre = INT_MIN;
    if (multi_warp) {
      if (lane == 31) totals[row & 1][warp] = incl;
      __syncthreads();
      wpre = __reduce_max_sync(full, lane < warp ? totals[row & 1][lane]
                                                 : INT_MIN);
    }
    const int pre = max(max(li, wpre), excl);
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      prev[r] = max(loc[r], pre);
      if (c0 + r == tn - 1) right[row] = prev[r];
    }
    // next row's diagonal at column c0: X[row, c0 - 1]
    const int up = __shfl_up_sync(full, prev[kRun - 1], 1);
    diag0 = lane == 0 ? max(li, wpre) : up;
  }
#pragma unroll
  for (int r = 0; r < kRun; ++r)
    if (c0 + r < tn) bottom[c0 + r] = prev[r];
  if (threadIdx.x == 0) corners_out[tj] = left[tm - 1];
}

}  // namespace

// Widest tile the kernel takes: kRun columns for each of 1024 threads.
extern "C" int lcs_tile_max_n() { return kRun * kMaxThreads; }

// One anti-diagonal d of (tm x tn) tiles: n_tiles tiles (i, d - i) for
// i = i_lo .. i_lo + n_tiles - 1.  s (ti * tm,) and t (tj * tn,) int32;
// rows_in / rows_out (tj * tn,), cols_in / cols_out (ti * tm,) and
// corners_in / corners_out (tj,) are the halves of the border arrays that
// diagonal d reads and writes.  Returns the CUDA error of the launch.
extern "C" int lcs_diagonal(const int* s, const int* t, const int* rows_in,
                            const int* cols_in, const int* corners_in,
                            int* rows_out, int* cols_out, int* corners_out,
                            int tm, int tn, int d, int i_lo, int n_tiles,
                            void* stream) {
  if (tm < 1 || tn < 1 || tn > kRun * kMaxThreads || n_tiles < 1)
    return (int)cudaErrorInvalidValue;
  const int runs = (tn + kRun - 1) / kRun;
  const int threads = ((runs + 31) / 32) * 32;
  lcs_diag_kernel<<<n_tiles, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, t, rows_in, cols_in, corners_in, rows_out, cols_out, corners_out, tm,
      tn, d, i_lo);
  return (int)cudaGetLastError();
}
