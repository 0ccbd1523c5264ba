// Paged MLA latent chunked-prefill attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/attention/attention.py:paged_latent_prefill_pallas
// (body _paged_latent_prefill_kernel): one slot's C-token chunk at global
// positions [start, start + C), all H heads, against the head-free latent
// pools of the slot's block row, under the GLOBAL causal mask (which also
// masks stale and future page contents).
//
// q_lat (C, H, kv_lora), q_rope (C, H, qk_rope)    (the model's (1, C, H, .))
// ckv   (n_pool, page, kv_lora), kr (n_pool, page, qk_rope)
// row   (width,) int32
// out   (C, H, kv_lora) in q's type
//
// The TPU kernel folds the heads into its q-block rows (bq * H rows with
// bq = 128 / H, a single position at H = 128) and walks every page of the
// row.  Here the C * H (position, head) rows are the query rows of the
// shared latent tile walk in paged_latent_common.cuh, 16 consecutive rows
// per CTA (16 heads of one position at full width), each CTA walking only
// the keys up to its last row's position.  A full-width chunk (C = 128,
// H = 128) gives 1,024 CTAs, so it needs no key split; a small chunk is
// split over keys and merged like decode.  The chunk is about 34 GFLOP at
// start 896, bound by the products: bf16 runs them on tensor cores.

#include "paged_latent_common.cuh"

extern "C" {

// Limits and scratch sizes the wrapper reads before it launches.
int paged_latent_prefill_max_kv() { return 32 * latent::kMaxEpl; }
int paged_latent_prefill_max_feat() { return latent::kMaxFeat; }
int paged_latent_prefill_splits(int width, int page, int chunk, int heads) {
  return latent::splits(
      width, page, (chunk * heads + latent::kRows - 1) / latent::kRows);
}

// dtype: 0 = float32, 1 = bfloat16.  part_acc (n_split, C*H, kv_lora) and
// part_ml (n_split, C*H, 2) are f32 scratch, unused when n_split == 1.
// Returns cudaGetLastError().
int paged_latent_prefill(int dtype, const void* q_lat, const void* q_rope,
                         const void* ckv, const void* kr,
                         const int* block_row, void* out, void* part_acc,
                         void* part_ml, int chunk, int heads, int kv,
                         int rope, int page, int width, int n_pool,
                         int start, float scale, void* stream) {
  return latent::launch<true>(dtype, q_lat, q_rope, ckv, kr, block_row,
                              nullptr, out, part_acc, part_ml, 1,
                              chunk * heads, heads, kv, rope, page, width,
                              n_pool, start, scale,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
