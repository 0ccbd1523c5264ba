// Paged MLA latent chunked-prefill attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/attention/attention.py:270
// paged_latent_prefill_pallas (body _paged_latent_prefill_kernel): one
// slot's C-token chunk at global positions [start, start + C), all H
// heads, against the head-free latent pools of the slot's block row, under
// the GLOBAL causal mask (which also masks stale and future page contents).
//
// q_lat (C, H, kv_lora), q_rope (C, H, qk_rope)    (the model's (1, C, H, .))
// ckv   (n_pool, page, kv_lora), kr (n_pool, page, qk_rope)
// row   (width,) int32
// out   (C, H, kv_lora) in q's type
//
// The TPU kernel folds the heads into its q-block rows (bq * H rows with
// bq = 128 / H, a single position at H = 128) and walks every page of the
// row.  Here the C * H (position, head) rows are the query rows of a
// latent tile walk, each CTA walking only the keys up to its last row's
// position.  The chunk is about 34 GFLOP at deepseek-v2's serving shape
// (C 128 at start 896, H 128), bound by the products.  Three families, by
// the shapes (paged_latent_prefill_variant names the one a call takes):
//  * "wgmma" (bf16 at kv_lora 512, qk_rope 64, pages of a multiple of 64):
//    64-row blocks on wgmma with TMA loads, paged_latent_wgmma.cuh;
//  * "mma_sync" (other bf16 widths the m16n8k16 tiles divide) and
//    "cuda_cores" (float32 and the rest): the 16-row walk shared with the
//    decode kernel, paged_latent_common.cuh.
// A chunk too short to fill the card splits its keys, and a merge kernel
// adds the splits up in split order.
//
// paged_latent_verify is the speculative-verify entry: the W-token windows
// of all B slots in one launch (jax.vmap of the TPU kernel over the slots),
//
// q_lat (B, W, H, kv_lora), q_rope (B, W, H, qk_rope)
// tables (B, width) int32, lengths (B,) int32  slot b's window starts at
//                                              lengths[b], read on the device
// out   (B, W, H, kv_lora) in q's type
//
// row r of slot b (position r / H of the window) masked at lengths[b] +
// r / H + 1.  bf16 at kv_lora 512, qk_rope 64 and pages of a multiple of
// 64 takes "cluster" (paged_latent_wgmma.cuh's verify_kernel: one launch
// of clusters, one per (slot, 64-row block), the ranks' shares sized on
// the device from the block's live keys and merged on chip in rank order;
// no scratch).  The other shapes take "mma_sync" or "cuda_cores" with the
// slot as a grid axis; their key splits are sized on the host from the
// table's width, a split past a slot's last key walks nothing and weighs 0
// in the merge kernel.

#include "paged_latent_common.cuh"
#include "paged_latent_wgmma.cuh"

namespace {

enum Variant { kCudaCores = 0, kMmaSync = 1, kWgmma = 2 };
// The verify entry's families, numbered as the wrapper's VERIFY_VARIANTS.
enum VerifyVariant { kVerifyCudaCores = 0, kVerifyMmaSync = 1,
                     kVerifyCluster = 2 };

// The family latent::launch or latent_wgmma::launch takes for the shape.
int variant(int dtype, int kv, int rope, int page) {
  if (latent_wgmma::takes(dtype, kv, rope, page)) return kWgmma;
  if (dtype == 1 && (kv == 64 || kv == 128 || kv == 256 || kv == 512) &&
      (kv + rope) % 16 == 0)
    return kMmaSync;
  return kCudaCores;
}

}  // namespace

extern "C" {

// Limits and scratch sizes the wrapper reads before it launches.
int paged_latent_prefill_max_kv() { return 32 * latent::kMaxEpl; }
int paged_latent_prefill_max_feat() { return latent::kMaxFeat; }
int paged_latent_prefill_variant(int dtype, int kv, int rope, int page) {
  return variant(dtype, kv, rope, page);
}
int paged_latent_prefill_splits(int dtype, int kv, int rope, int width,
                                int page, int chunk, int heads, int start) {
  if (variant(dtype, kv, rope, page) == kWgmma) {
    int n_split, split_keys;
    latent_wgmma::splits(start, chunk, heads, &n_split, &split_keys);
    return n_split;
  }
  return latent::splits(
      width, page, (chunk * heads + latent::kRows - 1) / latent::kRows);
}

// The verify entry's family: 2 "cluster" (the prefill's "wgmma" shapes),
// else as the prefill's.
int paged_latent_verify_variant(int dtype, int kv, int rope, int page) {
  const int v = variant(dtype, kv, rope, page);
  return v == kWgmma ? kVerifyCluster : v;
}

// The key splits of the verify entry's split families (the cluster family
// takes no scratch: 1).
int paged_latent_verify_splits(int dtype, int kv, int rope, int width,
                               int page, int batch, int w, int heads) {
  if (variant(dtype, kv, rope, page) == kWgmma) return 1;
  return latent::splits(
      width, page,
      batch * ((w * heads + latent::kRows - 1) / latent::kRows));
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
  if (variant(dtype, kv, rope, page) == kWgmma)
    return latent_wgmma::launch(q_lat, q_rope, ckv, kr, block_row, out,
                                part_acc, part_ml, chunk, heads, page, width,
                                n_pool, start, scale,
                                static_cast<cudaStream_t>(stream));
  return latent::launch<true>(dtype, q_lat, q_rope, ckv, kr, block_row,
                              nullptr, out, part_acc, part_ml, 1,
                              chunk * heads, heads, kv, rope, page, width,
                              n_pool, start, scale,
                              static_cast<cudaStream_t>(stream));
}

// The verify entry.  part_acc (n_split, B*W*H, kv_lora) and part_ml
// (n_split, B*W*H, 2) are f32 scratch for paged_latent_verify_splits key
// splits, unused when n_split == 1 (always in the cluster family).
// Returns cudaGetLastError().
int paged_latent_verify(int dtype, const void* q_lat, const void* q_rope,
                        const void* ckv, const void* kr, const int* tables,
                        const int* lengths, void* out, void* part_acc,
                        void* part_ml, int batch, int w, int heads, int kv,
                        int rope, int page, int width, int n_pool,
                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant(dtype, kv, rope, page) == kWgmma)
    return latent_wgmma::launch_verify(q_lat, q_rope, ckv, kr, tables,
                                       lengths, out, batch, w, heads, page,
                                       width, n_pool, scale, s);
  return latent::launch<true>(dtype, q_lat, q_rope, ckv, kr, tables, lengths,
                              out, part_acc, part_ml, batch, w * heads, heads,
                              kv, rope, page, width, n_pool, 0, scale, s);
}

}  // extern "C"
