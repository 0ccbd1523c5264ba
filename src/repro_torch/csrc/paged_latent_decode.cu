// Paged MLA latent decode attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/attention/attention.py:463
// paged_latent_decode_pallas (body _paged_latent_decode_kernel): one
// absorbed-MLA decode query per slot and head against the head-free latent
// pools, reached through the slot's block table, over key positions <
// length.
//
// q_lat  (B, H, kv_lora), q_rope (B, H, qk_rope)   (the model's (B, 1, H, .))
// ckv    (n_pool, page, kv_lora), kr (n_pool, page, qk_rope)
// tables (B, width) int32, lengths (B,) int32  (the new token's latent is
//                                               already written)
// out    (B, H, kv_lora) in q's type
//
// The TPU kernel walks grid (B, pages) with one (H, kv_lora) accumulator in
// VMEM.  Here the H heads of a slot are the query rows of a latent tile
// walk.  Three families, by the shapes (paged_latent_decode_variant names
// the one a call takes):
//  * "wgmma" (bf16 at kv_lora 512, qk_rope 64, pages of a multiple of 64:
//    deepseek-v2's serving geometry): one launch of clusters of 4
//    ranks per (slot, 64-head block), each rank a 64-key-aligned share of
//    the slot's live keys, the ranks merged on chip through distributed
//    shared memory; the walk of the latent prefill, paged_latent_wgmma.cuh
//    (its header says what bounds it and the design);
//  * "mma_sync" (other bf16 widths the m16n8k16 tiles divide) and
//    "cuda_cores" (float32 and the rest): 16 heads per CTA, the table's
//    key range cut into 128-key splits, and a merge kernel over the splits,
//    paged_latent_common.cuh.

#include "paged_latent_common.cuh"
#include "paged_latent_wgmma.cuh"

namespace {

enum Variant { kCudaCores = 0, kMmaSync = 1, kWgmma = 2 };

// The family latent_wgmma::launch_decode or latent::launch takes.
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
int paged_latent_decode_max_kv() { return 32 * latent::kMaxEpl; }
int paged_latent_decode_max_feat() { return latent::kMaxFeat; }
int paged_latent_decode_variant(int dtype, int kv, int rope, int page) {
  return variant(dtype, kv, rope, page);
}
// Key splits of the mma_sync and CUDA-core families (the wgmma one takes
// none: its ranks merge on chip).
int paged_latent_decode_splits(int width, int page, int batch, int heads) {
  return latent::splits(width, page,
                        batch * ((heads + latent::kRows - 1) / latent::kRows));
}

// dtype: 0 = float32, 1 = bfloat16.  part_acc (n_split, B*H, kv_lora) and
// part_ml (n_split, B*H, 2) are f32 scratch of the other families, unused
// when n_split == 1 and by the wgmma family.  Returns cudaGetLastError().
int paged_latent_decode(int dtype, const void* q_lat, const void* q_rope,
                        const void* ckv, const void* kr,
                        const int* block_tables, const int* lengths,
                        void* out, void* part_acc, void* part_ml, int batch,
                        int heads, int kv, int rope, int page, int width,
                        int n_pool, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant(dtype, kv, rope, page) == kWgmma)
    return latent_wgmma::launch_decode(q_lat, q_rope, ckv, kr, block_tables,
                                       lengths, out, batch, heads, page,
                                       width, n_pool, scale, s);
  return latent::launch<false>(dtype, q_lat, q_rope, ckv, kr, block_tables,
                               lengths, out, part_acc, part_ml, batch, heads,
                               heads, kv, rope, page, width, n_pool, 0, scale,
                               s);
}

}  // extern "C"
