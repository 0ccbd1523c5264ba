// Paged MLA latent decode attention for Hopper (sm_90a).
//
// Replaces src/repro/kernels/attention/attention.py:paged_latent_decode_pallas
// (body _paged_latent_decode_kernel): one absorbed-MLA decode query per slot
// and head against the head-free latent pools, reached through the slot's
// block table, over key positions < length.
//
// q_lat  (B, H, kv_lora), q_rope (B, H, qk_rope)   (the model's (B, 1, H, .))
// ckv    (n_pool, page, kv_lora), kr (n_pool, page, qk_rope)
// tables (B, width) int32, lengths (B,) int32  (the new token's latent is
//                                               already written)
// out    (B, H, kv_lora) in q's type
//
// The TPU kernel walks grid (B, pages) with one (H, kv_lora) accumulator in
// VMEM.  Here the H heads of a slot are the query rows of the shared latent
// tile walk in paged_latent_common.cuh: 16 heads per CTA (the 128 x 512 f32
// accumulator of a full-width slot does not fit one CTA), the slot's valid
// key range cut into 128-key splits so that 8 slots still give hundreds of
// CTAs, and a merge kernel over the splits.  What bounds it, and the rest
// of the design, is in that header.

#include "paged_latent_common.cuh"

extern "C" {

// Limits and scratch sizes the wrapper reads before it launches.
int paged_latent_decode_max_kv() { return 32 * latent::kMaxEpl; }
int paged_latent_decode_max_feat() { return latent::kMaxFeat; }
int paged_latent_decode_splits(int width, int page, int batch, int heads) {
  return latent::splits(width, page,
                        batch * ((heads + latent::kRows - 1) / latent::kRows));
}

// dtype: 0 = float32, 1 = bfloat16.  part_acc (n_split, B*H, kv_lora) and
// part_ml (n_split, B*H, 2) are f32 scratch, unused when n_split == 1.
// Returns cudaGetLastError().
int paged_latent_decode(int dtype, const void* q_lat, const void* q_rope,
                        const void* ckv, const void* kr,
                        const int* block_tables, const int* lengths,
                        void* out, void* part_acc, void* part_ml, int batch,
                        int heads, int kv, int rope, int page, int width,
                        int n_pool, float scale, void* stream) {
  return latent::launch<false>(dtype, q_lat, q_rope, ckv, kr, block_tables,
                               lengths, out, part_acc, part_ml, batch, heads,
                               heads, kv, rope, page, width, n_pool, 0, scale,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
