// Shared device helpers of the paged attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

// Finite "minus infinity" of the TPU kernels: exp(NEG_INF - m) is an exact
// 0 for any real m, and exp(NEG_INF - NEG_INF) = 1 never makes a NaN.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_val(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_val(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Elements of T in one 16-byte load.
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

// N consecutive elements of T, widened to floats, in as few loads as their
// size allows (src must be aligned to N * sizeof(T) up to 16 bytes).
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* __restrict__ src,
                                       float* dst) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
    uint4 raw[kBytes / 16];
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      raw[i] = reinterpret_cast<const uint4*>(src)[i];
    const T* v = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = to_f32(v[j]);
  } else if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(src);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = to_f32(v[j]);
  } else if constexpr (kBytes == 4) {
    const unsigned raw = *reinterpret_cast<const unsigned*>(src);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = to_f32(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = to_f32(src[j]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Split-K merge: each of n_split key ranges left, per output row, its
// unnormalized f32 accumulator (part_acc, (n_split, rows, d)) and its
// running max and sum (part_ml, (n_split, rows, 2)).  One CTA per row.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               T* __restrict__ out, int rows, int d,
                               int n_split) {
  const int row = blockIdx.x;
  float m = kNegInf;
  for (int s = 0; s < n_split; ++s)
    m = fmaxf(m, part_ml[((long long)s * rows + row) * 2]);
  float l = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* ml = part_ml + ((long long)s * rows + row) * 2;
    l += ml[1] * expf(ml[0] - m);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  for (int dd = threadIdx.x; dd < d; dd += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const long long r = (long long)s * rows + row;
      acc += part_acc[r * d + dd] * expf(part_ml[r * 2] - m);
    }
    store_val(out + (long long)row * d + dd, acc * inv);
  }
}

// Tensor-core fragments (mma.sync m16n8k16, bf16 in, f32 accumulation)
// and the ldmatrix loads that fill them from shared memory.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Opt a kernel into more than 48 KB of dynamic shared memory (once per
// kernel and size); without it the launch is refused.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t* opted_in) {
  if (bytes <= *opted_in) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *opted_in = bytes;
  return e;
}

}  // namespace paged
