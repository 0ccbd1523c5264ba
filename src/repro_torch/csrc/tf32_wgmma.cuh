// float32 products on Hopper's tensor cores, as three TF32 products: the
// helpers the float32 kernels share (matmul.cu's "wgmma_tf32x3" walk and
// the flash pair's float32 family, flash_tf32.cuh).
//
// The tensor cores have no f32 mode.  Each operand element x is split into
// hi = x rounded to TF32 and lo = (x - hi) rounded to TF32 (split_tf32),
// and a product accumulates A_lo B_hi, A_hi B_lo and A_hi B_hi (small
// terms first) in one set of f32 accumulators; the dropped A_lo B_lo is
// 2^-22 of the product.  wgmma reads a TF32 operand as an f32 bit pattern
// and ignores its low 13 bits, so both parts are rounded explicitly
// (cvt.rna).  wgmma takes TF32 operands from shared memory K-major only
// (the transpose bits are for 16-bit types, and TMA does not transpose):
// a B operand whose reduction index does not run along its rows needs a
// transposed copy.  The A operand comes from registers (mma_tf32_n*): a
// thread holds a0 (row g, column t4), a1 (g + 8, t4), a2 (g, t4 + 4), a3
// (g + 8, t4 + 4) of its warp's 16 rows of an m64 x k8 slice (g = lane /
// 4, t4 = lane % 4; verified on an H100).  The tensor cores'
// accumulator truncates: summed over a long k in one accumulator the three
// products drift (5.8e-5 of the largest output at k = 8192 in matmul.cu),
// so each kernel sums at most 128 of k from zero and adds that into a
// second f32 total with rounded adds.
#pragma once

#include <cstdint>

namespace tf32x3 {

// x rounded to TF32, to nearest with ties away from zero (cvt.rna), as an
// f32 bit pattern whose low 13 bits are 0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x -> its TF32 hi part and the remainder's TF32 lo part.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// As split_tf32 without conversion instructions, for A fragments split
// anew for every product (the flash pair's float32 family): hi rounded to
// nearest, ties away (cvt.rna's result), by an integer add and a mask, and
// lo = x - hi exact in f32, left to wgmma, which reads its TF32 bits (lo
// truncated: 2^-11 of lo, 2^-22 of x).  Three full-rate ALU instructions
// an element where split_tf32 takes two conversions and a subtraction.
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& hi,
                                                uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The lo part of x where x's own bit pattern is its hi part (an operand
// that TMA loads from the tensor itself; wgmma reads it truncated to
// TF32): (x - x truncated) rounded to TF32, within 2^-21 of x.
__device__ __forceinline__ uint32_t lo_of_raw(float x) {
  return tf32_rna(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u));
}

// d (64 x N, f32) {=, +=} A (64 x 8, TF32 in registers, the fragment
// above) B (8 x N, TF32 in shared memory through a K-major descriptor),
// for N 32, 64 and 128; the _z forms start d from zero (d is an output
// only, so the registers it held before are free).
__device__ __forceinline__ void mma_tf32_n32(float* d, const uint32_t* a,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void mma_tf32_n32_z(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      :
        "=&f"(d[0]), "=&f"(d[1]), "=&f"(d[2]), "=&f"(d[3]),
        "=&f"(d[4]), "=&f"(d[5]), "=&f"(d[6]), "=&f"(d[7]),
        "=&f"(d[8]), "=&f"(d[9]), "=&f"(d[10]), "=&f"(d[11]),
        "=&f"(d[12]), "=&f"(d[13]), "=&f"(d[14]), "=&f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(0));
}

__device__ __forceinline__ void mma_tf32_n64(float* d, const uint32_t* a,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
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

__device__ __forceinline__ void mma_tf32_n64_z(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
        "=&f"(d[0]), "=&f"(d[1]), "=&f"(d[2]), "=&f"(d[3]),
        "=&f"(d[4]), "=&f"(d[5]), "=&f"(d[6]), "=&f"(d[7]),
        "=&f"(d[8]), "=&f"(d[9]), "=&f"(d[10]), "=&f"(d[11]),
        "=&f"(d[12]), "=&f"(d[13]), "=&f"(d[14]), "=&f"(d[15]),
        "=&f"(d[16]), "=&f"(d[17]), "=&f"(d[18]), "=&f"(d[19]),
        "=&f"(d[20]), "=&f"(d[21]), "=&f"(d[22]), "=&f"(d[23]),
        "=&f"(d[24]), "=&f"(d[25]), "=&f"(d[26]), "=&f"(d[27]),
        "=&f"(d[28]), "=&f"(d[29]), "=&f"(d[30]), "=&f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(0));
}

__device__ __forceinline__ void mma_tf32_n128(float* d, const uint32_t* a,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

__device__ __forceinline__ void mma_tf32_n128_z(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      :
        "=&f"(d[0]), "=&f"(d[1]), "=&f"(d[2]), "=&f"(d[3]),
        "=&f"(d[4]), "=&f"(d[5]), "=&f"(d[6]), "=&f"(d[7]),
        "=&f"(d[8]), "=&f"(d[9]), "=&f"(d[10]), "=&f"(d[11]),
        "=&f"(d[12]), "=&f"(d[13]), "=&f"(d[14]), "=&f"(d[15]),
        "=&f"(d[16]), "=&f"(d[17]), "=&f"(d[18]), "=&f"(d[19]),
        "=&f"(d[20]), "=&f"(d[21]), "=&f"(d[22]), "=&f"(d[23]),
        "=&f"(d[24]), "=&f"(d[25]), "=&f"(d[26]), "=&f"(d[27]),
        "=&f"(d[28]), "=&f"(d[29]), "=&f"(d[30]), "=&f"(d[31]),
        "=&f"(d[32]), "=&f"(d[33]), "=&f"(d[34]), "=&f"(d[35]),
        "=&f"(d[36]), "=&f"(d[37]), "=&f"(d[38]), "=&f"(d[39]),
        "=&f"(d[40]), "=&f"(d[41]), "=&f"(d[42]), "=&f"(d[43]),
        "=&f"(d[44]), "=&f"(d[45]), "=&f"(d[46]), "=&f"(d[47]),
        "=&f"(d[48]), "=&f"(d[49]), "=&f"(d[50]), "=&f"(d[51]),
        "=&f"(d[52]), "=&f"(d[53]), "=&f"(d[54]), "=&f"(d[55]),
        "=&f"(d[56]), "=&f"(d[57]), "=&f"(d[58]), "=&f"(d[59]),
        "=&f"(d[60]), "=&f"(d[61]), "=&f"(d[62]), "=&f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(0));
}

// d {=, +=} A B at width N: ACC false starts d from zero.
template <int N, bool ACC>
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma width");
  if constexpr (N == 32 && ACC)
    mma_tf32_n32(d, a, db, 1);
  else if constexpr (N == 32)
    mma_tf32_n32_z(d, a, db);
  else if constexpr (N == 64 && ACC)
    mma_tf32_n64(d, a, db, 1);
  else if constexpr (N == 64)
    mma_tf32_n64_z(d, a, db);
  else if constexpr (ACC)
    mma_tf32_n128(d, a, db, 1);
  else
    mma_tf32_n128_z(d, a, db);
}

}  // namespace tf32x3
