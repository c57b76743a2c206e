// Complex arithmetic shared by the local-apply kernels.
//
// cplx<T> has the memory layout of torch.complex64 (T = float) and
// torch.complex128 (T = double): interleaved (re, im), aligned to its size,
// so a tensor's data_ptr() can be read as an array of cplx<T>.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

template <typename T>
struct alignas(2 * sizeof(T)) cplx {
  T re, im;
};

template <typename T>
__device__ __forceinline__ void cfma(cplx<T>& acc, const cplx<T> a, const cplx<T> b) {
  acc.re += a.re * b.re - a.im * b.im;
  acc.im += a.re * b.im + a.im * b.re;
}

// Read-only loads through the texture path (factors and the potential are
// small and re-read by every block, so they stay resident in L1/L2).
__device__ __forceinline__ cplx<double> ldg(const cplx<double>* p) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  return cplx<double>{v.x, v.y};
}

__device__ __forceinline__ cplx<float> ldg(const cplx<float>* p) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  return cplx<float>{v.x, v.y};
}

__device__ __forceinline__ double ldg(const double* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }

// D = A B + D on one 8 x 8 f64 tile on the tensor cores (DMMA, sm_80+): a
// lane holds A[gr][tg], B[tg][gr] and D[gr][2 tg], D[gr][2 tg + 1], where
// gr = lane / 4 and tg = lane % 4.
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1]) : "d"(a), "d"(b));
}

// One complex k-step of a tile in four real MMAs: acc[0] += ar br - ai bi,
// acc[1] += ar bi + ai br.
__device__ __forceinline__ void cmma(double (&acc)[2][2], double2 a, double br, double bi) {
  dmma(acc[0], a.x, br);
  dmma(acc[0], -a.y, bi);
  dmma(acc[1], a.x, bi);
  dmma(acc[1], a.y, br);
}

// ---- bf16 tensor cores (mma.sync m16n8k16, HMMA) ---------------------------
// Fragments of a 16 x 16 A tile, a 16 x 8 B tile and a 16 x 8 f32 C tile,
// with gr = lane / 4 and tg = lane % 4 (each 32-bit register two bf16, the
// lower column or k index in the low half):
//   A: a0 (gr, 2tg..+1), a1 (gr+8, 2tg..+1), a2 (gr, 2tg+8..+9), a3 (gr+8, 2tg+8..+9)
//   B: b0 (k 2tg..+1, n gr), b1 (k 2tg+8..+9, n gr)
//   C: c0, c1 (gr, 2tg..+1), c2, c3 (gr+8, 2tg..+1)
// A complex B fragment is one uint4 {re b0, re b1, im b0, im b1}.

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void hmma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                     unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A complex A fragment: re, im and -im (negating a bf16 is exact: its sign
// bit), negated once a k-step for all the tiles it feeds
struct CFragA {
  unsigned re[4], im[4], nim[4];
  __device__ __forceinline__ void negate() {
    #pragma unroll
    for (int i = 0; i < 4; ++i) nim[i] = im[i] ^ 0x80008000u;
  }
};

// One complex k-step of a 16 x 8 tile in four real MMAs:
// acc[0] += Ar Br + (-Ai) Bi, acc[1] += Ar Bi + Ai Br.
__device__ __forceinline__ void chmma(float (&acc)[2][4], const CFragA& a, uint4 b) {
  hmma(acc[0], a.re, b.x, b.y);
  hmma(acc[0], a.nim, b.z, b.w);
  hmma(acc[1], a.re, b.z, b.w);
  hmma(acc[1], a.im, b.x, b.y);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i (.trans: each transposed)
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
