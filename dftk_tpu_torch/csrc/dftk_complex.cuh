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

// An operand of a complex product.  kBf16 (T = float only): real and
// imaginary parts rounded to bf16, round-to-nearest-even, as
// `x.astype(jnp.bfloat16)` does in the TPU kernels' 'default' precision.
// The product of two such values is exact in f32, so the sums that use
// them accumulate in f32 as the MXU's one-pass bf16 products do.
template <typename T, bool kBf16>
__device__ __forceinline__ cplx<T> operand(const cplx<T> v) {
  if constexpr (kBf16) {
    static_assert(sizeof(T) == sizeof(float), "the bf16 mode takes complex64 data");
    return cplx<T>{__bfloat162float(__float2bfloat16_rn(v.re)),
                   __bfloat162float(__float2bfloat16_rn(v.im))};
  } else {
    return v;
  }
}

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

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
