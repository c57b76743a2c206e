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

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
