// Kernel B: the local potential applied to one z-plane of z-transformed
// compact cubes, through pruned DFTs along y and x.
//
// Replaces the TPU kernel
//   dftk_tpu/kernels/fused_filter.py::fused_filter_mid (body
//   _filter_mid_kernel): F2f (y, m2 -> n2) -> F1f (x, m1 -> n1) -> *V(z)[x,y]
//   -> F1b -> F2b,
// and, with kernel A (pruned_axis_dft.cu) before and after it, the whole of
//   dftk_tpu/kernels/fused_local.py::fused_local_apply.
//
// One block per (k-point, band, z) plane:
//   in  t[k, band, z] : [m1, m2] compact x/y coefficients at grid plane z
//   T1[a1, j2]  = sum_a2 t[a1, a2] F2f[a2, j2]                 (y forward)
//   S[j1, jj]   = V[k, z, j1, s0+jj] sum_a1 F1f[a1, j1] T1[a1, s0+jj]
//   T1[a1, s0+jj] = sum_j1 F1b[j1, a1] S[j1, jj]               (x forward,
//                                       *V, x backward, one strip of y)
//   out[a1, a2] = sum_j2 T1[a1, j2] F2b[j2, a2]                (y backward)
// with the input plane, T1 and the strip S in shared memory: device memory
// sees the plane in, the plane out and the V plane.
//
// Strip-mining: x-forward, *V and x-backward act on each y column j2
// independently, so the [n1, n2] real-space plane is processed in strips of
// `strip` columns that reuse one [n1, strip] buffer.  At the Si54 shapes
// (m = 32, n = 64, complex128) a full strip fits: 16 + 32 + 64 KB.  Larger
// grids take narrower strips; the wrapper picks the width and refuses a
// shape whose [m1, m2] + [m1, n2] planes alone exceed the 227 KB a block
// may use.
//
// Three instantiations: complex128, complex64, and bf16 -- complex64 data
// whose operands are rounded to bf16 before each of the four contractions
// (the plane and T1 as they are stored in shared memory, the potential-
// multiplied strip, each factor as it is read), with f32 accumulation and
// the V multiply in f32 on the f32 sums: the 'default' precision of
// fused_filter_mid (fused_filter.py:_dot_left, :106-113).
//
// What bounds it on an H100: ~3 MFLOP (f64) per plane against 32 KB of
// device traffic, so it is bound by shared-memory bandwidth and the f64
// FMA rate, not by device memory.  Each output element is one thread's dot
// product over one shared-memory operand (neighbouring threads on
// neighbouring addresses, the other operand a broadcast) and one factor
// read through __ldg.  No register blocking or tensor cores yet.
#include "dftk_complex.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, bool kBf16>
__global__ void __launch_bounds__(kThreads)
local_plane_kernel(const cplx<T>* __restrict__ t, const T* __restrict__ V,
                   const cplx<T>* __restrict__ F2f, const cplx<T>* __restrict__ F1f,
                   const cplx<T>* __restrict__ F1b, const cplx<T>* __restrict__ F2b,
                   cplx<T>* __restrict__ out, int nb, int n3, int m1, int m2,
                   int n1, int n2, int strip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* Xs = reinterpret_cast<cplx<T>*>(smem_raw);   // [m1, m2]
  cplx<T>* T1 = Xs + m1 * m2;                           // [m1, n2]
  cplx<T>* Sb = T1 + m1 * n2;                           // [n1, strip]

  const size_t q = blockIdx.x;                          // plane (k, band, z)
  const size_t k = q / (static_cast<size_t>(nb) * n3);
  const int z = static_cast<int>(q % n3);
  const cplx<T>* xin = t + q * m1 * m2;
  cplx<T>* xout = out + q * m1 * m2;
  const T* Vz = V + (k * n3 + z) * n1 * n2;

  for (int e = threadIdx.x; e < m1 * m2; e += blockDim.x)
    Xs[e] = operand<T, kBf16>(xin[e]);
  __syncthreads();

  // y forward: T1[a1, j2] = sum_a2 Xs[a1, a2] F2f[a2, j2]
  for (int e = threadIdx.x; e < m1 * n2; e += blockDim.x) {
    const int a1 = e / n2, j2 = e - a1 * n2;
    cplx<T> acc{0, 0};
    for (int a2 = 0; a2 < m2; ++a2)
      cfma(acc, Xs[a1 * m2 + a2], operand<T, kBf16>(ldg(F2f + a2 * n2 + j2)));
    T1[e] = operand<T, kBf16>(acc);
  }
  __syncthreads();

  for (int s0 = 0; s0 < n2; s0 += strip) {
    const int w = min(strip, n2 - s0);
    // x forward and the potential: Sb[j1, jj]
    for (int e = threadIdx.x; e < n1 * w; e += blockDim.x) {
      const int j1 = e / w, jj = e - j1 * w;
      cplx<T> acc{0, 0};
      for (int a1 = 0; a1 < m1; ++a1)
        cfma(acc, operand<T, kBf16>(ldg(F1f + a1 * n1 + j1)), T1[a1 * n2 + s0 + jj]);
      const T v = ldg(Vz + j1 * n2 + s0 + jj);
      Sb[j1 * strip + jj] = operand<T, kBf16>(cplx<T>{acc.re * v, acc.im * v});
    }
    __syncthreads();
    // x backward into the strip's columns of T1 (their forward is done)
    for (int e = threadIdx.x; e < m1 * w; e += blockDim.x) {
      const int a1 = e / w, jj = e - a1 * w;
      cplx<T> acc{0, 0};
      for (int j1 = 0; j1 < n1; ++j1)
        cfma(acc, operand<T, kBf16>(ldg(F1b + j1 * m1 + a1)), Sb[j1 * strip + jj]);
      T1[a1 * n2 + s0 + jj] = operand<T, kBf16>(acc);
    }
    __syncthreads();
  }

  // y backward: out[a1, a2] = sum_j2 T1[a1, j2] F2b[j2, a2]
  for (int e = threadIdx.x; e < m1 * m2; e += blockDim.x) {
    const int a1 = e / m2, a2 = e - a1 * m2;
    cplx<T> acc{0, 0};
    for (int j2 = 0; j2 < n2; ++j2)
      cfma(acc, T1[a1 * n2 + j2], operand<T, kBf16>(ldg(F2b + j2 * m2 + a2)));
    xout[e] = acc;
  }
}

template <typename T, bool kBf16>
int launch_local_plane(const void* t, const void* V, const void* F2f,
                       const void* F1f, const void* F1b, const void* F2b,
                       void* out, int nk, int nb, int n3, int m1, int m2,
                       int n1, int n2, int strip, void* stream) {
  const size_t smem = (static_cast<size_t>(m1) * m2 + static_cast<size_t>(m1) * n2
                       + static_cast<size_t>(n1) * strip) * sizeof(cplx<T>);
  cudaError_t err = allow_smem(local_plane_kernel<T, kBf16>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int planes = static_cast<unsigned int>(nk) * nb * n3;
  local_plane_kernel<T, kBf16><<<planes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const cplx<T>*>(t), static_cast<const T*>(V),
      static_cast<const cplx<T>*>(F2f), static_cast<const cplx<T>*>(F1f),
      static_cast<const cplx<T>*>(F1b), static_cast<const cplx<T>*>(F2b),
      static_cast<cplx<T>*>(out), nb, n3, m1, m2, n1, n2, strip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dftk_local_plane_c128(const void* t, const void* V, const void* F2f,
                          const void* F1f, const void* F1b, const void* F2b,
                          void* out, int nk, int nb, int n3, int m1, int m2,
                          int n1, int n2, int strip, void* stream) {
  return launch_local_plane<double, false>(t, V, F2f, F1f, F1b, F2b, out, nk, nb, n3,
                                    m1, m2, n1, n2, strip, stream);
}

int dftk_local_plane_c64(const void* t, const void* V, const void* F2f,
                         const void* F1f, const void* F1b, const void* F2b,
                         void* out, int nk, int nb, int n3, int m1, int m2,
                         int n1, int n2, int strip, void* stream) {
  return launch_local_plane<float, false>(t, V, F2f, F1f, F1b, F2b, out, nk, nb, n3,
                                   m1, m2, n1, n2, strip, stream);
}

int dftk_local_plane_bf16(const void* t, const void* V, const void* F2f,
                          const void* F1f, const void* F1b, const void* F2b,
                          void* out, int nk, int nb, int n3, int m1, int m2,
                          int n1, int n2, int strip, void* stream) {
  return launch_local_plane<float, true>(t, V, F2f, F1f, F1b, F2b, out, nk, nb, n3,
                                         m1, m2, n1, n2, strip, stream);
}

}  // extern "C"
