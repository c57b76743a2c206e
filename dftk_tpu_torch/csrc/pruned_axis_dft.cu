// Kernel A: the pruned complex DFT along the z axis of a batch of compact
// cubes, with a layout change.
//
// Replaces the z-axis stages of the TPU kernel
//   dftk_tpu/kernels/fused_local.py::fused_local_apply (body _make_kernel,
//   the first and last `cmul` with the m3/n3 block factors)
// and the XLA-side `dot_z` GEMMs around
//   dftk_tpu/kernels/fused_filter.py::fused_filter_mid.
//
//   forward : in [B, P, K] (P = m1*m2 rows of K = m3) -> out [B, J, P] (J = n3)
//             out[b, j, p] = sum_c in[b, p, c] F[c, j]
//   backward: in [B, K, P] (K = n3)                   -> out [B, P, J] (J = m3)
//             out[b, p, j] = sum_c in[b, c, p] F[c, j]
//
// The forward output puts one contiguous [m1, m2] plane per (k, band, z):
// the layout kernel B (local_plane.cu) reads and writes.
//
// Three instantiations: complex128, complex64, and bf16 -- complex64 data
// whose operands (input and factor) are rounded to bf16 before each
// product, with f32 accumulation: the TPU kernels' 'default' precision
// (fused_filter.py::_dot_left, dot_z), used by the Chebyshev filter.
//
// What bounds it on an H100: at the Si54 shapes (B = 128 bands, P = 32^2,
// K, J = 32 and 64) it moves ~200 MB (complex128) for ~1 GFLOP, so device
// memory bandwidth, and the strided access of a row-per-thread contraction,
// bound it.  Design: each block stages a tile of TP rows of its input in
// shared memory with coalesced loads, so global reads are read once; the
// forward tile's row stride is padded to K+1 so that threads of a warp
// reading neighbouring rows hit different banks; outputs are written with
// neighbouring threads on neighbouring addresses.  Factors are read through
// __ldg (a few KB, resident in L1).  One thread per output element; no
// tensor cores yet.  The bf16 mode rounds each input once, as it enters
// shared memory, and each factor as it is read.
#include "dftk_complex.cuh"

namespace {

constexpr int kTileRows = 32;   // _AXIS_TILE_ROWS of kernels/local_apply.py
constexpr int kThreads = 256;

template <typename T, bool kForward, bool kBf16>
__global__ void __launch_bounds__(kThreads)
axis_dft_kernel(const cplx<T>* __restrict__ in, const cplx<T>* __restrict__ F,
                cplx<T>* __restrict__ out, int P, int K, int J) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* tile = reinterpret_cast<cplx<T>*>(smem_raw);

  const size_t b = blockIdx.y;
  const int p0 = blockIdx.x * kTileRows;
  const int tp = min(kTileRows, P - p0);

  if (kForward) {
    // rows p0 .. p0+tp of in[b] are one contiguous block of tp*K values
    const cplx<T>* src = in + (b * P + p0) * K;
    for (int e = threadIdx.x; e < tp * K; e += blockDim.x) {
      const int p = e / K, c = e - p * K;
      tile[p * (K + 1) + c] = operand<T, kBf16>(src[e]);
    }
  } else {
    const cplx<T>* src = in + b * K * P + p0;
    for (int e = threadIdx.x; e < tp * K; e += blockDim.x) {
      const int c = e / tp, p = e - c * tp;
      tile[c * kTileRows + p] = operand<T, kBf16>(src[static_cast<size_t>(c) * P + p]);
    }
  }
  __syncthreads();

  if (kForward) {
    cplx<T>* dst = out + b * J * P + p0;
    for (int e = threadIdx.x; e < J * tp; e += blockDim.x) {
      const int j = e / tp, p = e - j * tp;
      cplx<T> acc{0, 0};
      const cplx<T>* row = tile + p * (K + 1);
      for (int c = 0; c < K; ++c)
        cfma(acc, row[c], operand<T, kBf16>(ldg(F + c * J + j)));
      dst[static_cast<size_t>(j) * P + p] = acc;
    }
  } else {
    cplx<T>* dst = out + (b * P + p0) * J;
    for (int e = threadIdx.x; e < tp * J; e += blockDim.x) {
      const int p = e / J, j = e - p * J;
      cplx<T> acc{0, 0};
      for (int c = 0; c < K; ++c)
        cfma(acc, tile[c * kTileRows + p], operand<T, kBf16>(ldg(F + c * J + j)));
      dst[e] = acc;
    }
  }
}

template <typename T, bool kBf16>
int launch_axis_dft(const void* in, const void* F, void* out, int B, int P,
                    int K, int J, int forward, void* stream) {
  const dim3 grid((P + kTileRows - 1) / kTileRows, B);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* x = static_cast<const cplx<T>*>(in);
  const auto* f = static_cast<const cplx<T>*>(F);
  auto* y = static_cast<cplx<T>*>(out);
  cudaError_t err;
  if (forward) {
    const size_t smem = static_cast<size_t>(kTileRows) * (K + 1) * sizeof(cplx<T>);
    err = allow_smem(axis_dft_kernel<T, true, kBf16>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    axis_dft_kernel<T, true, kBf16><<<grid, kThreads, smem, s>>>(x, f, y, P, K, J);
  } else {
    const size_t smem = static_cast<size_t>(kTileRows) * K * sizeof(cplx<T>);
    err = allow_smem(axis_dft_kernel<T, false, kBf16>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    axis_dft_kernel<T, false, kBf16><<<grid, kThreads, smem, s>>>(x, f, y, P, K, J);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dftk_axis_dft_c128(const void* in, const void* F, void* out, int B, int P,
                       int K, int J, int forward, void* stream) {
  return launch_axis_dft<double, false>(in, F, out, B, P, K, J, forward, stream);
}

int dftk_axis_dft_c64(const void* in, const void* F, void* out, int B, int P,
                      int K, int J, int forward, void* stream) {
  return launch_axis_dft<float, false>(in, F, out, B, P, K, J, forward, stream);
}

int dftk_axis_dft_bf16(const void* in, const void* F, void* out, int B, int P,
                       int K, int J, int forward, void* stream) {
  return launch_axis_dft<float, true>(in, F, out, B, P, K, J, forward, stream);
}

}  // extern "C"
