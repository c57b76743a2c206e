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
// K, J = 32 and 64) it moves ~200 MB (complex128) for ~2 GFLOP, ~10 flops
// per byte: at the f64 ridge, bound by device memory bandwidth (0.060 ms).
//
// complex128 (axis_dft_c128_kernel): a per-batch GEMM [P, K] x [K, J] with
// the output stored transposed (forward) or the input read transposed
// (backward).  Each block owns one batch, a tile of TJ output columns and
// kRowTiles row tiles of TP rows, and walks them in stages of one K chunk:
//   * F[:, j0:j0+TJ] is staged in shared memory per K chunk, zero-padded.
//     Where all of its chunks fit a block (34 KB at the Si54 and Si256
//     shapes) they stay resident, loaded once at the first row tile; else
//     two chunk buffers stream with the input, so no K is too tall;
//   * the input streams through two shared buffers of TP x KC complex
//     values (KC = 2048 / TP), each filled with cp.async while the other
//     feeds the arithmetic (zero-filled past P and K);
//   * each warp owns 32 x 16 outputs (4 x 2 tiles of 8 x 8) in registers and
//     runs them on the f64 tensor cores (mma.sync m8n8k4, four real MMAs a
//     complex k-step): one fragment load feeds two or four tiles.  Rows are
//     padded so a fragment's lanes fall on distinct banks;
//   * the output is written with 16-byte stores, runs of eight p per j
//     forward, of pairs of j per p backward.
// Column tiles are 64 wide (TP = 64, KC = 32) or, for J <= 32, 32 wide
// (TP = 128, KC = 16), so that the backward J = m3 = 32 leaves no warp idle.
// Two blocks of 256 threads share an SM (~105 KB of shared memory each) at
// the Si54 and Si256 shapes.

// complex64 and bf16 (axis_dft_kernel, the first design): each block stages
// a tile of TP rows of its input in shared memory with coalesced loads, so
// global reads are read once; the forward tile's row stride is padded to
// K+1 so that threads of a warp reading neighbouring rows hit different
// banks; outputs are written with neighbouring threads on neighbouring
// addresses.  Factors are read through __ldg (a few KB, resident in L1).
// One thread per output element; no tensor cores.  The bf16 mode rounds
// each input once, as it enters shared memory, and each factor as it is
// read.
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

// ---- complex128 -----------------------------------------------------------

constexpr int kC128Threads = 256;
constexpr int kRowTiles = 4;      // row tiles per block
constexpr int kChunkElems = 2048; // TP * KC: complex values per input buffer
constexpr size_t kSmemMax = 232448; // the most dynamic shared memory a block may use

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Block tile TP x TJ of one batch: TJ = 64 (TP = 64, warps 2 x 4) or, for
// J <= 32, TJ = 32 (TP = 128, warps 4 x 2); each warp owns 32 rows x 16
// columns, 4 x 2 tiles of 8 x 8.
template <int TJ, bool kForward>
struct AxisC128 {
  static constexpr int TP = 4096 / TJ;
  static constexpr int KC = kChunkElems / TP;      // K chunk per buffer
  static constexpr int WC = TJ / 16;               // warps along j
  // pitches in complex values: a fragment's 8 lanes of one 16-byte phase
  // (rows gr = 0, 1 x columns tg = 0..3) fall on distinct bank groups
  static constexpr int FP = TJ + 2;                // F   [KC][FP] a chunk
  static constexpr int AP = kForward ? KC + 4 : TP + 2;  // forward [TP][AP], backward [KC][AP]
  static constexpr int BUF = kForward ? TP * AP : KC * AP;
  static constexpr int FCH = KC * FP;              // one K chunk of F
  static size_t smem(int fchunks) {
    return (static_cast<size_t>(fchunks) * FCH + 2 * BUF) * sizeof(double2);
  }
  // chunks of F held at once: all of them where they fit a block, else two
  static int f_chunks(int K) {
    const int nkc = (K + KC - 1) / KC;
    return smem(nkc) <= kSmemMax ? nkc : 2;
  }
};

template <int TJ, bool kForward>
__global__ void __launch_bounds__(kC128Threads, 2)
axis_dft_c128_kernel(const double2* __restrict__ in, const double2* __restrict__ F,
                     double2* __restrict__ out, int P, int K, int J, int fchunks) {
  using C = AxisC128<TJ, kForward>;
  constexpr int TP = C::TP, KC = C::KC, FP = C::FP, AP = C::AP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nkc = (K + KC - 1) / KC;
  // F chunk c sits in slot c when all chunks are resident, else in slot s & 1
  // of stage s, refilled with the input
  const bool resident = fchunks == nkc;
  double2* Fs = reinterpret_cast<double2*>(smem_raw);      // [fchunks][KC][FP]
  double2* buf[2] = {Fs + fchunks * C::FCH, Fs + fchunks * C::FCH + C::BUF};

  const size_t b = blockIdx.z;
  const int j0 = blockIdx.y * TJ;
  const int tile0 = blockIdx.x * kRowTiles;
  const int ntiles = min(kRowTiles, (P + TP - 1) / TP - tile0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;
  const int wr = warp / C::WC, wc = warp % C::WC;    // the warp's 32 x 16 tile

  // stage s = (row tile s / nkc, K chunk s % nkc): the input chunk into
  // buffer s & 1 and, unless resident and loaded, F[c0:c0+KC, j0:j0+TJ]
  // (zero past K and J) into its slot
  auto load = [&](int s) {
    const int p0 = (tile0 + s / nkc) * TP, c0 = (s % nkc) * KC;
    if (!resident || s < nkc) {
      double2* fdst = Fs + (resident ? s : s & 1) * C::FCH;
      for (int e = tid; e < KC * TJ; e += kC128Threads) {
        const int c = e / TJ, jj = e - c * TJ;
        const bool ok = c0 + c < K && j0 + jj < J;
        cp_async16(fdst + c * FP + jj, ok ? F + static_cast<size_t>(c0 + c) * J + j0 + jj : F,
                   ok ? 16 : 0);
      }
    }
    double2* dst = buf[s & 1];
    for (int e = tid; e < TP * KC; e += kC128Threads) {
      int p, c;
      if (kForward) { p = e / KC; c = e - p * KC; }
      else          { c = e / TP; p = e - c * TP; }
      const bool ok = p0 + p < P && c0 + c < K;
      const double2* src = kForward
          ? in + (b * P + p0 + p) * K + c0 + c
          : in + (b * K + c0 + c) * P + p0 + p;
      cp_async16(dst + (kForward ? p * AP + c : c * AP + p), ok ? src : in, ok ? 16 : 0);
    }
  };

  double acc[4][2][2][2] = {};       // [row tile][column tile][re, im][lane's pair]
  const int nstages = ntiles * nkc;
  load(0);
  cp_async_commit();
  for (int s = 0; s < nstages; ++s) {
    if (s + 1 < nstages) {
      load(s + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const double2* A = buf[s & 1];
    const double2* Fk = Fs + (resident ? s % nkc : s & 1) * C::FCH;
    #pragma unroll 1                 // unrolled, the k-steps spill registers
    for (int k0 = 0; k0 < KC; k0 += 4) {
      double2 a[4], f[2];
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = 32 * wr + 8 * i + gr, c = k0 + tg;
        a[i] = A[kForward ? p * AP + c : c * AP + p];
      }
      #pragma unroll
      for (int j = 0; j < 2; ++j) f[j] = Fk[(k0 + tg) * FP + 16 * wc + 8 * j + gr];
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 2; ++j) cmma(acc[i][j], a[i], f[j].x, f[j].y);
    }
    if (s % nkc == nkc - 1) {        // the row tile is complete: store it
      const int p0 = (tile0 + s / nkc) * TP;
      #pragma unroll
      for (int i = 0; i < 4; ++i)
        #pragma unroll
        for (int j = 0; j < 2; ++j)
          #pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = p0 + 32 * wr + 8 * i + gr;
            const int jj = j0 + 16 * wc + 8 * j + 2 * tg + e;
            if (p < P && jj < J) {
              double2* dst = kForward ? out + (b * J + jj) * P + p : out + (b * P + p) * J + jj;
              *dst = make_double2(acc[i][j][0][e], acc[i][j][1][e]);
            }
            acc[i][j][0][e] = acc[i][j][1][e] = 0.0;
          }
    }
    __syncthreads();                 // buffer s & 1 is refilled at stage s + 2
  }
}

template <int TJ, bool kForward>
cudaError_t launch_axis_dft_c128_as(const double2* x, const double2* f, double2* y, int B,
                                    int P, int K, int J, cudaStream_t s) {
  using C = AxisC128<TJ, kForward>;
  const int fchunks = C::f_chunks(K);
  const size_t smem = C::smem(fchunks);
  cudaError_t err = allow_smem(axis_dft_c128_kernel<TJ, kForward>, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (P + C::TP - 1) / C::TP;
  const dim3 grid((tiles + kRowTiles - 1) / kRowTiles, (J + TJ - 1) / TJ, B);
  axis_dft_c128_kernel<TJ, kForward><<<grid, kC128Threads, smem, s>>>(x, f, y, P, K, J,
                                                                      fchunks);
  return cudaGetLastError();
}

int launch_axis_dft_c128(const void* in, const void* F, void* out, int B, int P, int K,
                         int J, int forward, void* stream) {
  const auto* x = static_cast<const double2*>(in);
  const auto* f = static_cast<const double2*>(F);
  auto* y = static_cast<double2*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (J <= 32)
    err = forward ? launch_axis_dft_c128_as<32, true>(x, f, y, B, P, K, J, s)
                  : launch_axis_dft_c128_as<32, false>(x, f, y, B, P, K, J, s);
  else
    err = forward ? launch_axis_dft_c128_as<64, true>(x, f, y, B, P, K, J, s)
                  : launch_axis_dft_c128_as<64, false>(x, f, y, B, P, K, J, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

int dftk_axis_dft_c128(const void* in, const void* F, void* out, int B, int P,
                       int K, int J, int forward, void* stream) {
  return launch_axis_dft_c128(in, F, out, B, P, K, J, forward, stream);
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
