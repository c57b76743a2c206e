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
// whose operands (input and factor) are rounded to bf16, with f32
// accumulation: the TPU kernels' 'default' precision
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

// bf16 (axis_dft_bf16_kernel): the z-axis stages of fused_local_apply and
// the dot_z of fused_filter.py:139 at 'default' precision, on the bf16
// tensor cores, mma.sync m16n8k16 (HMMA) with f32 sums; the input rounded
// to bf16 once, as its fragments are built, the factor by the wrapper
// (round_bf16's rounding, packed in fragment order and kept per factor
// tensor); the output the f32 sum, not rounded.  ptxas: 96-128 registers;
// the forward instantiation with TJ = 64 spills 8 bytes, the others none.
//   What bounds it on an H100: at Si54 (B = 128, P = 32^2, K, J = 32, 64)
//   it moves 100 MB of complex64 for 2.1 GFLOP: bound by bytes, 0.030 ms
//   (0.002 by operations at 989 TFLOP/s); at Si256 forward (B = 256, P =
//   64^2, K = 32, J = 64) 805 MB, 0.240 ms.  So the memory path is the
//   design: bytes in flight per SM and full-sector stores.
//   * Each block owns one batch, a tile of TJ output columns (32 or 64) and
//     two row tiles of 128 rows, and walks them in stages of one K chunk of
//     32: the complex64 input streams through two shared buffers with
//     16-byte cp.async (8-byte where rows start on odd values; zero-filled
//     past P and K), 32 KB a stage, two blocks an SM: ~64 KB in flight per
//     SM while the other buffer feeds the tensor cores.
//   * Forward computes out^T = F^T in^T: F^T is the A operand (packed A
//     fragments read from L1/L2), the input tile [p][c] the B operand, read
//     as 16-byte pairs of complex values and rounded in registers (each
//     value read once a block); backward computes out = in^T F with the
//     input tile [c][p] as A and F as packed B fragments.  A warp owns 16
//     rows: forward 2 column tiles of 8 p and all TJ / 16 row tiles of j,
//     backward one row tile of 16 p and all TJ / 8 column tiles of j.
//   * Each lane's tile pair is stored as one 16-byte (re, im, re, im) store:
//     runs of eight p per j forward, of eight j per p backward, whole 32-byte
//     sectors.
//   * Rows are padded (KC + 8 and TP + 2 complex) so that the fragment
//     reads of a quarter or half warp fall on distinct banks.

// complex64 (axis_dft_kernel, the first design, which now serves
// complex64 only): each block stages a tile of TP rows of its input in
// shared memory with coalesced loads, so global reads are read once; the
// forward tile's row stride is padded to K+1 so that threads of a warp
// reading neighbouring rows hit different banks; outputs are written with
// neighbouring threads on neighbouring addresses.  Factors are read
// through __ldg (a few KB, resident in L1).  One thread per output
// element; no tensor cores.
#include "dftk_complex.cuh"

namespace {

constexpr int kTileRows = 32;   // _AXIS_TILE_ROWS of kernels/local_apply.py
constexpr int kThreads = 256;

template <typename T, bool kForward>
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
      tile[p * (K + 1) + c] = src[e];
    }
  } else {
    const cplx<T>* src = in + b * K * P + p0;
    for (int e = threadIdx.x; e < tp * K; e += blockDim.x) {
      const int c = e / tp, p = e - c * tp;
      tile[c * kTileRows + p] = src[static_cast<size_t>(c) * P + p];
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
        cfma(acc, row[c], ldg(F + c * J + j));
      dst[static_cast<size_t>(j) * P + p] = acc;
    }
  } else {
    cplx<T>* dst = out + (b * P + p0) * J;
    for (int e = threadIdx.x; e < tp * J; e += blockDim.x) {
      const int p = e / J, j = e - p * J;
      cplx<T> acc{0, 0};
      for (int c = 0; c < K; ++c)
        cfma(acc, tile[c * kTileRows + p], ldg(F + c * J + j));
      dst[e] = acc;
    }
  }
}

template <typename T>
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
    err = allow_smem(axis_dft_kernel<T, true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    axis_dft_kernel<T, true><<<grid, kThreads, smem, s>>>(x, f, y, P, K, J);
  } else {
    const size_t smem = static_cast<size_t>(kTileRows) * K * sizeof(cplx<T>);
    err = allow_smem(axis_dft_kernel<T, false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    axis_dft_kernel<T, false><<<grid, kThreads, smem, s>>>(x, f, y, P, K, J);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- complex128 -----------------------------------------------------------

constexpr int kC128Threads = 256;
constexpr int kRowTiles = 4;      // row tiles per block
constexpr int kChunkElems = 2048; // TP * KC: complex values per input buffer
constexpr size_t kSmemMax = 232448; // the most dynamic shared memory a block may use

// asynchronous copies global -> shared of 16 (.cg) or 8 bytes (.ca: .cg
// takes 16 only); src_bytes below the size fills the rest with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
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

// ---- bf16 -----------------------------------------------------------------

constexpr int kBf16TP = 128;      // rows of a tile: 8 warps x 16
constexpr int kBf16KC = 32;       // K chunk of a stage: two k-steps of 16
constexpr int kBf16RowTiles = 2;  // row tiles per block

template <bool kForward>
struct AxisBf16 {
  // pitches in complex values: forward [TP][KC + 8] (a B fragment's 16-byte
  // reads of rows gr, gr + 1 hit distinct banks), backward [KC][TP + 2] (an
  // A fragment's 8-byte reads of rows 2 tg, columns gr likewise)
  static constexpr int AP = kForward ? kBf16KC + 8 : kBf16TP + 2;
  static constexpr int BUF = kForward ? kBf16TP * AP : kBf16KC * AP;
  static constexpr size_t kSmem = 2 * BUF * sizeof(float2);
};

// Fp: F rounded to bf16 in fragment order (kernels/local_apply.py): forward
// F^T as A fragments [ceil(J/16)][ceil(K/16)][re, im][32 lanes], backward F
// as B fragments [ceil(J/8)][ceil(K/16)][32 lanes], of uint4.
// in_pairs: 16-byte input copies (rows start on even values, aligned);
// out_pairs: 16-byte output stores.
template <int TJ, bool kForward>
__global__ void __launch_bounds__(256, 2)
axis_dft_bf16_kernel(const float2* __restrict__ in, const uint4* __restrict__ Fp,
                     float2* __restrict__ out, int P, int K, int J, bool in_pairs,
                     bool out_pairs) {
  using C = AxisBf16<kForward>;
  constexpr int TP = kBf16TP, KC = kBf16KC, AP = C::AP;
  constexpr int MT = kForward ? TJ / 16 : 1;   // row tiles of 16 a warp holds
  constexpr int NT = kForward ? 2 : TJ / 8;    // column tiles of 8
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* buf[2] = {reinterpret_cast<float2*>(smem_raw),
                    reinterpret_cast<float2*>(smem_raw) + C::BUF};

  const size_t b = blockIdx.z;
  const int j0 = blockIdx.y * TJ;
  const int tile0 = blockIdx.x * kBf16RowTiles;
  const int ntiles = min(kBf16RowTiles, (P + TP - 1) / TP - tile0);
  const int nkc = (K + KC - 1) / KC, Kt = (K + 15) / 16;
  const int Jt = kForward ? (J + 15) / 16 : (J + 7) / 8;   // fragment tiles of F
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;

  // stage s = (row tile s / nkc, K chunk s % nkc) into buffer s & 1, two
  // neighbours along the contiguous axis (c forward, p backward) a copy
  auto load = [&](int s) {
    const int p0 = (tile0 + s / nkc) * TP, c0 = (s % nkc) * KC;
    float2* dst = buf[s & 1];
    for (int e = tid; e < TP * KC / 2; e += 256) {
      int p, c, nv;
      const float2* src;
      if (kForward) {
        p = e / (KC / 2);
        c = 2 * (e - p * (KC / 2));
        nv = p0 + p < P ? min(2, max(0, K - c0 - c)) : 0;
        src = in + (b * P + p0 + p) * K + c0 + c;
      } else {
        c = e / (TP / 2);
        p = 2 * (e - c * (TP / 2));
        nv = c0 + c < K ? min(2, max(0, P - p0 - p)) : 0;
        src = in + (b * K + c0 + c) * P + p0 + p;
      }
      float2* d = dst + (kForward ? p * AP + c : c * AP + p);
      if (in_pairs) {
        cp_async16(d, nv > 0 ? src : in, 8 * nv);
      } else {
        cp_async8(d, nv > 0 ? src : in, nv > 0 ? 8 : 0);
        cp_async8(d + 1, nv > 1 ? src + 1 : in, nv > 1 ? 8 : 0);
      }
    }
  };

  float acc[MT][NT][2][4] = {};
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
    const float2* A = buf[s & 1];
    const int ks0 = (s % nkc) * (KC / 16);
    #pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      const int ks = ks0 + kk;
      if (ks >= Kt) break;
      if (kForward) {
        // B: the input, column p = 16 warp + 8 n + gr, k = 16 kk + 2 tg (+1, +8, +9)
        uint4 bf[NT];
        #pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2* r = A + (16 * warp + 8 * n + gr) * AP + 16 * kk + 2 * tg;
          const float4 lo = *reinterpret_cast<const float4*>(r);
          const float4 hi = *reinterpret_cast<const float4*>(r + 8);
          bf[n] = make_uint4(pack_bf16(lo.x, lo.z), pack_bf16(hi.x, hi.z),
                             pack_bf16(lo.y, lo.w), pack_bf16(hi.y, hi.w));
        }
        #pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int mt = j0 / 16 + m;
          CFragA a;
          uint4 r = make_uint4(0u, 0u, 0u, 0u), i = r;
          if (mt < Jt) {
            const uint4* f = Fp + static_cast<size_t>((mt * Kt + ks) * 2) * 32 + lane;
            r = __ldg(f);
            i = __ldg(f + 32);
          }
          a.re[0] = r.x; a.re[1] = r.y; a.re[2] = r.z; a.re[3] = r.w;
          a.im[0] = i.x; a.im[1] = i.y; a.im[2] = i.z; a.im[3] = i.w;
          a.negate();
          #pragma unroll
          for (int n = 0; n < NT; ++n) chmma(acc[m][n], a, bf[n]);
        }
      } else {
        // A: the input transposed, row p = 16 warp + gr (+8), k = 16 kk + 2 tg (+1, +8, +9)
        const float2* r = A + (16 * kk + 2 * tg) * AP + 16 * warp + gr;
        CFragA a;
        #pragma unroll
        for (int q = 0; q < 4; ++q) {        // a_q: rows +8 (q odd), k +8 (q >= 2)
          const float2* e = r + 8 * (q >> 1) * AP + 8 * (q & 1);
          const float2 v0 = e[0], v1 = e[AP];
          a.re[q] = pack_bf16(v0.x, v1.x);
          a.im[q] = pack_bf16(v0.y, v1.y);
        }
        a.negate();
        #pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int nt = j0 / 8 + n;
          const uint4 f = nt < Jt ? __ldg(Fp + static_cast<size_t>(nt * Kt + ks) * 32 + lane)
                                  : make_uint4(0u, 0u, 0u, 0u);
          chmma(acc[0][n], a, f);
        }
      }
    }
    if (s % nkc == nkc - 1) {        // the row tile is complete: store it
      const int p0 = (tile0 + s / nkc) * TP;
      #pragma unroll
      for (int m = 0; m < MT; ++m)
        #pragma unroll
        for (int n = 0; n < NT; ++n)
          #pragma unroll
          for (int h = 0; h < 2; ++h) {
            // forward: row j, columns p, p + 1; backward: row p, columns j, j + 1
            const int row = kForward ? j0 + 16 * m + gr + 8 * h : p0 + 16 * warp + gr + 8 * h;
            const int col = kForward ? p0 + 16 * warp + 8 * n + 2 * tg : j0 + 8 * n + 2 * tg;
            const int nrow = kForward ? J : P, ncol = kForward ? P : J;
            if (row < nrow && col < ncol) {
              float2* o = out + (b * nrow + row) * ncol + col;
              const float2 v0 = make_float2(acc[m][n][0][2 * h], acc[m][n][1][2 * h]);
              const float2 v1 = make_float2(acc[m][n][0][2 * h + 1], acc[m][n][1][2 * h + 1]);
              if (out_pairs) {
                *reinterpret_cast<float4*>(o) = make_float4(v0.x, v0.y, v1.x, v1.y);
              } else {
                o[0] = v0;
                if (col + 1 < ncol) o[1] = v1;
              }
            }
            #pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e >> 1][(e & 1) + 2 * h] = 0.f;
          }
    }
    __syncthreads();                 // buffer s & 1 is refilled at stage s + 2
  }
}

template <int TJ, bool kForward>
cudaError_t launch_axis_dft_bf16_as(const float2* x, const uint4* f, float2* y, int B, int P,
                                    int K, int J, cudaStream_t s) {
  constexpr size_t smem = AxisBf16<kForward>::kSmem;
  cudaError_t err = allow_smem(axis_dft_bf16_kernel<TJ, kForward>, smem);
  if (err != cudaSuccess) return err;
  const bool in_pairs = (kForward ? K : P) % 2 == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  const bool out_pairs = (kForward ? P : J) % 2 == 0 && reinterpret_cast<size_t>(y) % 16 == 0;
  const int tiles = (P + kBf16TP - 1) / kBf16TP;
  const dim3 grid((tiles + kBf16RowTiles - 1) / kBf16RowTiles, (J + TJ - 1) / TJ, B);
  axis_dft_bf16_kernel<TJ, kForward><<<grid, 256, smem, s>>>(x, f, y, P, K, J, in_pairs,
                                                             out_pairs);
  return cudaGetLastError();
}

int launch_axis_dft_bf16(const void* in, const void* Fp, void* out, int B, int P, int K,
                         int J, int forward, void* stream) {
  const auto* x = static_cast<const float2*>(in);
  const auto* f = static_cast<const uint4*>(Fp);
  auto* y = static_cast<float2*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (J <= 32)
    err = forward ? launch_axis_dft_bf16_as<32, true>(x, f, y, B, P, K, J, s)
                  : launch_axis_dft_bf16_as<32, false>(x, f, y, B, P, K, J, s);
  else
    err = forward ? launch_axis_dft_bf16_as<64, true>(x, f, y, B, P, K, J, s)
                  : launch_axis_dft_bf16_as<64, false>(x, f, y, B, P, K, J, s);
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
  return launch_axis_dft<float>(in, F, out, B, P, K, J, forward, stream);
}

// Fp: F rounded to bf16 and packed in fragment order
// (kernels/local_apply.py::bf16_axis_pack)
int dftk_axis_dft_bf16(const void* in, const void* Fp, void* out, int B, int P,
                       int K, int J, int forward, void* stream) {
  return launch_axis_dft_bf16(in, Fp, out, B, P, K, J, forward, stream);
}

}  // extern "C"
