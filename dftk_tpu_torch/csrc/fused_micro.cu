// The band-major fully fused three-axis chain and its swap-only ablation.
//
// Replaces the TPU probe kernels of tools/bench_fused_micro.py:
//   kernel_full      -> micro_full_kernel
//   kernel_swaponly  -> micro_swaponly_kernel
//
// Layout (f32): xr, xi [K, NB, M, M, M] (one [M, M, M] cube per band);
// V [K, N, N, N]; F [2M, 2N]; G [2N, 2M].  Band g = k NB + t uses V[k].
// Every contraction is the JAX body's `cmul`: the last axis of (re, im)
// concatenated, [rows, 2K] @ W [2K, 2N'], the result split into re (columns
// < N') and im.  W is a general real map, not a complex matrix in 2x2 blocks.
//
// micro_full, per band, with the JAX body's swaps between the contractions
// (the stored axis order after each stage is the one the next contracts last):
//   1. x [a, b, c]    @F over c -> [a, b, j], stored [a, j, b]   (s23)
//   2. [a, j, b]      @F over b -> [a, j, k], stored [j, k, a]   (s12, s23)
//   3. [j, k, a]      @F over a -> [j, k, l], times V[j, k, l]
//   4. [j, k, l]      @G over l -> [j, k, A], stored [A, j, k]   (s23, s12)
//   5. [A, j, k]      @G over k -> [A, j, B], stored [A, B, j]   (s23)
//   6. [A, B, j]      @G over j -> [A, B, C], the output band
// micro_swaponly, per band and per part (re, im) on their own:
//   big [M, M, N] = x[a, b, 0] broadcast; 3 x (s23, s12, s23, s12), each
//   a data movement between two buffers (s23 a tiled transpose of every
//   [d1, d2] slab through shared memory, s12 a copy of whole rows to their
//   swapped place); out = big[:M, :M, :M] + x.
//
// Design.  A TPU grid step holds one band (256 KB in, up to 2 MB of
// intermediate at M = 32, N = 64) in VMEM; a block here has at most 227 KB
// of shared memory, so no block can hold a band.  Each block loops over
// bands (a persistent grid the wrapper sizes) and streams the band's stages
// through its own scratch in device memory (two ping-pong buffers, re and
// im), __syncthreads() between stages.  A contraction runs on tiles of RT
// rows: the tile [RT, 2K] and W [2K, 2N'] sit in shared memory, each thread
// owns one output column and kRows rows of the tile (RT = kRows * threads /
// 2N'), and sums in f32 FMAs outside the tensor cores: per k one W load
// (consecutive threads, consecutive columns) and kRows broadcast tile loads.
// The swap-only kernel moves bytes only.
//
// What bounds it on an H100: micro_full is 235.4 MFLOP per band (60.3 GFLOP
// per apply of 256 bands) against 134 MB of traffic in and out: bound by
// operations (0.90 ms at 67 TFLOP/s).  micro_swaponly does no arithmetic to
// speak of: bound by bytes (0.040 ms), while its 12 swaps move 24 times a
// [M, M, N] buffer per band part through the scratch (L2 and device memory).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;              // rows of each thread's output column per tile
constexpr int kTile = 32;              // transpose tile of the swaps

// The geometry of one contraction stage: input rows r = a0 * d1 + a1 of
// [xr | xi], each K long; output (a0, a1, n) for n < Nout, re to yr and im
// to yi at a0 * s0 + a1 * s1 + n * s2.  Vb, if not null: multiply by
// Vb[r * Nout + n] before the store.
struct Stage {
  const float* xr; const float* xi; const float* W;
  float* yr; float* yi; const float* Vb;
  int d0, d1, K, Nout, s0, s1, s2;
};

// Loads W [2K, 2Nout] into Ws, then runs the stage tile by tile.
__device__ void contract(const Stage& s, float* Ws, float* Xs) {
  const int K2 = 2 * s.K, NC = 2 * s.Nout, R = s.d0 * s.d1;
  const int groups = kThreads / NC, RT = kRows * groups;
  const int col = threadIdx.x % NC, grp = threadIdx.x / NC;
  const int n = col < s.Nout ? col : col - s.Nout;
  float* y = col < s.Nout ? s.yr : s.yi;
  for (int e = threadIdx.x; e < K2 * NC; e += kThreads) Ws[e] = __ldg(s.W + e);
  for (int r0 = 0; r0 < R; r0 += RT) {
    __syncthreads();   // Ws written (first tile), Xs read (previous tile)
    for (int e = threadIdx.x; e < RT * K2; e += kThreads) {
      const int rr = e / K2, k = e - rr * K2, r = r0 + rr;
      if (r < R)
        Xs[e] = k < s.K ? s.xr[static_cast<size_t>(r) * s.K + k]
                        : s.xi[static_cast<size_t>(r) * s.K + k - s.K];
    }
    __syncthreads();
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
    for (int k = 0; k < K2; ++k) {
      const float w = Ws[k * NC + col];
#pragma unroll
      for (int i = 0; i < kRows; ++i) acc[i] = fmaf(Xs[(grp + i * groups) * K2 + k], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = r0 + grp + i * groups;
      if (r < R) {
        float v = acc[i];
        if (s.Vb != nullptr) v *= __ldg(s.Vb + static_cast<size_t>(r) * s.Nout + n);
        const int a0 = r / s.d1, a1 = r - a0 * s.d1;
        y[static_cast<size_t>(a0) * s.s0 + static_cast<size_t>(a1) * s.s1
          + static_cast<size_t>(n) * s.s2] = v;
      }
    }
  }
  __syncthreads();     // the stage's output is complete before the next reads it
}

// scratch per block: P (re, im) of `ping` floats each, then Q of `pong`.
__global__ void __launch_bounds__(kThreads)
micro_full_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                  const float* __restrict__ V, const float* __restrict__ F,
                  const float* __restrict__ G, float* __restrict__ outr,
                  float* __restrict__ outi, float* __restrict__ scratch, const int bands,
                  const int nb, const int M, const int N, const size_t ping,
                  const size_t pong) {
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;
  float* Xs = smem + 4 * M * N;
  float* Pr = scratch + blockIdx.x * 2 * (ping + pong);
  float* Pi = Pr + ping;
  float* Qr = Pi + ping;
  float* Qi = Qr + pong;
  const size_t cube = static_cast<size_t>(M) * M * M;
  for (int g = blockIdx.x; g < bands; g += gridDim.x) {
    const float* Vb = V + static_cast<size_t>(g / nb) * N * N * N;
    const float *ar = xr + g * cube, *ai = xi + g * cube;
    float *orr = outr + g * cube, *oi = outi + g * cube;
    // d0, d1, K, Nout, s0, s1, s2 of each stage (module comment)
    contract({ar, ai, F, Pr, Pi, nullptr, M, M, M, N, N * M, 1, M}, Ws, Xs);
    contract({Pr, Pi, F, Qr, Qi, nullptr, M, N, M, N, 1, N * M, M}, Ws, Xs);
    contract({Qr, Qi, F, Pr, Pi, Vb, N, N, M, N, N * N, N, 1}, Ws, Xs);
    contract({Pr, Pi, G, Qr, Qi, nullptr, N, N, N, M, N, 1, N * N}, Ws, Xs);
    contract({Qr, Qi, G, Pr, Pi, nullptr, M, N, N, M, M * N, 1, N}, Ws, Xs);
    contract({Pr, Pi, G, orr, oi, nullptr, M, M, N, M, M * M, M, 1}, Ws, Xs);
  }
}

// s23: [d0, d1, d2] -> [d0, d2, d1], kTile x kTile tiles through shared memory.
__device__ void swap23(const float* in, float* out, const int d0, const int d1,
                       const int d2, float (*tile)[kTile + 1]) {
  const int t1s = (d1 + kTile - 1) / kTile, t2s = (d2 + kTile - 1) / kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  constexpr int kStep = kThreads / kTile;
  for (int tt = 0; tt < d0 * t1s * t2s; ++tt) {
    const int i0 = tt / (t1s * t2s), i1 = (tt / t2s) % t1s * kTile, i2 = tt % t2s * kTile;
    const float* src = in + static_cast<size_t>(i0) * d1 * d2;
    float* dst = out + static_cast<size_t>(i0) * d1 * d2;
    for (int y = ty; y < kTile; y += kStep)
      if (i1 + y < d1 && i2 + tx < d2) tile[y][tx] = src[(i1 + y) * d2 + i2 + tx];
    __syncthreads();
    for (int y = ty; y < kTile; y += kStep)
      if (i2 + y < d2 && i1 + tx < d1) dst[(i2 + y) * d1 + i1 + tx] = tile[tx][y];
    __syncthreads();
  }
}

// s12: [d0, d1, d2] -> [d1, d0, d2], whole rows of d2 moved.
__device__ void swap12(const float* in, float* out, const int d0, const int d1,
                       const int d2) {
  for (int e = threadIdx.x; e < d0 * d1 * d2; e += kThreads) {
    const int row = e / d2, i2 = e - row * d2, i0 = row / d1, i1 = row - i0 * d1;
    out[(static_cast<size_t>(i1) * d0 + i0) * d2 + i2] = in[e];
  }
  __syncthreads();
}

// One job per (band, part); scratch per block: two buffers of M M N floats.
__global__ void __launch_bounds__(kThreads)
micro_swaponly_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                      float* __restrict__ outr, float* __restrict__ outi,
                      float* __restrict__ scratch, const int bands, const int M,
                      const int N) {
  __shared__ float tile[kTile][kTile + 1];
  const size_t cube = static_cast<size_t>(M) * M * M, big = static_cast<size_t>(M) * M * N;
  float* A = scratch + blockIdx.x * 2 * big;
  float* B = A + big;
  for (int job = blockIdx.x; job < 2 * bands; job += gridDim.x) {
    const int g = job >> 1;
    const float* x = ((job & 1) ? xi : xr) + g * cube;
    float* o = ((job & 1) ? outi : outr) + g * cube;
    for (int e = threadIdx.x; e < M * M * N; e += kThreads)
      A[e] = x[static_cast<size_t>(e / N) * M] * 1.0f;
    __syncthreads();
    int d[3] = {M, M, N};
    float *src = A, *dst = B;
    for (int rep = 0; rep < 3; ++rep) {
      for (int s = 0; s < 4; ++s) {
        if (s % 2 == 0) {
          swap23(src, dst, d[0], d[1], d[2], tile);
          const int tmp = d[1]; d[1] = d[2]; d[2] = tmp;
        } else {
          swap12(src, dst, d[0], d[1], d[2]);
          const int tmp = d[0]; d[0] = d[1]; d[1] = tmp;
        }
        float* tmp = src; src = dst; dst = tmp;
      }
    }
    // d is (M, M, N) again: out = big[:M, :M, :M] + x
    for (int e = threadIdx.x; e < M * M * M; e += kThreads)
      o[e] = src[static_cast<size_t>(e / M) * N + e % M] + x[e];
    __syncthreads();
  }
}

// Shared-memory bytes of micro_full at (M, N): W and the largest row tile.
int micro_full_smem(const int M, const int N) {
  const int t_fwd = kRows * (kThreads / (2 * N)) * 2 * M;
  const int t_bwd = kRows * (kThreads / (2 * M)) * 2 * N;
  return (4 * M * N + (t_fwd > t_bwd ? t_fwd : t_bwd)) * static_cast<int>(sizeof(float));
}

}  // namespace

extern "C" {

// blocks: the persistent grid; scratch: blocks * 2 (ping + pong) floats.
int dftk_micro_full(const void* xr, const void* xi, const void* V, const void* F,
                    const void* G, void* outr, void* outi, void* scratch, int bands, int nb,
                    int M, int N, int blocks, void* stream) {
  const size_t ping = static_cast<size_t>(M) * M * N > static_cast<size_t>(N) * N * N
                          ? static_cast<size_t>(M) * M * N : static_cast<size_t>(N) * N * N;
  const size_t pong = static_cast<size_t>(M) * N * N;
  const int smem = micro_full_smem(M, N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        micro_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  micro_full_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(V), static_cast<const float*>(F),
      static_cast<const float*>(G), static_cast<float*>(outr), static_cast<float*>(outi),
      static_cast<float*>(scratch), bands, nb, M, N, ping, pong);
  return static_cast<int>(cudaGetLastError());
}

// scratch: blocks * 2 * M * M * N floats.
int dftk_micro_swaponly(const void* xr, const void* xi, void* outr, void* outi,
                        void* scratch, int bands, int M, int N, int blocks, void* stream) {
  micro_swaponly_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<float*>(outr), static_cast<float*>(outi), static_cast<float*>(scratch),
      bands, M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
