// The op probes of the fused local apply and of Mosaic's op support: a
// batched transpose (and row permute), a realified GEMM and the fused
// transpose -> GEMM -> V -> GEMM -> transpose axis chain.
//
// Replaces the TPU probe kernels of tools/probe_pallas_fused.py,
// tools/probe_pallas_fused2.py and tools/probe_mosaic_ops.py (each a Mosaic
// op probe of one body):
//   t_kernel (:41), s_kernel (:61), k_a (:42), k_b (:57) -> op_transpose_kernel
//   probe_mosaic_ops bodies (1), (2), (5), (7) (:37-76)  -> op_permute_rows_kernel
//   g_kernel (:83), k_c (:76)                            -> op_gemm_kernel
//   probe_mosaic_ops bodies (3), (4), (6), (8) (:45-103) -> op_gemm_kernel
//   f_kernel (:110)                                      -> op_fused_axis_kernel
// f32 out, sums in f32 FMAs outside the tensor cores (the bodies' HIGHEST
// precision is full f32: no TF32).
//
// op_transpose: in viewed as [B, P, M, Q, L] -> out [B, Q, M, P, L], rows of
// L contiguous floats moving whole, in two entry points.
// dftk_op_transpose is the batched transpose out[b, c, r] = in[b, r, c] of
// in [B, R, C] (M = L = 1; op_transpose_kernel).  The four transpose bodies
// of rows 3-4 are this once their views are taken (views of contiguous
// tensors cost nothing, so k_b's merge-swap-split is one launch).  A block
// moves G batch entries' [TR, TC] tiles through shared memory: loads run
// along c, stores along r, both on consecutive addresses; the tile's row
// pitch is odd, so the column reads of the stores hit distinct banks.  Where
// R or C is below 32 the tile takes the whole short axis and G folds batch
// entries into one block (the wrapper picks TR, TC, G), so s_kernel's C = 2
// moves 8 whole [64, 2] entries per block, not 2 of 32 lanes.  Any R, C:
// ragged tiles are masked.  dftk_op_permute_rows (M or L above 1) has each
// output row gather its input row (op_permute_rows_kernel): a grid-stride
// loop over the output in float4 units where L is a multiple of 4 and both
// pointers are 16-byte aligned, so loads run along rows of L and stores
// along the whole output.  probe_mosaic_ops's permute (2,1,0,3) of
// [64, 2, 32, 128] is [1, 64, 2, 32, 128] (rows of 128); its three reshapes
// are copies with P = Q = 1 (a pallas_call writes a new buffer, so the
// port's body does too).  Bound by bytes (each value read and written once,
// no arithmetic).
//
// op_gemm: C = A @ W per batch entry.  A's K columns come from P equal
// column parts with their own pointers and C's N columns go to Q equal
// column parts, so k_c's concat(ar, ai) @ F -> (re, im) builds no concat
// buffer and no slice copy.  A tiled SIMT GEMM: a 64 x 64 output tile per
// block, K in steps of 16 with the A tile (transposed, padded) and the W
// tile in shared memory, a 4 x 4 register micro-tile per thread (8 shared
// loads per 16 FMAs).  At the probes' K = 64 it is bound by operations on
// the card's f32 FMA rate.  Three operand modes: 'highest' (f32 operands),
// 'default' (f32 operands rounded to bf16, round to nearest even, as they
// are staged into shared memory: the TPU's one-pass bf16 product of
// Precision.DEFAULT, bodies (4) and (6)) and bf16 operands in device memory
// widened as staged (body (8)); products and sums in f32 in all three.
// Body (4), a dot_general over dim 0 of a 3-D rhs, is F @ d3 viewed
// [64, 4096]; body (6) is batched, W strided per batch entry.
//
// op_fused_axis: the whole f_kernel in one launch, no intermediate in
// device memory.  For band b of x [nb, m1, R] and pair r' < R/2,
// u = (x[b, :, 2r'], x[b, :, 2r'+1]) indexed c m1 + m; y = u F (F [2m1, 2m1]);
// y[e m1 + k] *= V[r', 0, k]; w = y F^T; out[b, n, 2r' + d] = w[d m1 + n].
// One block per (band, 64 pairs): the [m1, 128] column tile of x, loaded
// row by row on consecutive addresses, F (padded, read as F and as F^T on
// distinct banks), the V tile and y stay in shared memory (58 KB at
// m1 = 32); the output tile goes back through the x tile's buffer and is
// stored row by row.  The TPU body's grid of 2 bands per step is a VMEM
// blocking choice and is not kept.  Bound by operations (539 MFLOP at the
// probe's shapes against 17.3 MB in and out).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

// ---- op_transpose -----------------------------------------------------------
constexpr int kTileSmem = 2048;    // floats: a tile of up to 1024 values, padded

__global__ void __launch_bounds__(kThreads)
op_transpose_kernel(const float* __restrict__ in, float* __restrict__ out, const int B,
                    const int R, const int C, const int TR, const int TC, const int G) {
  __shared__ float tile[kTileSmem];
  const int pitch = TC | 1;
  const int tiles_c = (C + TC - 1) / TC, tiles_r = (R + TR - 1) / TR;
  int t = blockIdx.x;
  const int c0 = t % tiles_c * TC;
  t /= tiles_c;
  const int r0 = t % tiles_r * TR;
  const int b0 = t / tiles_r * G;
  const int per = TR * TC, n = G * per;
  for (int e = threadIdx.x; e < n; e += kThreads) {        // along c
    const int g = e / per, rem = e - g * per, rr = rem / TC, cc = rem - rr * TC;
    const int b = b0 + g, r = r0 + rr, c = c0 + cc;
    if (b < B && r < R && c < C)
      tile[(g * TR + rr) * pitch + cc] = in[(static_cast<size_t>(b) * R + r) * C + c];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += kThreads) {        // along r
    const int g = e / per, rem = e - g * per, cc = rem / TR, rr = rem - cc * TR;
    const int b = b0 + g, r = r0 + rr, c = c0 + cc;
    if (b < B && r < R && c < C)
      out[(static_cast<size_t>(b) * C + c) * R + r] = tile[(g * TR + rr) * pitch + cc];
  }
}

// out [B, Q, M, P, L] from in [B, P, M, Q, L], in units of V (float or
// float4: L counted in units).
template <typename V>
__global__ void __launch_bounds__(kThreads)
op_permute_rows_kernel(const V* __restrict__ in, V* __restrict__ out, const int P,
                       const int M, const int Q, const int L, const long long n) {
  for (long long o = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; o < n;
       o += static_cast<long long>(gridDim.x) * kThreads) {
    long long r = o / L;
    const int l = static_cast<int>(o - r * L);
    const int p = static_cast<int>(r % P);
    r /= P;
    const int m = static_cast<int>(r % M);
    r /= M;
    const int q = static_cast<int>(r % Q);
    const long long b = r / Q;
    out[o] = in[(((b * P + p) * M + m) * Q + q) * L + l];
  }
}

// ---- op_gemm ------------------------------------------------------------------
constexpr int kBM = 64, kBN = 64, kBK = 16;
enum GemmMode { kHighest = 0, kDefault = 1, kBf16 = 2 };

// Operand i of a: f32 ('highest'), f32 rounded to bf16 ('default') or bf16
// in memory, as f32.
template <int kMode>
__device__ __forceinline__ float operand(const void* a, const size_t i) {
  if (kMode == kBf16) return __bfloat162float(static_cast<const __nv_bfloat16*>(a)[i]);
  const float v = static_cast<const float*>(a)[i];
  if (kMode == kDefault) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// Batch entry z: A part p holds columns [p Kp, (p + 1) Kp) at
// a[p] + z sa + m lda + k; W [K, N] at w + z sw + k ldw + n; C part q holds
// columns [q Nq, (q + 1) Nq) at c[q] + z sc + m ldc + n.  A and W are f32,
// or bf16 in kBf16 mode; C is f32.
struct Gemm {
  const void* a0; const void* a1; const void* w; float* c0; float* c1;
  int M, K, N, P, Q, lda, ldw, ldc, sa, sw, sc;
};

template <int kMode>
__global__ void __launch_bounds__(kThreads) op_gemm_kernel(const Gemm g) {
  __shared__ float As[kBK][kBM + 1];
  __shared__ float Ws[kBK][kBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const size_t z = blockIdx.z;
  const int Kp = g.K / g.P, Nq = g.N / g.Q;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < g.K; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int mm = e / kBK, kk = e - mm * kBK, m = m0 + mm, k = k0 + kk;
      float v = 0.f;
      if (m < g.M && k < g.K) {
        const int p = k / Kp;
        v = operand<kMode>(p == 0 ? g.a0 : g.a1,
                           z * g.sa + static_cast<size_t>(m) * g.lda + (k - p * Kp));
      }
      As[kk][mm] = v;
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN, nn = e - kk * kBN, k = k0 + kk, n = n0 + nn;
      Ws[kk][nn] = k < g.K && n < g.N
                       ? operand<kMode>(g.w, z * g.sw + static_cast<size_t>(k) * g.ldw + n)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (m < g.M && n < g.N) {
        const int q = n / Nq;
        float* c = q == 0 ? g.c0 : g.c1;
        c[z * g.sc + static_cast<size_t>(m) * g.ldc + (n - q * Nq)] = acc[i][j];
      }
    }
  }
}

// ---- op_fused_axis ------------------------------------------------------------
constexpr int kPairs = 64;         // column pairs (2r', 2r' + 1) per block

int fused_axis_smem(const int m1) {
  const int NC = 2 * m1;
  return (m1 * (2 * kPairs + 1) + (NC + kPairs) * (NC + 1) + kPairs * m1)
         * static_cast<int>(sizeof(float));
}

// Thread (tx, ty) owns pairs ty + 16 i (i < 4) and columns tx + 16 j (j < 4)
// of both products; 2 m1 <= 64.
__global__ void __launch_bounds__(kThreads)
op_fused_axis_kernel(const float* __restrict__ x, const float* __restrict__ F,
                     const float* __restrict__ V, float* __restrict__ out, const int m1,
                     const int R) {
  extern __shared__ __align__(16) float smem[];
  const int NC = 2 * m1, half = R / 2;
  const int xp = 2 * kPairs + 1, fp = NC + 1;
  float* Xs = smem;                   // [m1][xp]: the x tile, then the output tile
  float* Fs = Xs + m1 * xp;           // [NC][fp]
  float* Ys = Fs + NC * fp;           // [kPairs][fp]
  float* Vs = Ys + kPairs * fp;       // [kPairs][m1]
  const int tiles = (half + kPairs - 1) / kPairs;
  const int b = blockIdx.x / tiles, p0 = blockIdx.x % tiles * kPairs;
  const int cols = 2 * min(kPairs, half - p0);
  const float* xb = x + static_cast<size_t>(b) * m1 * R + 2 * p0;
  float* ob = out + static_cast<size_t>(b) * m1 * R + 2 * p0;
  for (int e = threadIdx.x; e < m1 * 2 * kPairs; e += kThreads) {
    const int m = e / (2 * kPairs), c = e - m * 2 * kPairs;
    Xs[m * xp + c] = c < cols ? xb[static_cast<size_t>(m) * R + c] : 0.f;
  }
  for (int e = threadIdx.x; e < NC * NC; e += kThreads) {
    const int i = e / NC;
    Fs[i * fp + e - i * NC] = __ldg(F + e);
  }
  for (int e = threadIdx.x; e < kPairs * m1; e += kThreads)
    Vs[e] = e < cols / 2 * m1 ? __ldg(V + static_cast<size_t>(p0) * m1 + e) : 0.f;
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  // y = u F, u[p][c m1 + m] = Xs[m][2p + c]
  for (int k = 0; k < NC; ++k) {
    const int c = k >= m1, m = k - c * m1;
    float u[4], f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = Xs[m * xp + 2 * (ty + 16 * i) + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = tx + 16 * j < NC ? Fs[k * fp + tx + 16 * j] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(u[i], f[j], acc[i][j]);
  }
  // y[e m1 + k] *= V[r', 0, k]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      if (n < NC) Ys[p * fp + n] = acc[i][j] * Vs[p * m1 + (n < m1 ? n : n - m1)];
      acc[i][j] = 0.f;
    }
  }
  __syncthreads();
  // w = y F^T: w[p][n] = sum_k y[p][k] F[n][k]
  for (int k = 0; k < NC; ++k) {
    float y[4], f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) y[i] = Ys[(ty + 16 * i) * fp + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) f[j] = tx + 16 * j < NC ? Fs[(tx + 16 * j) * fp + k] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(y[i], f[j], acc[i][j]);
  }
  // out[b, n, 2r' + d] = w[d m1 + n], through Xs (read for the last time
  // before the previous barrier)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      if (n < NC) {
        const int d = n >= m1;
        Xs[(n - d * m1) * xp + 2 * p + d] = acc[i][j];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < m1 * 2 * kPairs; e += kThreads) {
    const int m = e / (2 * kPairs), c = e - m * 2 * kPairs;
    if (c < cols) ob[static_cast<size_t>(m) * R + c] = Xs[m * xp + c];
  }
}

}  // namespace

extern "C" {

// in [B, R, C] -> out [B, C, R]; tiles of G x [TR, TC] (TR <= R, TC <= C).
int dftk_op_transpose(const void* in, void* out, int B, int R, int C, int TR, int TC, int G,
                      void* stream) {
  if (B < 1 || R < 1 || C < 1 || TR < 1 || TC < 1 || G < 1 || TR > R || TC > C
      || static_cast<long long>(G) * TR * (TC | 1) > kTileSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>((B + G - 1) / G) * ((R + TR - 1) / TR)
                           * ((C + TC - 1) / TC);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  op_transpose_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), B, R, C, TR, TC, G);
  return static_cast<int>(cudaGetLastError());
}

// in [B, P, M, Q, L] -> out [B, Q, M, P, L], rows of L floats moving whole.
int dftk_op_permute_rows(const void* in, void* out, int B, int P, int M, int Q, int L,
                         void* stream) {
  if (B < 1 || P < 1 || M < 1 || Q < 1 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = L % 4 == 0
                   && (reinterpret_cast<std::uintptr_t>(in)
                       | reinterpret_cast<std::uintptr_t>(out)) % 16 == 0;
  const int Lv = vec ? L / 4 : L;
  const long long n = static_cast<long long>(B) * P * M * Q * Lv;
  const long long blocks = std::min((n + kThreads - 1) / kThreads, 132LL * 16);
  if (vec)
    op_permute_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const float4*>(in), static_cast<float4*>(out), P, M, Q, Lv, n);
  else
    op_permute_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const float*>(in), static_cast<float*>(out), P, M, Q, Lv, n);
  return static_cast<int>(cudaGetLastError());
}

// C = A @ W for each of `batch` entries (strides in elements; see struct
// Gemm); mode: 0 'highest', 1 'default' (operands rounded to bf16), 2 bf16
// operands in memory.
int dftk_op_gemm(const void* a0, const void* a1, const void* w, void* c0, void* c1,
                 int batch, int M, int K, int N, int P, int Q, int lda, int ldw, int ldc,
                 int sa, int sw, int sc, int mode, void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || K < 1 || N < 1 || P < 1 || P > 2 || Q < 1
      || Q > 2 || K % P || N % Q || (M + kBM - 1) / kBM > 65535 || mode < kHighest
      || mode > kBf16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Gemm g{a0, a1, w, static_cast<float*>(c0), static_cast<float*>(c1),
               M, K, N, P, Q, lda, ldw, ldc, sa, sw, sc};
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kHighest)
    op_gemm_kernel<kHighest><<<grid, kThreads, 0, st>>>(g);
  else if (mode == kDefault)
    op_gemm_kernel<kDefault><<<grid, kThreads, 0, st>>>(g);
  else
    op_gemm_kernel<kBf16><<<grid, kThreads, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// x [nb, m1, R], F [2 m1, 2 m1], V [R / 2, 1, m1] -> out [nb, m1, R]; m1 <= 32, R even.
int dftk_op_fused_axis(const void* x, const void* F, const void* V, void* out, int nb,
                       int m1, int R, void* stream) {
  if (nb < 1 || m1 < 1 || m1 > 32 || R < 2 || R % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(nb) * ((R / 2 + kPairs - 1) / kPairs);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fused_axis_smem(m1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        op_fused_axis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  op_fused_axis_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(F),
      static_cast<const float*>(V), static_cast<float*>(out), m1, R);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
