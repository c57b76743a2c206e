// The op-speed probes: one op repeated R times on data that stays on the
// chip, in one launch.
//
// Replaces the TPU probe kernel of tools/probe_mosaic_speed.py (`run`, its
// pallas_call at :27), whose bodies each hold their arrays in VMEM and
// repeat one op R = 100 times in a fori_loop:
//   kern of rep_dot (:47), kern_d1 (:76)  -> op_rep_gemm_kernel
//   kern_tp (:89), kern_tp2 (:96), kern_tp3 (:114) -> op_rep_swap_kernel
//   kern_vm (:104)                         -> op_rep_vmul_kernel
// Every op is separable, so each block owns its part of the data for all R
// steps: global memory is read once and written once, and each step runs
// on shared memory or registers.  f32 data; nothing is folded across
// steps, each step's multiplies are rounded as the JAX body's are
// (__fmul_rn / __fadd_rn: never contracted into an FMA), and the build
// keeps subnormals (no -ftz, no fast math: kern_vm's products fall to
// subnormals and to zero within the 100 steps).
//
// op_rep_gemm: acc [Z, K, N], F [K, K]; R times
//   acc <- 1e-3 (F @ acc) + 0.5 acc
// (rep_dot: Z = 1; kern_d1: acc [a, b, c] with the contraction over b and
// the (1, 0, 2) transpose putting F's rows back on b, so each acc[a] evolves
// as a rep_dot of its own).  A block owns (z, a strip of 32 columns): F
// (row pitch K + 1) and the strip's operand copy [K, 36] stay in shared
// memory for all R steps; thread (tx, ty) owns rows ty + 32 i (i < RI,
// RI = ceil(K / 32)) and columns 4 tx .. 4 tx + 3, holds their exact f32
// acc in registers and builds the new values there (RI shared loads and one
// float4 per 4 RI FMAs); one barrier, the write-back of the operand copy,
// a second barrier.  'default' rounds F (once) and the operand copy (each
// step) to bf16, round to nearest even, as the TPU's one-pass bf16 product
// of Precision.DEFAULT does; the 0.5 acc term takes the unrounded acc, as
// the JAX body does.  Bound by operations (2 K^2 N per step per entry).
//
// op_rep_swap: x viewed [B, P, M, P, L]; R times x <- s (x with its two P
// axes swapped).  The swap is an involution: a block owns the T x T tile of
// rows (p in tile pt, q in tile qt) and its partner (p in qt, q in pt), each
// row a chunk of Lc contiguous floats (a diagonal tile pt = qt is its own
// partner), in two shared buffers; a step reads every value of one buffer,
// multiplies it by s and writes it at its swapped place in the other: one
// barrier per step, every step a real move and a real multiply.  Loads and
// stores of device memory run along rows of Lc (or along q where L = 1, as
// in kern_tp3); the buffers' row pitch T Lc is odd, so the transposed
// accesses of L = 1 hit distinct banks.  Bound by bytes in device memory;
// each step moves 2 x 4 bytes per value through shared memory.
//
// op_rep_vmul: x [A, J, Bk, L], V [A, Bk]; R times x <- (x V[a, k]) 1.001.
// Elementwise: each thread keeps four values (a grid stride apart, so loads
// and stores are coalesced) and their V in registers for all R steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;   // the most dynamic shared memory a block may use

// ---- op_rep_gemm ----------------------------------------------------------------
constexpr int kStrip = 32;          // columns per block
constexpr int kStripPitch = kStrip + 4;
constexpr int kMaxK = 128;

// F with row pitch K + 1 and the [K, kStripPitch] strip, 16 bytes of alignment.
constexpr int rep_gemm_smem(const int K) {
  return (K * (K + 1) + K * kStripPitch) * static_cast<int>(sizeof(float)) + 16;
}
static_assert(rep_gemm_smem(kMaxK) <= kSmemMax, "op_rep_gemm's block fits at K = kMaxK");

__device__ __forceinline__ float round_bf16(const float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int RI, bool kRound>
__global__ void __launch_bounds__(kThreads)
op_rep_gemm_kernel(const float* __restrict__ acc_in, const float* __restrict__ F,
                   float* __restrict__ acc_out, const int K, const int N, const int R) {
  extern __shared__ __align__(16) float smem[];
  const int fp = K + 1;
  float* Fs = smem;                  // [K][fp]
  float* Xs = Fs + K * fp;           // [K][kStripPitch], 16-byte aligned rows
  if (K * fp % 4) Xs += 4 - K * fp % 4;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int strips = (N + kStrip - 1) / kStrip;
  const int n0 = blockIdx.x % strips * kStrip;
  const size_t zoff = static_cast<size_t>(blockIdx.x / strips) * K * N;
  for (int e = threadIdx.x; e < K * K; e += kThreads) {
    const int i = e / K;
    const float f = __ldg(F + e);
    Fs[i * fp + e - i * K] = kRound ? round_bf16(f) : f;
  }
  float a[RI][4];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = ty + 32 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      a[i][j] = row < K && n < N ? acc_in[zoff + static_cast<size_t>(row) * N + n] : 0.f;
      if (row < K) Xs[row * kStripPitch + 4 * tx + j] = kRound ? round_bf16(a[i][j]) : a[i][j];
    }
  }
  int frow[RI];                      // F's row of each owned row (the last one past K)
#pragma unroll
  for (int i = 0; i < RI; ++i) frow[i] = min(ty + 32 * i, K - 1) * fp;
  __syncthreads();
  for (int step = 0; step < R; ++step) {
    float y[RI][4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) y[i][j] = 0.f;
#pragma unroll 4
    for (int b = 0; b < K; ++b) {
      const float4 x = *reinterpret_cast<const float4*>(Xs + b * kStripPitch + 4 * tx);
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float f = Fs[frow[i] + b];
        y[i][0] = fmaf(f, x.x, y[i][0]);
        y[i][1] = fmaf(f, x.y, y[i][1]);
        y[i][2] = fmaf(f, x.z, y[i][2]);
        y[i][3] = fmaf(f, x.w, y[i][3]);
      }
    }
    __syncthreads();                 // every read of this step's operand is done
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = ty + 32 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[i][j] = __fadd_rn(__fmul_rn(y[i][j], 1e-3f), __fmul_rn(a[i][j], 0.5f));
        if (row < K) Xs[row * kStripPitch + 4 * tx + j] = kRound ? round_bf16(a[i][j]) : a[i][j];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = ty + 32 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (row < K && n < N) acc_out[zoff + static_cast<size_t>(row) * N + n] = a[i][j];
    }
  }
}

template <int RI, bool kRound>
cudaError_t launch_rep_gemm(const float* acc, const float* F, float* out, const int Z,
                            const int K, const int N, const int R, const cudaStream_t st) {
  const int smem = rep_gemm_smem(K);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        op_rep_gemm_kernel<RI, kRound>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = static_cast<long long>(Z) * ((N + kStrip - 1) / kStrip);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  op_rep_gemm_kernel<RI, kRound><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      acc, F, out, K, N, R);
  return cudaGetLastError();
}

template <bool kRound>
cudaError_t dispatch_rep_gemm(const float* acc, const float* F, float* out, const int Z,
                              const int K, const int N, const int R, const cudaStream_t st) {
  switch ((K + 31) / 32) {
    case 1: return launch_rep_gemm<1, kRound>(acc, F, out, Z, K, N, R, st);
    case 2: return launch_rep_gemm<2, kRound>(acc, F, out, Z, K, N, R, st);
    case 3: return launch_rep_gemm<3, kRound>(acc, F, out, Z, K, N, R, st);
    default: return launch_rep_gemm<4, kRound>(acc, F, out, Z, K, N, R, st);
  }
}

// ---- op_rep_swap ----------------------------------------------------------------
constexpr int kSwapTile = 2048;   // values per tile: T T Lc <= kSwapTile

// Two buffers of two T x T tiles, row pitch T Lc | 1.
int rep_swap_smem(const int T, const int Lc) {
  return 2 * 2 * T * ((T * Lc) | 1) * static_cast<int>(sizeof(float));
}
static_assert(2 * 2 * (kSwapTile + 32) * sizeof(float) <= 48 * 1024,
              "op_rep_swap's block fits in the default 48 KB at every tile");

// The tiles, both powers of two: Lc up to 32 of L, T up to 32 of P, then T
// halved until T T Lc <= kSwapTile.
void swap_tile(const int P, const int L, int* logT, int* logLc) {
  const auto bits = [](int v) {
    int b = 0;
    for (; v > 0; v >>= 1) ++b;
    return b;
  };
  *logLc = std::min(5, bits(L - 1));
  *logT = std::min(5, bits(P - 1));
  while ((1 << (2 * *logT + *logLc)) > kSwapTile && *logT > 0) --*logT;
}

// Block: (b, m, chunk of Lc, tile pair pt <= qt).  Buffer slot (t, i, j, l)
// at (t T + i) pitch + j Lc + l holds the row (p, q) = (p0 + i, q0 + j) for
// t = 0 and (q0 + i, p0 + j) for t = 1; the swap sends (t, i, j, l) to
// (1 - t, j, i, l), or to (0, j, i, l) on a diagonal pair.
__global__ void __launch_bounds__(kThreads)
op_rep_swap_kernel(const float* __restrict__ in, float* __restrict__ out, const int P,
                   const int M, const int L, const int logT, const int logLc, const int R,
                   const float s) {
  extern __shared__ float sbuf[];
  const int T = 1 << logT, Lc = 1 << logLc, pitch = (T * Lc) | 1;
  const int nt = (P + T - 1) / T, pairs = nt * (nt + 1) / 2;
  const int chunks = (L + Lc - 1) / Lc;
  long long blk = blockIdx.x;
  int k = static_cast<int>(blk % pairs);
  blk /= pairs;
  const int l0 = static_cast<int>(blk % chunks) * Lc;
  blk /= chunks;
  const int m = static_cast<int>(blk % M);
  const long long b = blk / M;
  int pt = 0;
  while (k >= nt - pt) {
    k -= nt - pt;
    ++pt;
  }
  const int qt = pt + k, p0 = pt * T, q0 = qt * T;
  const bool diag = pt == qt;
  const int n = (diag ? 1 : 2) << (2 * logT + logLc), half = 2 * T * pitch;

  // global offset of slot (t, i, j, l), or -1 outside the data
  auto global = [&](const int t, const int i, const int j, const int l) -> long long {
    const int p = (t ? q0 : p0) + i, q = (t ? p0 : q0) + j, ll = l0 + l;
    if (p >= P || q >= P || ll >= L) return -1;
    return (((b * P + p) * M + m) * P + q) * L + ll;
  };
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int l = e & (Lc - 1), j = (e >> logLc) & (T - 1), i = (e >> (logLc + logT)) & (T - 1);
    const int t = e >> (logLc + 2 * logT);
    const long long g = global(t, i, j, l);
    sbuf[(t * T + i) * pitch + j * Lc + l] = g >= 0 ? in[g] : 0.f;
  }
  __syncthreads();
  int cur = 0;
  for (int step = 0; step < R; ++step) {
    const float* src = sbuf + cur * half;
    float* dst = sbuf + (cur ^ 1) * half;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int l = e & (Lc - 1), j = (e >> logLc) & (T - 1);
      const int i = (e >> (logLc + logT)) & (T - 1), t = e >> (logLc + 2 * logT);
      dst[((diag ? 0 : t ^ 1) * T + j) * pitch + i * Lc + l] =
          __fmul_rn(src[(t * T + i) * pitch + j * Lc + l], s);
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int l = e & (Lc - 1), j = (e >> logLc) & (T - 1), i = (e >> (logLc + logT)) & (T - 1);
    const int t = e >> (logLc + 2 * logT);
    const long long g = global(t, i, j, l);
    if (g >= 0) out[g] = sbuf[cur * half + (t * T + i) * pitch + j * Lc + l];
  }
}

// ---- op_rep_vmul ----------------------------------------------------------------
constexpr int kPerThread = 4;

__global__ void __launch_bounds__(kThreads)
op_rep_vmul_kernel(const float* __restrict__ x, const float* __restrict__ V,
                   float* __restrict__ out, const int J, const int Bk, const int L,
                   const long long n, const int R) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long e0 = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  float v[kPerThread], w[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long e = e0 + u * stride;
    v[u] = w[u] = 0.f;
    if (e < n) {
      const long long r = e / L;            // (a, j, k) flattened
      const int k = static_cast<int>(r % Bk);
      const long long a = r / Bk / J;
      v[u] = x[e];
      w[u] = __ldg(V + a * Bk + k);
    }
  }
  for (int step = 0; step < R; ++step)
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) v[u] = __fmul_rn(__fmul_rn(v[u], w[u]), 1.001f);
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long e = e0 + u * stride;
    if (e < n) out[e] = v[u];
  }
}

}  // namespace

extern "C" {

// acc [Z, K, N] -> out [Z, K, N] after R steps with F [K, K]; K <= 128;
// round: 0 'highest', 1 'default'.
int dftk_op_rep_gemm(const void* acc, const void* F, void* out, int Z, int K, int N, int R,
                     int round, void* stream) {
  if (Z < 1 || K < 1 || K > kMaxK || N < 1 || R < 1 || (round != 0 && round != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto a = static_cast<const float*>(acc);
  const auto f = static_cast<const float*>(F);
  const auto o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(round ? dispatch_rep_gemm<true>(a, f, o, Z, K, N, R, st)
                                : dispatch_rep_gemm<false>(a, f, o, Z, K, N, R, st));
}

// x viewed [B, P, M, P, L] -> out after R swaps of the two P axes, each
// times s.
int dftk_op_rep_swap(const void* in, void* out, int B, int P, int M, int L, int R, float s,
                     void* stream) {
  if (B < 1 || P < 1 || M < 1 || L < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  int logT, logLc;
  swap_tile(P, L, &logT, &logLc);
  const int T = 1 << logT, Lc = 1 << logLc;
  const long long nt = (P + T - 1) / T;
  const long long blocks = static_cast<long long>(B) * M * ((L + Lc - 1) / Lc)
                           * (nt * (nt + 1) / 2);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  op_rep_swap_kernel<<<static_cast<unsigned>(blocks), kThreads, rep_swap_smem(T, Lc),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), P, M, L, logT, logLc, R, s);
  return static_cast<int>(cudaGetLastError());
}

// x [A, J, Bk, L], V [A, Bk] -> out [A, J, Bk, L] after R steps.
int dftk_op_rep_vmul(const void* x, const void* V, void* out, int A, int J, int Bk, int L,
                     int R, void* stream) {
  if (A < 1 || J < 1 || Bk < 1 || L < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(A) * J * Bk * L;
  const long long blocks = (n + kThreads * kPerThread - 1) / (kThreads * kPerThread);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  op_rep_vmul_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(V), static_cast<float*>(out),
      J, Bk, L, n, R);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of one block, as the launches above set it.
int dftk_op_rep_gemm_smem(int K) { return rep_gemm_smem(K); }

int dftk_op_rep_swap_smem(int P, int L) {
  int logT, logLc;
  swap_tile(P, L, &logT, &logLc);
  return rep_swap_smem(1 << logT, 1 << logLc);
}

}  // extern "C"
