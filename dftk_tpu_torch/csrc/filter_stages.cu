// Stage probes of the realified filter chain: a copy kernel and one
// stage-chain kernel template that tear one z-plane of kernel B's work
// (fused_filter_mid in its realified form) down stage by stage.
//
// Replaces the TPU probe kernels
//   tools/probe_pallas_fixed.py   k0                  -> probe_copy
//   tools/probe_kernel_pipe.py    k0, full(zblk)      -> probe_copy, kFull (zblk 1, 4, 8)
//   tools/probe_kernel_variants.py k_full             -> kFull
//                                 k_full_bf           -> kFull, bf16 operands
//                                 k_rep               -> kRep
//                                 k_mdim              -> kFull (its 4-D factors
//                                                        viewed as 2-D, a free view)
//                                 k_dots              -> kDots (see below)
//   tools/probe_kernel_incr.py    k0 -> probe_copy, k1 and k1b -> kF2,
//                                 k2 -> kF2Rep, k3 -> kF2RepF1, k4 -> kFull
// k1b differs from k1 only in the lane layout Mosaic gives its right-hand
// side, which is free on a GPU: both are kF2.
//
// Layout (f32): t, out [n3, m2, 2, m1, nbt]; V [n3, n1, n2]; the realified
// factors, row-major: F2f [2n2, 2m2], F1f [2n1, 2m1], F1b [2m1, 2n1],
// F2b [2m2, 2n2].  Per z-plane and band b, with A = t[z].reshape(2m2, m1):
//   B  = F2f A                      [2n2, m1]   (rows j2*2+c)
//   Bt[a1*2+c, j2] = B[j2*2+c, a1]  [2m1, n2]   (the forward "repair")
//   C  = F1f Bt                     [2n1, n2]   (rows j1*2+c)
//   C[j1*2+c, j2] *= V[z, j1, j2]               (the V multiply)
//   D  = F1b C                      [2m1, n2]
//   Dt[j2*2+c, a1] = D[a1*2+c, j2]  [2n2, m1]   (the backward repair)
//   out = F2b Dt                    [2m2, m1]
// Stage sets: kF2 = F2f, F2b; kF2Rep = + both repairs; kF2RepF1 = + F1f,
// F1b; kFull = + V; kRep = both repairs and V[z, :m1, :m2] on A, no dots.
// kDots is kFull with each repair replaced by a reading of the same buffer
// in the next stage's shape (B [2n2, m1] read as [2m1, n2], D [2m1, n2] as
// [2n2, m1]) and the V multiply by one scale V[z, j1, 0] per j1 row: the
// same four dots and FLOPs, and deliberately wrong math.  It defines what
// the JAX body k_dots (probe_kernel_variants.py:84-93) meant: that body
// cannot run at its own shapes (it feeds F1f [2n1, 2m1] a leading dimension
// of 2n1 where the dot contracts 2m1, and its V line broadcasts to 5-D).
// k_mdim (:110-128) fails in its harness (a two-entry index map for 4-D
// factors), not in its math, which is kFull's.
//
// Design.  A TPU grid step holds one whole z-plane (1 MB at nbt = 128) and
// its 4 MB intermediate in VMEM; a block here has 227 KB of shared memory.
// So a block takes kBands = 4 neighbouring bands (the innermost axis) of
// `zblk` consecutive planes, and loops over the planes.  Per band it keeps
// two [2m1, max(m2, n2)] buffers that the stages ping-pong between, and the
// F1f -> V -> F1b stages run on strips of `strip` columns of j2 (they act
// on each column independently) through one [2n1, strip] buffer, as kernel
// B does.  The repairs are index remaps from one buffer into the other.
// The layout in shared memory is [row][column][band], so a warp reads 32
// consecutive floats of the data operand and one broadcast factor element
// (__ldg); each output element is one thread's dot product.
//
// What bounds it on an H100: the full f32 chain is 25.8 GFLOP against
// 134 MB of device traffic at the probes' shapes (m = 32, n = 64,
// nbt = 128), so it is bound by operations (0.385 ms at 67 TFLOP/s); the
// copy and kRep are bound by bytes.  This kernel runs its dots on the f32
// FMA units with one shared-memory load and one factor load per FMA: no
// register blocking, no tensor cores, one 192 KB block per SM.
//
// bf16 (kFull only): both operands of every dot rounded to bf16, round to
// nearest even, as it is read; f32 sums; the V multiply in f32 on the f32
// sums, as k_full_bf does with `astype(jnp.bfloat16)`.
#include "dftk_complex.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBands = 4;
constexpr int kCopyThreads = 1024;

enum Stages : int { kF2 = 0, kF2Rep = 1, kF2RepF1 = 2, kFull = 3, kRep = 4, kDots = 5 };

template <bool kBf16>
__device__ __forceinline__ float op(const float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// out[p, col, b] = sum_q F[p, q] in[q, col, b]: F [P, Q] in device memory,
// `in` [Q, cols, kBands] in shared memory; the output element (p, col, b)
// lands at out[p * ors + col * ocs + b] (shared or device memory).
template <bool kBf16>
__device__ void dot_stage(const float* __restrict__ F, const int P, const int Q,
                          const float* in, const int cols, float* out,
                          const size_t ors, const int ocs) {
  const int per_row = cols * kBands;
  for (int e = threadIdx.x; e < P * per_row; e += blockDim.x) {
    const int p = e / per_row, cb = e - p * per_row;
    const float* Fp = F + static_cast<size_t>(p) * Q;
    float acc = 0.f;
    for (int q = 0; q < Q; ++q)
      acc = fmaf(op<kBf16>(__ldg(Fp + q)), op<kBf16>(in[q * per_row + cb]), acc);
    out[p * ors + (cb / kBands) * ocs + (cb % kBands)] = acc;
  }
}

// The repair: in [2R, S, kBands] -> out [2S, R, kBands],
// out[s*2+c, r, b] = in[r*2+c, s, b].
__device__ void swap_pairs(const float* in, const int R, const int S, float* out) {
  const int per_row = R * kBands;
  for (int e = threadIdx.x; e < 2 * S * per_row; e += blockDim.x) {
    const int row = e / per_row, rb = e - row * per_row;
    const int s = row >> 1, c = row & 1, r = rb / kBands, b = rb % kBands;
    out[e] = in[((r * 2 + c) * S + s) * kBands + b];
  }
}

// F1f, the V multiply and F1b on Z [2m1, P, kBands] in place, strip by
// strip of the P columns, through Cs [2n1, strip, kBands].  kV: multiply
// row j1*2+c, column j by V[j1, j] (kDots: by V[j1, 0]).  The wrapper picks
// a strip that divides P; the width is still taken per strip, as that form
// compiles to the faster code (40 registers for kFull, not 32; PERF.md).
template <bool kBf16, bool kV, bool kDotsScale>
__device__ void f1_stage(float* Z, float* Cs, const int P, const int m1, const int n1,
                         const int n2, const int strip, const float* __restrict__ F1f,
                         const float* __restrict__ F1b, const float* __restrict__ Vz) {
  for (int s0 = 0; s0 < P; s0 += strip) {
    const int w = min(strip, P - s0), per_row = w * kBands;
    for (int e = threadIdx.x; e < 2 * n1 * per_row; e += blockDim.x) {
      const int i = e / per_row, jb = e - i * per_row;
      const float* Fi = F1f + static_cast<size_t>(i) * 2 * m1;
      const float* Zc = Z + s0 * kBands + jb;
      float acc = 0.f;
      for (int s = 0; s < 2 * m1; ++s)
        acc = fmaf(op<kBf16>(__ldg(Fi + s)), op<kBf16>(Zc[s * P * kBands]), acc);
      if constexpr (kV)
        acc *= __ldg(Vz + (i >> 1) * n2 + (kDotsScale ? 0 : s0 + jb / kBands));
      Cs[e] = acc;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < 2 * m1 * per_row; e += blockDim.x) {
      const int r = e / per_row, jb = e - r * per_row;
      const float* Fr = F1b + static_cast<size_t>(r) * 2 * n1;
      float acc = 0.f;
      for (int i = 0; i < 2 * n1; ++i)
        acc = fmaf(op<kBf16>(__ldg(Fr + i)), op<kBf16>(Cs[i * per_row + jb]), acc);
      Z[r * P * kBands + s0 * kBands + jb] = acc;
    }
    __syncthreads();
  }
}

// One block: bands [b0, b0 + kBands) of planes [z0, z0 + zblk).  R: floats
// per band of each of the two ping-pong buffers.
template <int kStages, bool kBf16>
__global__ void __launch_bounds__(kThreads)
probe_stages_kernel(const float* __restrict__ t, const float* __restrict__ V,
                    const float* __restrict__ F2f, const float* __restrict__ F1f,
                    const float* __restrict__ F1b, const float* __restrict__ F2b,
                    float* __restrict__ out, const int m1, const int m2, const int n1,
                    const int n2, const int nbt, const int zblk, const int strip,
                    const int R) {
  extern __shared__ __align__(16) float smem[];
  float* R0 = smem;
  float* R1 = smem + R * kBands;
  float* Cs = smem + 2 * R * kBands;
  const int b0 = blockIdx.x * kBands;
  const size_t plane = static_cast<size_t>(2) * m2 * m1 * nbt;
  for (int zz = 0; zz < zblk; ++zz) {
    const int z = blockIdx.y * zblk + zz;
    const float* tz = t + z * plane + b0;
    float* oz = out + z * plane + b0;
    const float* Vz = V + static_cast<size_t>(z) * n1 * n2;
    __syncthreads();   // the previous plane's last reads of R0 and R1
    for (int e = threadIdx.x; e < 2 * m2 * m1 * kBands; e += blockDim.x)
      R0[e] = tz[static_cast<size_t>(e / kBands) * nbt + e % kBands];
    __syncthreads();
    if constexpr (kStages == kRep) {
      swap_pairs(R0, m2, m1, R1);                       // [2m1, m2]
      __syncthreads();
      for (int e = threadIdx.x; e < 2 * m1 * m2 * kBands; e += blockDim.x) {
        const int a1 = e / (2 * m2 * kBands), a2 = (e / kBands) % m2;
        R1[e] *= __ldg(Vz + a1 * n2 + a2);
      }
      __syncthreads();
      swap_pairs(R1, m1, m2, R0);                       // [2m2, m1]
      __syncthreads();
      for (int e = threadIdx.x; e < 2 * m2 * m1 * kBands; e += blockDim.x)
        oz[static_cast<size_t>(e / kBands) * nbt + e % kBands] = R0[e];
    } else {
      dot_stage<kBf16>(F2f, 2 * n2, 2 * m2, R0, m1, R1, m1 * kBands, kBands);  // B
      __syncthreads();
      if constexpr (kStages == kDots) {
        // B read as [2m1, n2]; D left in place and read as [2n2, m1]
        f1_stage<kBf16, true, true>(R1, Cs, n2, m1, n1, n2, strip, F1f, F1b, Vz);
      } else if constexpr (kStages != kF2) {
        swap_pairs(R1, n2, m1, R0);                     // Bt [2m1, n2]
        __syncthreads();
        if constexpr (kStages == kF2RepF1 || kStages == kFull)
          f1_stage<kBf16, kStages == kFull, false>(R0, Cs, n2, m1, n1, n2, strip,
                                                   F1f, F1b, Vz);
        swap_pairs(R0, m1, n2, R1);                     // Dt [2n2, m1]
        __syncthreads();
      }
      dot_stage<kBf16>(F2b, 2 * m2, 2 * n2, R1, m1, oz,
                       static_cast<size_t>(m1) * nbt, nbt);
    }
  }
}

template <int kStages, bool kBf16>
int launch_stages(const void* t, const void* V, const void* F2f, const void* F1f,
                  const void* F1b, const void* F2b, void* out, int n3, int m1, int m2,
                  int n1, int n2, int nbt, int zblk, int strip, void* stream) {
  const bool f1 = kStages == kF2RepF1 || kStages == kFull || kStages == kDots;
  const int R = 2 * m1 * (kStages == kRep || m2 > n2 ? m2 : n2);
  const size_t smem = (static_cast<size_t>(2) * R + (f1 ? 2 * n1 * strip : 0))
                      * kBands * sizeof(float);
  cudaError_t err = allow_smem(probe_stages_kernel<kStages, kBf16>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nbt / kBands, n3 / zblk);
  probe_stages_kernel<kStages, kBf16><<<grid, kThreads, smem,
                                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const float*>(V),
      static_cast<const float*>(F2f), static_cast<const float*>(F1f),
      static_cast<const float*>(F1b), static_cast<const float*>(F2b),
      static_cast<float*>(out), m1, m2, n1, n2, nbt, zblk, strip, R);
  return static_cast<int>(cudaGetLastError());
}

// out = 0.999 t, one block per `zblk` planes of `plane` floats (a multiple
// of 4), as the TPU grid holds one block per step.  Bound by bytes.
__global__ void __launch_bounds__(kCopyThreads)
probe_copy_kernel(const float4* __restrict__ t, float4* __restrict__ out,
                  const int plane4, const int zblk) {
  const size_t base = static_cast<size_t>(blockIdx.x) * zblk * plane4;
  for (int e = threadIdx.x; e < zblk * plane4; e += blockDim.x) {
    float4 v = t[base + e];
    v.x *= 0.999f; v.y *= 0.999f; v.z *= 0.999f; v.w *= 0.999f;
    out[base + e] = v;
  }
}

}  // namespace

extern "C" {

int dftk_probe_copy(const void* t, void* out, int n3, int plane, int zblk, void* stream) {
  probe_copy_kernel<<<n3 / zblk, kCopyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(t), static_cast<float4*>(out), plane / 4, zblk);
  return static_cast<int>(cudaGetLastError());
}

// stages: a Stages value; bf16: 0 or 1 (kFull only).  Other combinations
// return cudaErrorInvalidValue.
int dftk_probe_stages(const void* t, const void* V, const void* F2f, const void* F1f,
                      const void* F1b, const void* F2b, void* out, int n3, int m1,
                      int m2, int n1, int n2, int nbt, int zblk, int strip, int stages,
                      int bf16, void* stream) {
#define DFTK_STAGES_CASE(S, B)                                                        \
  return launch_stages<S, B>(t, V, F2f, F1f, F1b, F2b, out, n3, m1, m2, n1, n2, nbt, \
                             zblk, strip, stream)
  if (bf16) {
    if (stages == kFull) DFTK_STAGES_CASE(kFull, true);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (stages) {
    case kF2: DFTK_STAGES_CASE(kF2, false);
    case kF2Rep: DFTK_STAGES_CASE(kF2Rep, false);
    case kF2RepF1: DFTK_STAGES_CASE(kF2RepF1, false);
    case kFull: DFTK_STAGES_CASE(kFull, false);
    case kRep: DFTK_STAGES_CASE(kRep, false);
    case kDots: DFTK_STAGES_CASE(kDots, false);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DFTK_STAGES_CASE
}

}  // extern "C"
