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
//   S[j1, j2]   = V[k, z, j1, j2] sum_a1 F1f[a1, j1] T1[a1, j2] (x forward, *V)
//   T1'[a1, j2] = sum_j1 F1b[j1, a1] S[j1, j2]                 (x backward)
//   out[a1, a2] = sum_j2 T1'[a1, j2] F2b[j2, a2]                (y backward)
// Device memory sees the plane in, the plane out and the V plane.
//
// What bounds it on an H100: ~3.1 MFLOP (f64) per plane at the Si54 shapes
// (m = 32, n = 64), 2.8 M complex multiply-adds at Si256 (m = 64, n = 120),
// against 32-128 KB of device traffic: bound by operations, 0.385 ms at
// Si54 on the f64 tensor cores (67 TFLOP/s; DFMA alone tops out near 34).
//
// complex128 (local_plane_c128_kernel): every contraction on the f64 tensor
// cores, mma.sync m8n8k4 (DMMA).  A complex k-step of a warp's 8 x 8 output
// tile is four real MMAs, Cr += Ar Br + (-Ai) Bi, Ci += Ar Bi + Ai Br.
//   * Planar re/im in shared memory: the plane X, the strip buffers and the
//     y factors' slices are de-interleaved as they are loaded, with row
//     pitches of 4 mod 8 doubles so that fragment reads hit distinct banks;
//     every dimension is zero-padded to whole 8 x 8 tiles, so ragged shapes
//     (n = 18, m = 9) take the same path.
//   * Strip-accumulated data flow: for each strip of w y columns,
//       T1s = X F2f[:, strip];  S = (F1f^T T1s) * V[:, strip];
//       T1s' = F1b^T S;         out += T1s' F2b[strip, :]
//     with out [m1, m2] held in registers across strips (each warp owns OC
//     column tiles of one row tile).  No FLOP is repeated; shared memory
//     holds X, one strip of T1s (then T1s') and S, and the strip's slices of
//     F2f and F2b: 108 KB at Si54 with strips of 32, 202 KB at Si256 with
//     strips of 24.
//   * A warp task in the strip contractions is one row tile and G column
//     tiles (4, or 3 where OC = 4 leaves the registers less room), so each
//     A fragment feeds G tiles: a whole strip at Si54 (32) and Si256 (24).
//     F1f and F1b, used whole by every strip, are read as A fragments
//     straight from device memory through L1/L2, four k-steps of loads in
//     flight a warp.
//   * The layout (WARPS, OC) is the caller's: two blocks of 8 warps an SM
//     where their shared memory (<= 113 KB) and the out registers (OC <= 2)
//     allow, as at Si54; else one block of 16 warps, as at Si256 (OC = 4:
//     16 doubles of output a thread).  Planes with more out tiles than 16
//     warps hold take OC = 0: the y backward is a fifth strip contraction
//     that adds each strip's share to the output plane in device memory,
//     each value read and written by the lane that owns it.  The wrapper
//     (local_plane_layout_c128) picks the layout and the strip.
//   * Five barriers a strip.

// complex64 and bf16 (local_plane_kernel, the first design): the whole
// [m1, n2] T1 in shared memory, strips of the x contractions only, each
// output element one thread's dot product over one shared-memory operand
// and one factor read through __ldg; no register blocking or tensor cores.
// The bf16 mode is complex64 data whose operands are rounded to bf16
// before each of the four contractions (the plane and T1 as they are stored
// in shared memory, the potential-multiplied strip, each factor as it is
// read), with f32 accumulation and the V multiply in f32 on the f32 sums:
// the 'default' precision of fused_filter_mid (fused_filter.py:_dot_left,
// :106-113).  The wrapper picks the strip width and refuses a shape whose
// [m1, m2] + [m1, n2] planes alone exceed the 227 KB a block may use.
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

// ---- complex128 -----------------------------------------------------------

constexpr int kAhead = 4;               // k-steps of A fragments loaded ahead

// Launch geometry: true sizes, 8-tile counts, the strip width, and the
// shared-memory row pitches in doubles (each a multiple of 8 plus 4, so the
// eight rows and four columns of a fragment fall on distinct banks).
struct PlaneGeom {
  int m1, m2, n1, n2, strip;
  int m1t, m2t, n1t, wt;
  int px, pw, pm;
};

PlaneGeom plane_geom(int m1, int m2, int n1, int n2, int strip) {
  PlaneGeom g{m1, m2, n1, n2, strip, (m1 + 7) / 8, (m2 + 7) / 8, (n1 + 7) / 8,
              (strip + 7) / 8, 0, 0, 0};
  g.px = 8 * g.m2t + 4;
  g.pw = 8 * g.wt + 4;
  g.pm = 8 * g.m2t + 4;
  return g;
}

// bytes: X, T1s (then T1s') and S, the F2f and F2b slices, each re and im
size_t plane_smem(const PlaneGeom& g) {
  const size_t m1p = 8 * g.m1t, m2p = 8 * g.m2t, n1p = 8 * g.n1t, wp = 8 * g.wt;
  return 2 * sizeof(double) * (m1p * g.px + (m1p + n1p + m2p) * g.pw + wp * g.pm);
}

// One strip contraction C[Mt x Nt tiles] = A[., K] B[K, .] on the f64 tensor
// cores.  B is planar in shared memory (row pitch pb); loadA(r, k0) gives
// (re, im) of the lane's A[8 r + gr][k0 + tg], zero past K.  A warp task is
// one row tile and G column tiles, so each A fragment (read ahead, kAhead
// k-steps at a time) feeds G tiles; store(r, c, acc) takes each finished tile.
template <int WARPS, int G, typename LoadA, typename Store>
__device__ __forceinline__ void strip_gemm(int Mt, int Nt, int K, int warp, int gr, int tg,
                                           LoadA loadA, const double* Br, const double* Bi,
                                           int pb, Store store) {
  const int ngroups = (Nt + G - 1) / G;
  for (int u = warp; u < Mt * ngroups; u += WARPS) {
    const int r = u / ngroups, c0 = (u - r * ngroups) * G;
    const int nc = min(G, Nt - c0);
    double acc[G][2][2] = {};
    for (int kb = 0; kb < K; kb += 4 * kAhead) {
      double2 a[kAhead];
      #pragma unroll
      for (int i = 0; i < kAhead; ++i) a[i] = loadA(r, kb + 4 * i);
      #pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        const int k0 = kb + 4 * i;
        if (k0 < K) {
          #pragma unroll
          for (int c = 0; c < G; ++c) {
            if (c < nc) {
              const int bo = (k0 + tg) * pb + 8 * (c0 + c) + gr;
              cmma(acc[c], a[i], Br[bo], Bi[bo]);
            }
          }
        }
      }
    }
    #pragma unroll
    for (int c = 0; c < G; ++c)
      if (c < nc) store(r, c0 + c, acc[c]);
  }
}

// the lane's two values of a finished tile into planar rows of pitch p
__device__ __forceinline__ void store_tile(double* Cr, double* Ci, int p, int r, int c,
                                           int gr, int tg, const double (&acc)[2][2]) {
  const int o = (8 * r + gr) * p + 8 * c + 2 * tg;
  *reinterpret_cast<double2*>(Cr + o) = make_double2(acc[0][0], acc[0][1]);
  *reinterpret_cast<double2*>(Ci + o) = make_double2(acc[1][0], acc[1][1]);
}

// WARPS = 8 (two blocks an SM) or 16 (one); each warp holds OC out column
// tiles of one row tile (OC = 0: none, the output accumulates in device
// memory), and takes G = 4 column tiles a task where that leaves the
// registers room (OC <= 2), else 3 (a whole strip of 24).
template <int WARPS, int OC>
__global__ void __launch_bounds__(32 * WARPS, 16 / WARPS)
local_plane_c128_kernel(const double2* __restrict__ t, const double* __restrict__ V,
                        const double2* __restrict__ F2f, const double2* __restrict__ F1f,
                        const double2* __restrict__ F1b, const double2* __restrict__ F2b,
                        double2* __restrict__ out, int nb, int n3, PlaneGeom g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m1p = 8 * g.m1t, m2p = 8 * g.m2t, n1p = 8 * g.n1t, wp = 8 * g.wt;
  double* Xr = reinterpret_cast<double*>(smem_raw);   // [m1p][px]  the plane
  double* Xi = Xr + m1p * g.px;
  double* Tr = Xi + m1p * g.px;                        // [m1p][pw]  T1s, then T1s'
  double* Ti = Tr + m1p * g.pw;
  double* Sr = Ti + m1p * g.pw;                        // [n1p][pw]  S
  double* Si = Sr + n1p * g.pw;
  double* Gr = Si + n1p * g.pw;                        // [m2p][pw]  F2f[:, strip]
  double* Gi = Gr + m2p * g.pw;
  double* Hr = Gi + m2p * g.pw;                        // [wp][pm]   F2b[strip, :]
  double* Hi = Hr + wp * g.pm;

  const size_t q = blockIdx.x;                          // plane (k, band, z)
  const size_t k = q / (static_cast<size_t>(nb) * n3);
  const int z = static_cast<int>(q % n3);
  const double2* xin = t + q * g.m1 * g.m2;
  double2* xout = out + q * g.m1 * g.m2;
  const double* Vz = V + (k * n3 + z) * g.n1 * g.n2;

  constexpr int G = OC <= 2 ? 4 : 3;
  constexpr int NO = OC > 0 ? OC : 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;

  for (int e = tid; e < m1p * m2p; e += 32 * WARPS) {
    const int a1 = e / m2p, a2 = e - a1 * m2p;
    const double2 v = a1 < g.m1 && a2 < g.m2 ? xin[a1 * g.m2 + a2] : make_double2(0.0, 0.0);
    Xr[a1 * g.px + a2] = v.x;
    Xi[a1 * g.px + a2] = v.y;
  }

  // the out tiles of this warp: row tile orow, column tiles ocol .. ocol + OC
  const int ngroups = (g.m2t + NO - 1) / NO;
  const bool holds_out = OC > 0 && warp < g.m1t * ngroups;
  const int orow = holds_out ? warp / ngroups : 0;
  const int ocol = holds_out ? (warp - orow * ngroups) * NO : 0;
  double oacc[NO][2][2] = {};

  auto x_frag = [&](int r, int k0) {
    const int o = (8 * r + gr) * g.px + k0 + tg;
    return k0 < m2p ? make_double2(Xr[o], Xi[o]) : make_double2(0.0, 0.0);
  };
  auto f1f_frag = [&](int r, int k0) {     // A[j1][a1] = F1f[a1][j1]
    const int j1 = 8 * r + gr, a1 = k0 + tg;
    return j1 < g.n1 && a1 < g.m1 ? __ldg(F1f + a1 * g.n1 + j1) : make_double2(0.0, 0.0);
  };
  auto f1b_frag = [&](int r, int k0) {     // A[a1][j1] = F1b[j1][a1]
    const int a1 = 8 * r + gr, j1 = k0 + tg;
    return a1 < g.m1 && j1 < g.n1 ? __ldg(F1b + j1 * g.m1 + a1) : make_double2(0.0, 0.0);
  };
  auto to_t1 = [&](int r, int c, const double (&acc)[2][2]) {
    store_tile(Tr, Ti, g.pw, r, c, gr, tg, acc);
  };
  auto t1_frag = [&](int r, int k0) {      // A[a1][jj] = T1s'[a1][jj]
    const int o = (8 * r + gr) * g.pw + k0 + tg;
    return k0 < wp ? make_double2(Tr[o], Ti[o]) : make_double2(0.0, 0.0);
  };

  for (int s0 = 0; s0 < g.n2; s0 += g.strip) {
    const int w = min(g.strip, g.n2 - s0);
    for (int e = tid; e < m2p * wp; e += 32 * WARPS) {
      const int a2 = e / wp, jj = e - a2 * wp;
      const double2 v = a2 < g.m2 && jj < w ? __ldg(F2f + a2 * g.n2 + s0 + jj)
                                            : make_double2(0.0, 0.0);
      Gr[a2 * g.pw + jj] = v.x;
      Gi[a2 * g.pw + jj] = v.y;
    }
    for (int e = tid; e < wp * m2p; e += 32 * WARPS) {
      const int jj = e / m2p, a2 = e - jj * m2p;
      const double2 v = jj < w && a2 < g.m2 ? __ldg(F2b + (s0 + jj) * g.m2 + a2)
                                            : make_double2(0.0, 0.0);
      Hr[jj * g.pm + a2] = v.x;
      Hi[jj * g.pm + a2] = v.y;
    }
    __syncthreads();
    // y forward: T1s = X F2f[:, strip]
    strip_gemm<WARPS, G>(g.m1t, g.wt, m2p, warp, gr, tg, x_frag, Gr, Gi, g.pw, to_t1);
    __syncthreads();
    // x forward and the potential: S = (F1f^T T1s) * V[:, strip]
    strip_gemm<WARPS, G>(g.n1t, g.wt, m1p, warp, gr, tg, f1f_frag, Tr, Ti, g.pw,
               [&](int r, int c, const double (&acc)[2][2]) {
      const int j1 = 8 * r + gr, jj = 8 * c + 2 * tg;
      double v[2];
      #pragma unroll
      for (int i = 0; i < 2; ++i)
        v[i] = j1 < g.n1 && jj + i < w ? __ldg(Vz + j1 * g.n2 + s0 + jj + i) : 0.0;
      const double scaled[2][2] = {{acc[0][0] * v[0], acc[0][1] * v[1]},
                                   {acc[1][0] * v[0], acc[1][1] * v[1]}};
      store_tile(Sr, Si, g.pw, r, c, gr, tg, scaled);
    });
    __syncthreads();
    // x backward: T1s' = F1b^T S, over T1s (read in full before the barrier)
    strip_gemm<WARPS, G>(g.m1t, g.wt, n1p, warp, gr, tg, f1b_frag, Sr, Si, g.pw, to_t1);
    __syncthreads();
    // y backward: out += T1s' F2b[strip, :]
    if (OC == 0) {
      const bool first = s0 == 0;
      strip_gemm<WARPS, G>(g.m1t, g.m2t, wp, warp, gr, tg, t1_frag, Hr, Hi, g.pm,
                 [&](int r, int c, const double (&acc)[2][2]) {
        const int a1 = 8 * r + gr;
        #pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int a2 = 8 * c + 2 * tg + i;
          if (a1 < g.m1 && a2 < g.m2) {
            double2* o = xout + a1 * g.m2 + a2;
            const double2 prev = first ? make_double2(0.0, 0.0) : *o;
            *o = make_double2(prev.x + acc[0][i], prev.y + acc[1][i]);
          }
        }
      });
    } else if (holds_out) {
      for (int k0 = 0; k0 < wp; k0 += 4) {
        const int ao = (8 * orow + gr) * g.pw + k0 + tg;
        const double2 a = make_double2(Tr[ao], Ti[ao]);
        #pragma unroll
        for (int o = 0; o < OC; ++o) {
          if (ocol + o < g.m2t) {
            const int bo = (k0 + tg) * g.pm + 8 * (ocol + o) + gr;
            cmma(oacc[o], a, Hr[bo], Hi[bo]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (holds_out) {
    #pragma unroll
    for (int o = 0; o < OC; ++o) {
      const int a1 = 8 * orow + gr;
      #pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int a2 = 8 * (ocol + o) + 2 * tg + i;
        if (ocol + o < g.m2t && a1 < g.m1 && a2 < g.m2)
          xout[a1 * g.m2 + a2] = make_double2(oacc[o][0][i], oacc[o][1][i]);
      }
    }
  }
}

template <int WARPS, int OC>
cudaError_t launch_plane_c128_as(const PlaneGeom& g, size_t smem, unsigned int planes,
                                 const double2* t, const double* V, const double2* F2f,
                                 const double2* F1f, const double2* F1b, const double2* F2b,
                                 double2* out, int nb, int n3, cudaStream_t s) {
  if (OC > 0 && g.m1t * ((g.m2t + OC - 1) / OC) > WARPS) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(local_plane_c128_kernel<WARPS, OC>, smem);
  if (err != cudaSuccess) return err;
  local_plane_c128_kernel<WARPS, OC><<<planes, 32 * WARPS, smem, s>>>(t, V, F2f, F1f, F1b,
                                                                       F2b, out, nb, n3, g);
  return cudaGetLastError();
}

int launch_local_plane_c128(const void* t, const void* V, const void* F2f, const void* F1f,
                            const void* F1b, const void* F2b, void* out, int nk, int nb,
                            int n3, int m1, int m2, int n1, int n2, int strip, int warps,
                            int oc, void* stream) {
  const PlaneGeom g = plane_geom(m1, m2, n1, n2, strip);
  const size_t smem = plane_smem(g);
  const unsigned int planes = static_cast<unsigned int>(nk) * nb * n3;
  const auto* x = static_cast<const double2*>(t);
  const auto* v = static_cast<const double*>(V);
  const auto* f2f = static_cast<const double2*>(F2f);
  const auto* f1f = static_cast<const double2*>(F1f);
  const auto* f1b = static_cast<const double2*>(F1b);
  const auto* f2b = static_cast<const double2*>(F2b);
  auto* y = static_cast<double2*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
#define DFTK_PLANE_LAYOUT(W, O)                                                        \
  if (warps == W && oc == O)                                                          \
    return static_cast<int>(launch_plane_c128_as<W, O>(g, smem, planes, x, v, f2f, f1f, \
                                                       f1b, f2b, y, nb, n3, s));
  DFTK_PLANE_LAYOUT(8, 1)
  DFTK_PLANE_LAYOUT(8, 2)
  DFTK_PLANE_LAYOUT(16, 1)
  DFTK_PLANE_LAYOUT(16, 2)
  DFTK_PLANE_LAYOUT(16, 4)
  DFTK_PLANE_LAYOUT(16, 0)
#undef DFTK_PLANE_LAYOUT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// warps and oc: the block layout, one of the six launch_local_plane_c128
// instantiates (local_apply.py::_PLANE_LAYOUTS_C128)
int dftk_local_plane_c128(const void* t, const void* V, const void* F2f,
                          const void* F1f, const void* F1b, const void* F2b,
                          void* out, int nk, int nb, int n3, int m1, int m2,
                          int n1, int n2, int strip, int warps, int oc, void* stream) {
  return launch_local_plane_c128(t, V, F2f, F1f, F1b, F2b, out, nk, nb, n3, m1, m2, n1, n2,
                                 strip, warps, oc, stream);
}

// shared memory of one block at these plane sizes and strip width
int dftk_local_plane_c128_smem(int m1, int m2, int n1, int strip) {
  return static_cast<int>(plane_smem(plane_geom(m1, m2, n1, 1, strip)));
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
