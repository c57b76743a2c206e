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

// bf16 (local_plane_bf16_kernel): the 'default' precision of
// dftk_tpu/kernels/fused_filter.py::fused_filter_mid (_dot_left, :106-113)
// on the bf16 tensor cores, mma.sync m16n8k16 (HMMA) with f32 sums.  Every operand of every
// complex product is rounded to bf16 once, as it is stored: the plane X as
// it is loaded, T1s, S (after the V multiply in f32 on the f32 sums) and
// T1s' as their tiles are written to shared memory, the four factors by the
// wrapper (round_bf16's rounding, kept per factor tensor); the output is the
// f32 sum, not rounded.  A complex k-step of a 16 x 8 tile is four real
// MMAs, Cr += Ar Br + (-Ai) Bi, Ci += Ar Bi + Ai Br (negating a bf16 is
// exact).
//   What bounds it on an H100: 3.1 MFLOP a plane at Si54 (m 32, n 64),
//   25.8 GFLOP for 128 bands, against 134 MB of complex64 planes in and
//   out: bound by bytes, 0.040 ms (0.026 by operations at 989 TFLOP/s).
//   At Si256 (m 64, n 120) a 256-band chunk is 371 GFLOP: bound by
//   operations, 0.375 ms (bytes 0.32).
//   * Same strip-accumulated data flow as complex128: for each strip of w
//     y columns T1s = X F2f[:, strip], S = (F1f^T T1s) * V[:, strip],
//     T1s' = F1b^T S, out += T1s' F2b[strip, :], the output [m1, m2] held
//     in f32 registers across strips (each warp OC column tiles of 8 of one
//     row tile of 16; OC = 0 where 8 warps x 4 do not hold it: the y
//     backward is then a fifth strip contraction adding into the output in
//     device memory).
//   * Planar bf16 tiles in shared memory (X, one strip of T1s and then
//     T1s', S), every dimension zero-padded to 16, rows padded by 8 bf16 so
//     that ldmatrix's eight 16-byte rows fall on distinct banks: half the
//     complex64 bytes.  The smem-side operand of each contraction comes
//     through ldmatrix (.trans for T1s and S as B).
//   * The factors come pre-rounded and pre-packed in fragment order
//     (kernels/local_apply.py: F1f^T and F1b^T as A fragments, F2f and F2b
//     per strip as B fragments), one coalesced 16-byte load a lane and part
//     per fragment, L1/L2-resident: no shared memory and no rounding for
//     them in the kernel.
//   * A warp task is one row tile of 16 and G column tiles of 8 (4, or 2
//     where 4 leave warps idle), so each A fragment feeds G tiles.  One
//     block of 8 warps a plane; the wrapper picks the widest strip with
//     which two blocks share an SM (all of n2 = 64 at Si54, 64 at Si256).
//   * Four barriers a strip.
//   ptxas: 126-128 registers; OC = 4 (the Si256 layout) spills 88 bytes,
//   OC = 2 4 bytes, OC = 1 (Si54) and 0 none.

// complex64 (local_plane_kernel, the first design, which now serves
// complex64 only): the whole [m1, n2] T1 in shared memory, strips of the x
// contractions only, each output element one thread's dot product over one
// shared-memory operand and one factor read through __ldg; no register
// blocking or tensor cores.  The wrapper picks the strip width and refuses
// a shape whose [m1, m2] + [m1, n2] planes alone exceed the 227 KB a block
// may use.
#include "dftk_complex.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
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
    Xs[e] = xin[e];
  __syncthreads();

  // y forward: T1[a1, j2] = sum_a2 Xs[a1, a2] F2f[a2, j2]
  for (int e = threadIdx.x; e < m1 * n2; e += blockDim.x) {
    const int a1 = e / n2, j2 = e - a1 * n2;
    cplx<T> acc{0, 0};
    for (int a2 = 0; a2 < m2; ++a2)
      cfma(acc, Xs[a1 * m2 + a2], ldg(F2f + a2 * n2 + j2));
    T1[e] = acc;
  }
  __syncthreads();

  for (int s0 = 0; s0 < n2; s0 += strip) {
    const int w = min(strip, n2 - s0);
    // x forward and the potential: Sb[j1, jj]
    for (int e = threadIdx.x; e < n1 * w; e += blockDim.x) {
      const int j1 = e / w, jj = e - j1 * w;
      cplx<T> acc{0, 0};
      for (int a1 = 0; a1 < m1; ++a1)
        cfma(acc, ldg(F1f + a1 * n1 + j1), T1[a1 * n2 + s0 + jj]);
      const T v = ldg(Vz + j1 * n2 + s0 + jj);
      Sb[j1 * strip + jj] = cplx<T>{acc.re * v, acc.im * v};
    }
    __syncthreads();
    // x backward into the strip's columns of T1 (their forward is done)
    for (int e = threadIdx.x; e < m1 * w; e += blockDim.x) {
      const int a1 = e / w, jj = e - a1 * w;
      cplx<T> acc{0, 0};
      for (int j1 = 0; j1 < n1; ++j1)
        cfma(acc, ldg(F1b + j1 * m1 + a1), Sb[j1 * strip + jj]);
      T1[a1 * n2 + s0 + jj] = acc;
    }
    __syncthreads();
  }

  // y backward: out[a1, a2] = sum_j2 T1[a1, j2] F2b[j2, a2]
  for (int e = threadIdx.x; e < m1 * m2; e += blockDim.x) {
    const int a1 = e / m2, a2 = e - a1 * m2;
    cplx<T> acc{0, 0};
    for (int j2 = 0; j2 < n2; ++j2)
      cfma(acc, T1[a1 * n2 + j2], ldg(F2b + j2 * m2 + a2));
    xout[e] = acc;
  }
}

template <typename T>
int launch_local_plane(const void* t, const void* V, const void* F2f,
                       const void* F1f, const void* F1b, const void* F2b,
                       void* out, int nk, int nb, int n3, int m1, int m2,
                       int n1, int n2, int strip, void* stream) {
  const size_t smem = (static_cast<size_t>(m1) * m2 + static_cast<size_t>(m1) * n2
                       + static_cast<size_t>(n1) * strip) * sizeof(cplx<T>);
  cudaError_t err = allow_smem(local_plane_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int planes = static_cast<unsigned int>(nk) * nb * n3;
  local_plane_kernel<T><<<planes, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
    if constexpr (OC == 0) {
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

// ---- bf16 -----------------------------------------------------------------

constexpr int kBf16Warps = 8;
constexpr size_t kSmemMax = 232448;   // the most dynamic shared memory a block may use

// Launch geometry: true sizes, 16-tile counts, the strip width, and the
// shared row pitches in bf16 (16-tiles + 8: a row is an odd number of
// 16-byte units, so ldmatrix's eight rows fall on distinct banks).
struct PlaneBf16Geom {
  int m1, m2, n1, n2, strip;
  int m1t, m2t, n1t, wt;
  int px, pw;
};

PlaneBf16Geom plane_bf16_geom(int m1, int m2, int n1, int n2, int strip) {
  PlaneBf16Geom g{m1, m2, n1, n2, strip, (m1 + 15) / 16, (m2 + 15) / 16, (n1 + 15) / 16,
                  (strip + 15) / 16, 0, 0};
  g.px = 16 * g.m2t + 8;
  g.pw = 16 * g.wt + 8;
  return g;
}

// bytes: X [m1p][px], T1s [m1p][pw] and S [n1p][pw], each re and im
size_t plane_bf16_smem(const PlaneBf16Geom& g) {
  const size_t m1p = 16 * g.m1t, n1p = 16 * g.n1t;
  return 2 * sizeof(__nv_bfloat16) * (m1p * g.px + (m1p + n1p) * g.pw);
}

// out column tiles of 8 a warp holds in registers: the fewest of 1, 2, 4
// with which 8 warps hold the [m1, m2] output, else 0 (device memory)
int plane_bf16_oc(int m1, int m2) {
  const int m1t = (m1 + 15) / 16, m2n = 2 * ((m2 + 15) / 16);
  for (int oc = 1; oc <= 4; oc *= 2)
    if (m1t * ((m2n + oc - 1) / oc) <= kBf16Warps) return oc;
  return 0;
}

// One strip contraction C[Mt x Nt tiles of 16 x 8] = A[., Kt k-steps of 16]
// B on the bf16 tensor cores.  loadA(mt, ks, a) gives a complex A fragment,
// loadB(nt, ks, b0, b1) the B fragments of column tiles nt and nt + 1 (Nt
// is even); a warp task is one row tile and G column tiles, and
// store(mt, nt, acc) takes each finished tile.
template <int G, typename LoadA, typename LoadB, typename Store>
__device__ __forceinline__ void strip_hmma(int Mt, int Nt, int Kt, int warp, LoadA loadA,
                                           LoadB loadB, Store store) {
  const int ngroups = (Nt + G - 1) / G;
  for (int u = warp; u < Mt * ngroups; u += kBf16Warps) {
    const int mt = u / ngroups, n0 = (u - mt * ngroups) * G;
    float acc[G][2][4] = {};
    for (int ks = 0; ks < Kt; ++ks) {
      CFragA a;
      loadA(mt, ks, a);
      a.negate();
      uint4 b[G];
      #pragma unroll
      for (int c = 0; c < G; c += 2)
        if (n0 + c < Nt) loadB(n0 + c, ks, b[c], b[c + 1]);
      #pragma unroll
      for (int c = 0; c < G; ++c)
        if (n0 + c < Nt) chmma(acc[c], a, b[c]);
    }
    #pragma unroll
    for (int c = 0; c < G; ++c)
      if (n0 + c < Nt) store(mt, n0 + c, acc[c]);
  }
}

// The packed factors (kernels/local_apply.py::_pack_a, _pack_b): A
// fragments [Mt][Kt][re, im][32 lanes] and B fragments [Nt][Kt][32 lanes]
// of uint4; P2f [strips][2 wt][m2t][32] and P2b [strips][2 m2t][wt][32] per
// strip of the wrapper's width.
template <int OC>
__global__ void __launch_bounds__(32 * kBf16Warps, 2)
local_plane_bf16_kernel(const float2* __restrict__ t, const float* __restrict__ V,
                        const uint4* __restrict__ P2f, const uint4* __restrict__ P1f,
                        const uint4* __restrict__ P1b, const uint4* __restrict__ P2b,
                        float2* __restrict__ out, int nb, int n3, PlaneBf16Geom g,
                        bool pairs) {
  using u16 = unsigned short;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m1p = 16 * g.m1t, n1p = 16 * g.n1t;
  u16* Xr = reinterpret_cast<u16*>(smem_raw);   // [m1p][px]  the plane
  u16* Xi = Xr + m1p * g.px;
  u16* Tr = Xi + m1p * g.px;                     // [m1p][pw]  T1s, then T1s'
  u16* Ti = Tr + m1p * g.pw;
  u16* Sr = Ti + m1p * g.pw;                     // [n1p][pw]  S
  u16* Si = Sr + n1p * g.pw;

  const size_t q = blockIdx.x;                   // plane (k, band, z)
  const size_t k = q / (static_cast<size_t>(nb) * n3);
  const int z = static_cast<int>(q % n3);
  const float2* xin = t + q * g.m1 * g.m2;
  float2* xout = out + q * g.m1 * g.m2;
  const float* Vz = V + (k * n3 + z) * g.n1 * g.n2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tg = lane & 3;

  // the plane, rounded, planar, zero past m1 and m2; pairs along a2 (one
  // 16-byte load where m2 is even and the plane aligned)
  const int hp = 8 * g.m2t;
  for (int e = tid; e < m1p * hp; e += 32 * kBf16Warps) {
    const int a1 = e / hp, a2 = 2 * (e - a1 * hp);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (a1 < g.m1 && a2 < g.m2) {
      const float2* src = xin + a1 * g.m2 + a2;
      if (pairs) {
        v = *reinterpret_cast<const float4*>(src);
      } else {
        const float2 v0 = src[0];
        const float2 v1 = a2 + 1 < g.m2 ? src[1] : make_float2(0.f, 0.f);
        v = make_float4(v0.x, v0.y, v1.x, v1.y);
      }
    }
    *reinterpret_cast<unsigned*>(Xr + a1 * g.px + a2) = pack_bf16(v.x, v.z);
    *reinterpret_cast<unsigned*>(Xi + a1 * g.px + a2) = pack_bf16(v.y, v.w);
  }

  // the out tiles of this warp: row tile orow, column tiles ocol .. ocol + OC
  constexpr int NO = OC > 0 ? OC : 1;
  const int m2n = 2 * g.m2t;
  const int ogroups = (m2n + NO - 1) / NO;
  const bool holds_out = OC > 0 && warp < g.m1t * ogroups;
  const int orow = holds_out ? warp / ogroups : 0;
  const int ocol = holds_out ? (warp - orow * ogroups) * NO : 0;
  float oacc[NO][2][4] = {};

  // A from planar rows of pitch p (row tile mt, k-step ks)
  auto lds_a = [&](const u16* R, const u16* I, int p, int mt, int ks, CFragA& a) {
    const int o = (16 * mt + (lane & 15)) * p + 16 * ks + 8 * (lane >> 4);
    ldsm4(a.re, R + o);
    ldsm4(a.im, I + o);
  };
  // B from planar [k][pitch p] rows: column tiles nt, nt + 1
  auto lds_b = [&](const u16* R, const u16* I, int p, int nt, int ks, uint4& b0, uint4& b1) {
    const int o = (16 * ks + (lane & 7) + 8 * ((lane >> 3) & 1)) * p + 8 * (nt + (lane >> 4));
    unsigned r[4], i[4];
    ldsm4t(r, R + o);
    ldsm4t(i, I + o);
    b0 = make_uint4(r[0], r[1], i[0], i[1]);
    b1 = make_uint4(r[2], r[3], i[2], i[3]);
  };
  auto ldg_a = [&](const uint4* Pk, int Kt, int mt, int ks, CFragA& a) {
    const uint4* f = Pk + static_cast<size_t>((mt * Kt + ks) * 2) * 32 + lane;
    const uint4 r = __ldg(f), i = __ldg(f + 32);
    a.re[0] = r.x; a.re[1] = r.y; a.re[2] = r.z; a.re[3] = r.w;
    a.im[0] = i.x; a.im[1] = i.y; a.im[2] = i.z; a.im[3] = i.w;
  };
  auto ldg_b = [&](const uint4* Pk, int Kt, int nt, int ks) {
    return __ldg(Pk + static_cast<size_t>(nt * Kt + ks) * 32 + lane);
  };
  // a finished tile, rounded to bf16, into planar rows of pitch p
  auto sts_c = [&](u16* R, u16* I, int p, int mt, int nt, const float (&acc)[2][4]) {
    const int o = (16 * mt + gr) * p + 8 * nt + 2 * tg;
    *reinterpret_cast<unsigned*>(R + o) = pack_bf16(acc[0][0], acc[0][1]);
    *reinterpret_cast<unsigned*>(R + o + 8 * p) = pack_bf16(acc[0][2], acc[0][3]);
    *reinterpret_cast<unsigned*>(I + o) = pack_bf16(acc[1][0], acc[1][1]);
    *reinterpret_cast<unsigned*>(I + o + 8 * p) = pack_bf16(acc[1][2], acc[1][3]);
  };
  auto run = [&](int Mt, int Nt, int Kt, auto loadA, auto loadB, auto store) {
    if (Mt * ((Nt + 3) / 4) >= kBf16Warps)
      strip_hmma<4>(Mt, Nt, Kt, warp, loadA, loadB, store);
    else
      strip_hmma<2>(Mt, Nt, Kt, warp, loadA, loadB, store);
  };

  const int nst = (g.n2 + g.strip - 1) / g.strip;
  for (int s = 0; s < nst; ++s) {
    const int s0 = s * g.strip, w = min(g.strip, g.n2 - s0);
    const int wts = (w + 15) / 16, Nt = 2 * wts;
    const uint4* p2f = P2f + static_cast<size_t>(s) * 2 * g.wt * g.m2t * 32;
    const uint4* p2b = P2b + static_cast<size_t>(s) * m2n * g.wt * 32;
    __syncthreads();
    // y forward: T1s = X F2f[:, strip]
    run(g.m1t, Nt, g.m2t,
        [&](int mt, int ks, CFragA& a) { lds_a(Xr, Xi, g.px, mt, ks, a); },
        [&](int nt, int ks, uint4& b0, uint4& b1) {
          b0 = ldg_b(p2f, g.m2t, nt, ks);
          b1 = ldg_b(p2f, g.m2t, nt + 1, ks);
        },
        [&](int mt, int nt, const float (&acc)[2][4]) { sts_c(Tr, Ti, g.pw, mt, nt, acc); });
    __syncthreads();
    // x forward and the potential: S = (F1f^T T1s) * V[:, strip], the V
    // multiply in f32 on the f32 sums, then rounded
    run(g.n1t, Nt, g.m1t,
        [&](int mt, int ks, CFragA& a) { ldg_a(P1f, g.m1t, mt, ks, a); },
        [&](int nt, int ks, uint4& b0, uint4& b1) { lds_b(Tr, Ti, g.pw, nt, ks, b0, b1); },
        [&](int mt, int nt, const float (&acc)[2][4]) {
          float sc[2][4];
          #pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j1 = 16 * mt + gr + 8 * (i >> 1), jj = 8 * nt + 2 * tg + (i & 1);
            const float v = j1 < g.n1 && jj < w ? __ldg(Vz + j1 * g.n2 + s0 + jj) : 0.f;
            sc[0][i] = acc[0][i] * v;
            sc[1][i] = acc[1][i] * v;
          }
          sts_c(Sr, Si, g.pw, mt, nt, sc);
        });
    __syncthreads();
    // x backward: T1s' = F1b^T S, over T1s (read in full before the barrier)
    run(g.m1t, Nt, g.n1t,
        [&](int mt, int ks, CFragA& a) { ldg_a(P1b, g.n1t, mt, ks, a); },
        [&](int nt, int ks, uint4& b0, uint4& b1) { lds_b(Sr, Si, g.pw, nt, ks, b0, b1); },
        [&](int mt, int nt, const float (&acc)[2][4]) { sts_c(Tr, Ti, g.pw, mt, nt, acc); });
    __syncthreads();
    // y backward: out += T1s' F2b[strip, :]
    if constexpr (OC == 0) {
      const bool first = s == 0;
      run(g.m1t, m2n, wts,
          [&](int mt, int ks, CFragA& a) { lds_a(Tr, Ti, g.pw, mt, ks, a); },
          [&](int nt, int ks, uint4& b0, uint4& b1) {
            b0 = ldg_b(p2b, g.wt, nt, ks);
            b1 = ldg_b(p2b, g.wt, nt + 1, ks);
          },
          [&](int mt, int nt, const float (&acc)[2][4]) {
            #pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int a1 = 16 * mt + gr + 8 * (i >> 1), a2 = 8 * nt + 2 * tg + (i & 1);
              if (a1 < g.m1 && a2 < g.m2) {
                float2* o = xout + a1 * g.m2 + a2;
                const float2 prev = first ? make_float2(0.f, 0.f) : *o;
                *o = make_float2(prev.x + acc[0][i], prev.y + acc[1][i]);
              }
            }
          });
    } else {
      for (int ks = 0; holds_out && ks < wts; ++ks) {
        CFragA a;
        lds_a(Tr, Ti, g.pw, orow, ks, a);
        a.negate();
        #pragma unroll
        for (int o = 0; o < NO; ++o)
          if (ocol + o < m2n) chmma(oacc[o], a, ldg_b(p2b, g.wt, ocol + o, ks));
      }
    }
  }

  if (holds_out) {
    #pragma unroll
    for (int o = 0; o < NO; ++o) {
      #pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int a1 = 16 * orow + gr + 8 * h, a2 = 8 * (ocol + o) + 2 * tg;
        if (ocol + o < m2n && a1 < g.m1 && a2 < g.m2) {
          float2* o2 = xout + a1 * g.m2 + a2;
          const float2 v0 = make_float2(oacc[o][0][2 * h], oacc[o][1][2 * h]);
          const float2 v1 = make_float2(oacc[o][0][2 * h + 1], oacc[o][1][2 * h + 1]);
          if (pairs) {
            *reinterpret_cast<float4*>(o2) = make_float4(v0.x, v0.y, v1.x, v1.y);
          } else {
            o2[0] = v0;
            if (a2 + 1 < g.m2) o2[1] = v1;
          }
        }
      }
    }
  }
}

template <int OC>
cudaError_t launch_plane_bf16_as(const PlaneBf16Geom& g, size_t smem, unsigned int planes,
                                 const float2* t, const float* V, const uint4* P2f,
                                 const uint4* P1f, const uint4* P1b, const uint4* P2b,
                                 float2* out, int nb, int n3, bool pairs, cudaStream_t s) {
  cudaError_t err = allow_smem(local_plane_bf16_kernel<OC>, smem);
  if (err != cudaSuccess) return err;
  local_plane_bf16_kernel<OC><<<planes, 32 * kBf16Warps, smem, s>>>(t, V, P2f, P1f, P1b, P2b,
                                                                    out, nb, n3, g, pairs);
  return cudaGetLastError();
}

int launch_local_plane_bf16(const void* t, const void* V, const void* P2f, const void* P1f,
                            const void* P1b, const void* P2b, void* out, int nk, int nb,
                            int n3, int m1, int m2, int n1, int n2, int strip, void* stream) {
  if (strip < 1 || strip > n2) return static_cast<int>(cudaErrorInvalidValue);
  const PlaneBf16Geom g = plane_bf16_geom(m1, m2, n1, n2, strip);
  const size_t smem = plane_bf16_smem(g);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int planes = static_cast<unsigned int>(nk) * nb * n3;
  // 16-byte plane loads and stores: m2 even and both planes aligned
  const bool pairs = m2 % 2 == 0 && reinterpret_cast<size_t>(t) % 16 == 0
                     && reinterpret_cast<size_t>(out) % 16 == 0;
  const auto* x = static_cast<const float2*>(t);
  const auto* v = static_cast<const float*>(V);
  const auto* p2f = static_cast<const uint4*>(P2f);
  const auto* p1f = static_cast<const uint4*>(P1f);
  const auto* p1b = static_cast<const uint4*>(P1b);
  const auto* p2b = static_cast<const uint4*>(P2b);
  auto* y = static_cast<float2*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (plane_bf16_oc(m1, m2)) {
    case 1: err = launch_plane_bf16_as<1>(g, smem, planes, x, v, p2f, p1f, p1b, p2b, y, nb, n3, pairs, s); break;
    case 2: err = launch_plane_bf16_as<2>(g, smem, planes, x, v, p2f, p1f, p1b, p2b, y, nb, n3, pairs, s); break;
    case 4: err = launch_plane_bf16_as<4>(g, smem, planes, x, v, p2f, p1f, p1b, p2b, y, nb, n3, pairs, s); break;
    default: err = launch_plane_bf16_as<0>(g, smem, planes, x, v, p2f, p1f, p1b, p2b, y, nb, n3, pairs, s);
  }
  return static_cast<int>(err);
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
  return launch_local_plane<float>(t, V, F2f, F1f, F1b, F2b, out, nk, nb, n3,
                                   m1, m2, n1, n2, strip, stream);
}

// P2f, P1f, P1b, P2b: the factors rounded to bf16 and packed in fragment
// order (kernels/local_apply.py::bf16_plane_packs) for this strip width
int dftk_local_plane_bf16(const void* t, const void* V, const void* P2f,
                          const void* P1f, const void* P1b, const void* P2b,
                          void* out, int nk, int nb, int n3, int m1, int m2,
                          int n1, int n2, int strip, void* stream) {
  return launch_local_plane_bf16(t, V, P2f, P1f, P1b, P2b, out, nk, nb, n3, m1, m2, n1, n2,
                                 strip, stream);
}

// shared memory of one bf16 block at these plane sizes and strip width
int dftk_local_plane_bf16_smem(int m1, int m2, int n1, int strip) {
  return static_cast<int>(plane_bf16_smem(plane_bf16_geom(m1, m2, n1, 1, strip)));
}

// out column tiles a warp of the bf16 kernel holds (0: device memory)
int dftk_local_plane_bf16_oc(int m1, int m2) { return plane_bf16_oc(m1, m2); }

}  // extern "C"
