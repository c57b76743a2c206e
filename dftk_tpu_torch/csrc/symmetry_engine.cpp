// Native symmetry engine: crystal space-group operation detection.
//
// The TPU-native replacement for the reference's spglib dependency
// (SURVEY.md section 2.10): detection runs once at setup on the host, but
// for large supercells the candidate-triple enumeration and the per-W
// translation search are O(n_cand^3 + n_ops * n_atoms^2) and dominate
// Python setup time.  This C++ core is loaded through ctypes
// (dftk_tpu/utils/native.py) with a pure-numpy fallback.
//
// Algorithm (same mathematical content as dftk_tpu/symmetry.py):
//   1. lattice point group: integer matrices W with W^T M W = M
//      (M = A^T A the metric), candidate columns = integer vectors of the
//      right length within a geometric search box
//   2. for each W, translations w with  W a_i + w  a permutation of atoms
//      of the same species (checked mod 1 within tolerance)
//
// C ABI: everything as flat double/int arrays; caller owns all buffers.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  double x[3];
};

inline double dot3(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// metric product c1^T M c2 for integer vectors
inline double metric(const double M[9], const int* c1, const int* c2) {
  double out = 0.0;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out += c1[i] * M[3 * i + j] * c2[j];
  return out;
}

inline int idet3(const int W[9]) {
  return W[0] * (W[4] * W[8] - W[5] * W[7]) -
         W[1] * (W[3] * W[8] - W[5] * W[6]) +
         W[2] * (W[3] * W[7] - W[4] * W[6]);
}

}  // namespace

extern "C" {

// Find the lattice point group of the lattice A (columns = vectors).
// out_W: buffer for max_ops * 9 ints.  Returns the number of ops found
// (or -1 if the buffer was too small).
int lattice_point_group(const double* lattice, double tol, int bound,
                        int* out_W, int max_ops) {
  double M[9];
  // M = A^T A
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += lattice[3 * k + i] * lattice[3 * k + j];
      M[3 * i + j] = s;
    }
  double norms[3] = {std::sqrt(M[0]), std::sqrt(M[4]), std::sqrt(M[8])};
  double nmax = std::max(norms[0], std::max(norms[1], norms[2]));
  double reltol = tol * nmax;

  // candidate integer vectors per basis direction: same metric length
  std::vector<std::vector<int>> cands[3];
  for (int d = 0; d < 3; ++d) {
    for (int i = -bound; i <= bound; ++i)
      for (int j = -bound; j <= bound; ++j)
        for (int k = -bound; k <= bound; ++k) {
          int c[3] = {i, j, k};
          double len = std::sqrt(std::max(metric(M, c, c), 0.0));
          if (std::fabs(len - norms[d]) < 10 * reltol + tol)
            cands[d].push_back({i, j, k});
        }
  }

  int n_ops = 0;
  double mmax = 0;
  for (int i = 0; i < 9; ++i) mmax = std::max(mmax, std::fabs(M[i]));
  const double mtol = 20 * reltol * mmax + tol;

  for (const auto& c1 : cands[0]) {
    for (const auto& c2 : cands[1]) {
      if (std::fabs(metric(M, c1.data(), c2.data()) - M[1]) > mtol) continue;
      for (const auto& c3 : cands[2]) {
        if (std::fabs(metric(M, c1.data(), c3.data()) - M[2]) > mtol) continue;
        if (std::fabs(metric(M, c2.data(), c3.data()) - M[5]) > mtol) continue;
        int W[9] = {c1[0], c2[0], c3[0], c1[1], c2[1], c3[1],
                    c1[2], c2[2], c3[2]};
        int det = idet3(W);
        if (det != 1 && det != -1) continue;
        if (n_ops >= max_ops) return -1;
        std::memcpy(out_W + 9 * n_ops, W, 9 * sizeof(int));
        ++n_ops;
      }
    }
  }
  return n_ops;
}

// Given the point group (n_W ops), find all space-group ops (W, w).
// types: species index per atom; positions: fractional [n_atoms*3].
// out_W: max_ops*9 ints; out_w: max_ops*3 doubles.  Returns count (-1 on
// overflow).
int crystal_symmetries(const double* positions, const int* types, int n_atoms,
                       const int* Ws, int n_W, double tol, int* out_W,
                       double* out_w, int max_ops) {
  if (n_atoms == 0) return 0;
  // anchor species: the least frequent one
  int max_type = 0;
  for (int i = 0; i < n_atoms; ++i) max_type = std::max(max_type, types[i]);
  std::vector<int> count(max_type + 1, 0);
  for (int i = 0; i < n_atoms; ++i) count[types[i]]++;
  int anchor_type = 0, best = 1 << 30;
  for (int t = 0; t <= max_type; ++t)
    if (count[t] > 0 && count[t] < best) { best = count[t]; anchor_type = t; }
  int a0 = -1;
  for (int i = 0; i < n_atoms; ++i)
    if (types[i] == anchor_type) { a0 = i; break; }

  int n_ops = 0;
  for (int iw = 0; iw < n_W; ++iw) {
    const int* W = Ws + 9 * iw;
    double Wa0[3];
    for (int r = 0; r < 3; ++r)
      Wa0[r] = W[3 * r] * positions[3 * a0] +
               W[3 * r + 1] * positions[3 * a0 + 1] +
               W[3 * r + 2] * positions[3 * a0 + 2];
    for (int j = 0; j < n_atoms; ++j) {
      if (types[j] != anchor_type) continue;
      double w[3];
      for (int r = 0; r < 3; ++r) {
        w[r] = positions[3 * j + r] - Wa0[r];
        w[r] -= std::floor(w[r]);              // mod 1
      }
      // check (W, w) maps every atom onto one of the same species
      bool ok = true;
      for (int i = 0; i < n_atoms && ok; ++i) {
        double mapped[3];
        for (int r = 0; r < 3; ++r)
          mapped[r] = W[3 * r] * positions[3 * i] +
                      W[3 * r + 1] * positions[3 * i + 1] +
                      W[3 * r + 2] * positions[3 * i + 2] + w[r];
        bool found = false;
        for (int t = 0; t < n_atoms && !found; ++t) {
          if (types[t] != types[i]) continue;
          double dmax = 0;
          for (int r = 0; r < 3; ++r) {
            double d = mapped[r] - positions[3 * t + r];
            d -= std::round(d);
            dmax = std::max(dmax, std::fabs(d));
          }
          if (dmax < 10 * tol) found = true;
        }
        ok = found;
      }
      if (!ok) continue;
      // deduplicate
      bool dup = false;
      for (int q = 0; q < n_ops && !dup; ++q) {
        if (std::memcmp(out_W + 9 * q, W, 9 * sizeof(int)) != 0) continue;
        double dmax = 0;
        for (int r = 0; r < 3; ++r) {
          double d = out_w[3 * q + r] - w[r];
          d -= std::round(d);
          dmax = std::max(dmax, std::fabs(d));
        }
        if (dmax < tol) dup = true;
      }
      if (dup) continue;
      if (n_ops >= max_ops) return -1;
      std::memcpy(out_W + 9 * n_ops, W, 9 * sizeof(int));
      std::memcpy(out_w + 3 * n_ops, w, 3 * sizeof(double));
      ++n_ops;
    }
  }
  return n_ops;
}

}  // extern "C"
