"""Crystal symmetry detection and use (host-side, numpy).

Port of `dftk_tpu/symmetry.py` (reference `src/external/spglib.jl`,
`src/symmetry.jl`, `src/SymOp.jl`):
  * detection of the space-group operations (W, w) of a crystal, by the
    native engine (`utils/native.py`), or by numpy where the engine's
    buffer of operations is too small
  * filtering of the operations compatible with the FFT r-grid and the
    k-grid
  * irreducible k-point (IBZ) reduction of Monkhorst-Pack meshes, with the
    JAX package's canonical k-point order

Conventions (reference SymOp.jl:1-50): an operation (W, w) acts in real
space as u(x) -> u(W x + w), with W an integer matrix (unitary in
Cartesian coordinates) and w a fractional translation.  In Fourier space
(U u)(G) = e^{-2 pi i G.tau} u(S^{-1} G) with S = W^T and tau = -W^{-1} w.

Everything here runs once at setup on the host; the density symmetrizer
(`ops/density.py`) takes integer gather maps and translations to the
basis' device.
"""
import dataclasses
import itertools

import numpy as np

from .utils.lattice import estimate_integer_lattice_bounds
from .utils.native import native_symmetry_operations

SYMMETRY_TOLERANCE = 1e-5


@dataclasses.dataclass(frozen=True)
class SymOp:
    W: tuple    # 3x3 int matrix (rows as tuples)
    w: tuple    # fractional translation (3,)

    @property
    def Wmat(self):
        return np.array(self.W, dtype=int)

    @property
    def wvec(self):
        return np.array(self.w, dtype=float)

    @property
    def S(self):
        """Reciprocal-space rotation: S = W^T."""
        return self.Wmat.T

    @property
    def tau(self):
        """Reciprocal-space translation: tau = -W^{-1} w."""
        return -np.linalg.solve(self.Wmat, self.wvec)

    def is_identity(self):
        return np.array_equal(self.Wmat, np.eye(3, dtype=int)) and \
            np.allclose(self.wvec, 0, atol=SYMMETRY_TOLERANCE)

    @classmethod
    def make(cls, W, w):
        W = np.asarray(W, dtype=int)
        w = np.mod(np.asarray(w, dtype=float), 1.0)
        w[np.abs(w - 1.0) < 1e-12] = 0.0
        return cls(tuple(map(tuple, W.tolist())), tuple(w.tolist()))

    @classmethod
    def identity(cls):
        return cls.make(np.eye(3, dtype=int), np.zeros(3))


def _is_approx_integer(r, atol):
    return np.all(np.abs(r - np.round(r)) <= atol)


def lattice_point_group(lattice, tol=SYMMETRY_TOLERANCE):
    """All integer matrices W with W^T M W = M (M the lattice metric).

    Candidate columns are integer vectors of the correct length; we bound the
    search box via the lattice geometry.  Returns a list of 3x3 int arrays.
    """
    lattice = np.asarray(lattice, dtype=float)
    M = lattice.T @ lattice
    norms = np.sqrt(np.diag(M))
    reltol = tol * max(norms)

    # candidate integer vectors per basis vector: same length under the metric
    cands = []
    for i in range(3):
        bound = estimate_integer_lattice_bounds(lattice, norms[i] * (1 + 10 * tol))
        axes = [np.arange(-b, b + 1) for b in bound]
        pts = np.array(list(itertools.product(*axes)), dtype=int)
        lengths2 = np.einsum("ni,ij,nj->n", pts, M, pts)
        keep = np.abs(np.sqrt(np.maximum(lengths2, 0)) - norms[i]) < 10 * reltol + tol
        cands.append(pts[keep])

    ops = []
    for c1 in cands[0]:
        for c2 in cands[1]:
            # metric cross check before the inner loop
            if abs(c1 @ M @ c2 - M[0, 1]) > 10 * reltol * max(1.0, norms[0] * norms[1]):
                continue
            for c3 in cands[2]:
                W = np.stack([c1, c2, c3], axis=1)
                if abs(round(float(np.linalg.det(W)))) != 1:
                    continue
                if np.allclose(W.T @ M @ W, M, atol=20 * reltol * np.max(np.abs(M)) + tol):
                    ops.append(W)
    return ops


def symmetry_operations(lattice, atoms, positions, magnetic_moments=None,
                        tol=SYMMETRY_TOLERANCE):
    """Space-group operations (W, w) of the crystal.

    atoms: list of per-atom species keys (anything hashable identifying the
    species, e.g. the Element objects); positions: fractional coords [n,3].
    """
    positions = [np.asarray(p, dtype=float) for p in positions]
    if len(positions) == 0:
        return [SymOp.identity()]

    # group atoms by species (and magnetic moment if given)
    keys = [(_species_key(a), None if magnetic_moments is None
             else round(float(np.atleast_1d(magnetic_moments[i])[-1]), 6))
            for i, a in enumerate(atoms)]
    groups = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    group_lists = list(groups.values())

    # the native engine first (dftk_tpu_torch/csrc/symmetry_engine.cpp); it
    # returns None where the crystal has more operations than its buffer
    type_ids = {k: i for i, k in enumerate(groups)}
    native = native_symmetry_operations(lattice, np.stack(positions),
                                        [type_ids[k] for k in keys], tol=tol)
    if native is not None:
        Ws, ws = native
        ops = [SymOp.make(W, w) for W, w in zip(Ws, ws)]
        if not any(op.is_identity() for op in ops):
            ops.insert(0, SymOp.identity())
        return ops

    # smallest group anchors the translation search
    anchor = min(group_lists, key=len)

    # For non-primitive cells several translations per W can be valid
    # (pure translations), so enumerate all candidate translations.
    full_ops = []
    seen = set()
    for W in lattice_point_group(lattice, tol):
        a0 = positions[anchor[0]]
        for j in anchor:
            w = np.mod(positions[j] - W @ a0, 1.0)
            if _is_crystal_symmetry(W, w, group_lists, positions, tol):
                op = SymOp.make(W, w)
                key = (op.W, tuple(np.round(np.array(op.w) / tol).astype(int)))
                if key not in seen:
                    seen.add(key)
                    full_ops.append(op)
    if not any(op.is_identity() for op in full_ops):
        full_ops.insert(0, SymOp.identity())
    return full_ops


def _species_key(atom):
    for attr in ("symbol", "Z"):
        if hasattr(atom, attr):
            return getattr(atom, attr)
    return atom


def _is_crystal_symmetry(W, w, group_lists, positions, tol):
    for group in group_lists:
        pos_g = np.stack([positions[i] for i in group])
        mapped = (W @ pos_g.T).T + w
        # every mapped position must coincide (mod 1) with some original
        diff = mapped[:, None, :] - pos_g[None, :, :]
        diff -= np.round(diff)
        ok = (np.abs(diff).max(axis=2) < 10 * tol).any(axis=1)
        if not np.all(ok):
            return False
    return True


# ---------------------------------------------------------------------------
# Filters (DFTK symmetry.jl:162-230)
# ---------------------------------------------------------------------------

def symmetries_preserving_rgrid(symmetries, fft_size):
    """Keep ops mapping the discrete real-space grid onto itself.

    Both the fractional translation w and the images of the grid axes
    (columns of W scaled by 1/fft_size) must land on grid points
    (DFTK symmetry.jl:195-207).
    """
    fft_size = np.asarray(fft_size, dtype=float)

    def on_grid(r):
        return np.all(np.abs(r * fft_size - np.round(r * fft_size)) / fft_size
                      <= SYMMETRY_TOLERANCE)

    def ok(op):
        W = op.Wmat
        return all(on_grid(W[:, i] / fft_size[i] + op.wvec) for i in range(3))
    return [op for op in symmetries if ok(op)]


def unfold_kcoords(kcoords, symmetries):
    """Orbit of the k-set under all symmetry rotations, deduplicated."""
    kcoords = np.asarray(kcoords, dtype=float)
    out = []
    seen = set()
    for op in symmetries:
        for k in kcoords:
            kk = op.S @ k
            kk = kk - np.floor(kk + 0.5)
            key = tuple(np.round(kk / SYMMETRY_TOLERANCE).astype(np.int64))
            if key not in seen:
                seen.add(key)
                out.append(kk)
    return np.array(out)


def symmetries_preserving_kgrid(symmetries, kcoords, unfold=True):
    """Keep ops whose reciprocal rotation S maps the k-grid onto itself.

    Like the reference (symmetry.jl:162-172), the provided k-points are first
    unfolded by all candidate symmetries (they may be an irreducible wedge),
    then closure of that full set is required.  Pass unfold=False when
    kcoords is already a full (reducible) grid - then closure of exactly
    that set is required, which is the correct pre-filter before IBZ
    reduction of shifted Monkhorst-Pack meshes.
    """
    kcoords = np.asarray(kcoords, dtype=float)
    if len(kcoords) == 0:
        return symmetries
    full = unfold_kcoords(kcoords, symmetries) if unfold else kcoords

    keys = set()
    for k in full:
        kk = k - np.floor(k + 0.5)
        keys.add(tuple(np.round(kk / SYMMETRY_TOLERANCE).astype(np.int64)))

    def in_set(k):
        kk = k - np.floor(k + 0.5)
        return tuple(np.round(kk / SYMMETRY_TOLERANCE).astype(np.int64)) in keys

    def ok(op):
        return all(in_set(op.S @ k) for k in full)
    return [op for op in symmetries if ok(op)]


# ---------------------------------------------------------------------------
# IBZ reduction (replaces spglib get_stabilized_reciprocal_mesh)
# ---------------------------------------------------------------------------

def irreducible_kcoords(kcoords, symmetries, use_time_reversal=True,
                        tol=SYMMETRY_TOLERANCE):
    """Reduce a full k-point list to its irreducible wedge.

    Returns (irr_kcoords [m,3], weights [m] summing to 1).
    """
    kcoords = np.asarray(kcoords, dtype=float)
    n = len(kcoords)
    Ss = [op.S for op in symmetries]
    if use_time_reversal:
        Ss = Ss + [-S for S in Ss]

    # map each k to an index grid for O(1) lookup
    def canon(k):
        kk = k - np.round(k)
        return tuple(np.round(kk / tol).astype(np.int64))

    index = {}
    for i, k in enumerate(kcoords):
        index.setdefault(canon(k), i)

    assigned = np.full(n, -1, dtype=int)
    reps = []
    weights = []
    for i in range(n):
        if assigned[i] >= 0:
            continue
        orbit = set()
        for S in Ss:
            j = index.get(canon(S @ kcoords[i]))
            if j is not None and assigned[j] < 0:
                orbit.add(j)
        if i not in orbit:
            orbit.add(i)
        for j in orbit:
            assigned[j] = len(reps)
        reps.append(i)
        weights.append(len(orbit))
    irr = kcoords[reps]
    w = np.array(weights, dtype=float)
    assert w.sum() == n, "IBZ reduction lost k-points"
    return irr, w / n
