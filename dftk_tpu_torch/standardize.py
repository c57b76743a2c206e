"""Cell standardization: primitive-cell finding + Minkowski lattice reduction.

Port of `dftk_tpu/standardize.py`, host numpy over the port's own
`symmetry.py`, with the same results.  Counterpart of the reference's
`standardize_atoms` (DFTK external/spglib.jl `spglib_standardize_cell`):
detect pure lattice translations among the
symmetry operations of a (possibly super-) cell, reduce to a primitive cell,
and Minkowski-reduce the resulting lattice vectors.  Self-contained (no
spglib): the translation lattice  Z^3 + sum_j Z t_j  is computed exactly via
a Hermite-normal-form of the rationalized generators.
"""
import math
from fractions import Fraction

import numpy as np

from .symmetry import SYMMETRY_TOLERANCE, symmetry_operations


def _hnf_rows(M):
    """Row-style Hermite normal form of an integer matrix (full row rank 3).

    Returns H [3,3] lower-triangular with positive diagonal such that the
    rows of H span the same lattice as the rows of M.
    """
    M = [list(map(int, row)) for row in M]
    H = []
    for col in range(3):
        # Euclid-reduce column `col` over the remaining rows
        while True:
            nz = [r for r in M if r[col] != 0]
            if len(nz) <= 1:
                break
            nz.sort(key=lambda r: abs(r[col]))
            a = nz[0]
            for r in nz[1:]:
                q = r[col] // a[col]
                for i in range(3):
                    r[i] -= q * a[i]
        nz = [r for r in M if r[col] != 0]
        if nz:
            piv = nz[0]
            if piv[col] < 0:
                for i in range(3):
                    piv[i] = -piv[i]
            H.append(piv[:])
            M.remove(piv)
    assert len(H) == 3, "translation generators do not span 3D"
    # reduce entries below the diagonal
    for i in range(1, 3):
        for j in range(i):
            q = H[i][j] // H[j][j]
            for kk in range(3):
                H[i][kk] -= q * H[j][kk]
    return np.array(H, dtype=int)


def _pure_translations(lattice, atoms, positions, tol):
    ops = symmetry_operations(lattice, atoms, positions)
    eye = np.eye(3, dtype=int)
    ts = []
    for op in ops:
        if np.array_equal(op.Wmat, eye):
            w = np.mod(op.wvec, 1.0)
            w[np.abs(w - 1.0) < tol] = 0.0
            if np.abs(w).max() > tol:
                ts.append(w)
    return ts


def find_primitive(lattice, atoms, positions, tol=SYMMETRY_TOLERANCE):
    """Reduce a supercell to a primitive cell (lattice, atoms, positions).

    If the structure is already primitive it is returned unchanged (up to
    position wrapping).
    """
    lattice = np.asarray(lattice, dtype=float)
    ts = _pure_translations(lattice, atoms, positions, tol)
    if not ts:
        return lattice, list(atoms), [np.mod(p, 1.0) for p in positions]

    # rationalize generators and build the translation lattice basis
    fracs = [[Fraction(float(x)).limit_denominator(48) for x in t]
             for t in ts]
    den = 1
    for row in fracs:
        for f in row:
            den = den * f.denominator // math.gcd(den, f.denominator)
    rows = [[den, 0, 0], [0, den, 0], [0, 0, den]]
    for row in fracs:
        rows.append([int(f * den) for f in row])
    H = _hnf_rows(rows)                       # basis of den * T, row-wise
    B = H.astype(float) / den                 # rows = primitive vectors (frac)
    prim_lattice = (B @ lattice.T).T          # columns = primitive vectors

    vol_ratio = abs(np.linalg.det(B))
    n_prim = int(round(len(atoms) * vol_ratio))

    # map atoms into the primitive cell and deduplicate
    Binv = np.linalg.inv(B)
    new_atoms, new_pos = [], []
    for at, p in zip(atoms, positions):
        q = np.mod(Binv.T @ np.asarray(p, dtype=float), 1.0)
        q[np.abs(q - 1.0) < 10 * tol] = 0.0
        dup = any(np.abs((q - q2) - np.round(q - q2)).max() < 10 * tol
                  for q2 in new_pos)
        if not dup:
            new_atoms.append(at)
            new_pos.append(q)
    assert len(new_atoms) == n_prim, (len(new_atoms), n_prim)
    return prim_lattice, new_atoms, new_pos


def minkowski_reduce(lattice, maxiter=100):
    """Greedy 3D lattice reduction: shortest possible cell vectors."""
    L = np.asarray(lattice, dtype=float).copy()
    for _ in range(maxiter):
        changed = False
        # sort by length
        order = np.argsort(np.linalg.norm(L, axis=0))
        L = L[:, order]
        for i in range(3):
            for j in range(3):
                if i == j:
                    continue
                mu = round(float(L[:, i] @ L[:, j] / (L[:, j] @ L[:, j])))
                if mu != 0:
                    cand = L[:, i] - mu * L[:, j]
                    if cand @ cand < L[:, i] @ L[:, i] - 1e-12:
                        L[:, i] = cand
                        changed = True
        if not changed:
            break
    if np.linalg.det(L) < 0:
        L[:, 2] = -L[:, 2]
    return L


def standardize_atoms(lattice, atoms, positions, primitive=True,
                      tol=SYMMETRY_TOLERANCE):
    """Primitive reduction (optional) + Minkowski-reduced lattice.

    Returns dict(lattice, atoms, positions) with positions re-expressed in
    the reduced lattice.
    """
    lattice = np.asarray(lattice, dtype=float)
    if primitive:
        lattice, atoms, positions = find_primitive(lattice, atoms, positions,
                                                   tol=tol)
    red = minkowski_reduce(lattice)
    # positions in the new basis: r_cart = lattice @ p = red @ p'
    T = np.linalg.solve(red, lattice)
    positions = [np.mod(T @ np.asarray(p, dtype=float), 1.0)
                 for p in positions]
    return dict(lattice=red, atoms=list(atoms), positions=positions)
