"""Lattice / unit-cell geometry helpers (host-side numpy).

Port of `dftk_tpu/utils/lattice.py` without its jax branches: the port sets
up every geometric quantity on the host in numpy, as the JAX package does.

Conventions (DFTK `src/structure.jl:1-61`, `src/Model.jl:395-437`):
  * `lattice` holds the real-space lattice vectors as *columns* (3x3, bohr).
  * the reciprocal lattice B satisfies B = 2*pi*inv(lattice'); G_cart = B @ G_red.
"""
import numpy as np


def lattice_n_dim(lattice):
    """Number of non-zero lattice vectors (columns)."""
    M = np.asarray(lattice, dtype=float)
    return int(sum(1 for c in range(3) if np.any(M[:, c] != 0)))


def block_inverse(lattice):
    """Matrix inverse honoring reduced dimensions: for a lattice with
    trailing zero columns, invert the leading n_dim x n_dim block and keep
    the rest zero (reference structure.jl:4-16)."""
    M = np.asarray(lattice, dtype=float)
    nd = lattice_n_dim(M)
    if nd == 3:
        return np.linalg.inv(M)
    out = np.zeros((3, 3))
    out[:nd, :nd] = np.linalg.inv(M[:nd, :nd])
    return out


def compute_recip_lattice(lattice):
    """B with reciprocal lattice vectors as columns: B^T A = 2 pi I."""
    return 2 * np.pi * block_inverse(lattice).T


def compute_unit_cell_volume(lattice):
    """abs(det) over the periodic dimensions."""
    M = np.asarray(lattice, dtype=float)
    nd = lattice_n_dim(M)
    return abs(np.linalg.det(M[:nd, :nd]))


def estimate_integer_lattice_bounds(M, delta, shift=None):
    """Integer bounds (per axis) such that ||M x|| <= delta implies
    |x_i| <= bound_i (DFTK `src/structure.jl` estimate_integer_lattice_bounds).
    """
    M = np.asarray(M, dtype=float)
    inv_lattice_t = block_inverse(M).T
    xlims = np.linalg.norm(inv_lattice_t, axis=0) * float(delta)
    if shift is not None:
        xlims = xlims + np.asarray(shift, dtype=float)
    tol = np.sqrt(np.finfo(float).eps)
    return [0 if x == 0 else int(np.ceil(x - tol)) for x in xlims]


def compute_inverse_lattice(lattice):
    return np.linalg.inv(np.asarray(lattice, dtype=float))


def diameter(lattice):
    """Diameter of the unit cell (longest vertex-to-vertex distance)."""
    lattice = np.asarray(lattice, dtype=float)
    return max(float(np.linalg.norm(lattice @ (np.array(c) - 1)))
               for c in np.ndindex(3, 3, 3))


# Reduced <-> Cartesian transforms (DFTK Model.jl:395-437 semantics)

def vector_red_to_cart(lattice, r_red):
    return np.asarray(lattice, dtype=float) @ r_red


def vector_cart_to_red(lattice, r_cart):
    return compute_inverse_lattice(lattice) @ r_cart


def covector_red_to_cart(lattice, f_red):
    # covectors transform with inv(lattice)^T
    return compute_inverse_lattice(lattice).T @ f_red


def covector_cart_to_red(lattice, f_cart):
    return np.asarray(lattice, dtype=float).T @ f_cart


def recip_vector_red_to_cart(lattice, G_red):
    return compute_recip_lattice(lattice) @ G_red
