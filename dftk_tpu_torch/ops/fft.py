"""Grid helpers and the sphere <-> cube maps.

Port of `dftk_tpu/ops/fft.py`.  Normalisation follows the reference
(DFTK `src/fft.jl:76-98`): psi(r) = sum_G c_G e^{i G.r} / sqrt(Omega).

Two grids:
  * cube:   densities/potentials on the full [n1,n2,n3] box
  * sphere: orbitals on the per-k G-sphere, stored densely as [..., nG_max]
    with a flat index map into the cube and a validity mask.

G ordering on the cube is FFT frequency order: the cube index of an integer
G is (G mod n) per axis, valid iff -ceil((n-1)/2) <= G <= floor((n-1)/2).
"""
import math

import numpy as np
import torch


def G_vectors_cube(fft_size):
    """Integer G vectors on the cube in FFT order, numpy [n1,n2,n3,3]."""
    axes = [np.fft.fftfreq(n, d=1.0 / n).round().astype(np.int64) for n in fft_size]
    G1, G2, G3 = np.meshgrid(*axes, indexing="ij")
    return np.stack([G1, G2, G3], axis=-1)


def r_vectors(fft_size):
    """Fractional real-space grid points, numpy [n1,n2,n3,3] in [0,1)^3."""
    axes = [np.arange(n) / n for n in fft_size]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


def index_G_vectors(fft_size, G):
    """Flat cube index of integer G vectors [..., 3]; -1 if out of range
    (DFTK `index_G_vectors`, PlaneWaveBasis.jl:464-494)."""
    G = np.asarray(G)
    n = np.asarray(fft_size)
    start = -np.floor_divide(n, 2)
    stop = np.floor_divide(n - 1, 2)
    ok = np.all((G >= start) & (G <= stop), axis=-1)
    idx3 = np.mod(G, n)
    flat = (idx3[..., 0] * n[1] + idx3[..., 1]) * n[2] + idx3[..., 2]
    return np.where(ok, flat, -1)


def next_compatible_size(size, smallprimes=(2, 3, 5), factors=(1,)):
    def is_prod_of_primes(n):
        for p in smallprimes:
            while n % p == 0:
                n //= p
        return n == 1

    fac = int(np.prod(factors)) if factors else 1
    while not (size % fac == 0 and is_prod_of_primes(size)):
        size += 1
    return size


def compute_fft_size(lattice, Ecut, supersampling=2.0, smallprimes=(2, 3, 5),
                     factors=(1,)):
    """Minimal cube holding all G with |G|^2/2 <= supersampling^2 * Ecut,
    rounded up to small-prime sizes containing `factors` (DFTK fft.jl:231-290)."""
    from ..utils.lattice import compute_recip_lattice, estimate_integer_lattice_bounds
    Gmax = supersampling * math.sqrt(2 * Ecut)
    B = compute_recip_lattice(np.asarray(lattice, dtype=float))
    Glims = estimate_integer_lattice_bounds(B, Gmax)
    return tuple(next_compatible_size(2 * l + 1, smallprimes, factors) for l in Glims)


def scatter_to_cube(coeffs, Gidx, mask, fft_size):
    """Sphere coefficients [nk, nb, nG] -> cube [nk, nb, n1, n2, n3].

    Padded entries (mask 0) carry index 0 and add an exact zero there."""
    nk, nb, nG = coeffs.shape
    N = int(np.prod(fft_size))
    flat = torch.zeros((nk, nb, N), dtype=coeffs.dtype, device=coeffs.device)
    flat.scatter_add_(2, Gidx[:, None, :].expand(nk, nb, nG),
                      coeffs * mask[:, None, :])
    return flat.reshape((nk, nb) + tuple(fft_size))


def gather_from_cube(cube, Gidx, mask):
    """Cube [nk, nb, n1, n2, n3] -> sphere coefficients [nk, nb, nG]."""
    nk, nb = cube.shape[:2]
    flat = cube.reshape(nk, nb, -1)
    out = torch.gather(flat, 2, Gidx[:, None, :].expand(nk, nb, Gidx.shape[-1]))
    return out * mask[:, None, :]


# ---------------------------------------------------------------------------
# Cube and sphere transforms with the reference's normalisation (torch.fft)
# ---------------------------------------------------------------------------

def ifft_cube(f_fourier, unit_cell_volume):
    """Fourier cube [..., n1, n2, n3] -> real-space grid values (complex)."""
    N = f_fourier.shape[-1] * f_fourier.shape[-2] * f_fourier.shape[-3]
    return torch.fft.ifftn(f_fourier, dim=(-3, -2, -1)) * (N / math.sqrt(unit_cell_volume))


def irfft_cube(f_fourier, unit_cell_volume):
    return ifft_cube(f_fourier, unit_cell_volume).real


def fft_cube(f_real, unit_cell_volume):
    """Real-space grid values [..., n1, n2, n3] -> Fourier cube."""
    N = f_real.shape[-1] * f_real.shape[-2] * f_real.shape[-3]
    return torch.fft.fftn(f_real, dim=(-3, -2, -1)) * (math.sqrt(unit_cell_volume) / N)


def _scatter_one_k(coeffs, Gidx, mask, fft_size):
    """Sphere coefficients [..., nG] of one k-point (Gidx, mask [nG]) ->
    cube [..., n1, n2, n3]."""
    lead = coeffs.shape[:-1]
    flat = torch.zeros(lead + (int(np.prod(fft_size)),), dtype=coeffs.dtype,
                       device=coeffs.device)
    flat.index_add_(-1, Gidx, coeffs * mask)
    return flat.reshape(lead + tuple(fft_size))


def ifft_sphere(coeffs, Gidx, mask, fft_size, unit_cell_volume):
    """Orbital coefficients on the G-sphere -> real-space values: one
    k-point's coeffs [..., nG] with Gidx, mask [nG], or [nk, nb, nG] with
    Gidx, mask [nk, nG]."""
    if Gidx.dim() == 1:
        cube = _scatter_one_k(coeffs, Gidx, mask, fft_size)
    else:
        cube = scatter_to_cube(coeffs, Gidx, mask, fft_size)
    return ifft_cube(cube, unit_cell_volume)


def fft_sphere(f_real, Gidx, mask, unit_cell_volume):
    """Real-space orbital values -> coefficients on the G-sphere (the
    layouts of `ifft_sphere`)."""
    cube = fft_cube(f_real, unit_cell_volume)
    if Gidx.dim() == 1:
        flat = cube.reshape(cube.shape[:-3] + (-1,))
        return torch.index_select(flat, -1, Gidx) * mask
    return gather_from_cube(cube, Gidx, mask)
