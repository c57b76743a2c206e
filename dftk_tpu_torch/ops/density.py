"""Densities from orbitals, the superposition guess density, and the
density symmetrizer.

Port of `compute_density` (with its derivative along the orbitals,
`compute_density_derivative`), `compute_kinetic_energy_density`,
`von_weizsaecker_tau`, `guess_density` (with magnetic moments),
`total_density`, `spin_density`, `build_symmetrization_maps` and
`make_symmetrizer` and `random_density` of `dftk_tpu/ops/density.py` (reference
`src/densities.jl:13-57,110-125`, `src/density_methods.jl`,
`src/symmetry.jl:282-360`):

    rho_sigma(r) = sum_{k in sigma} w_k sum_n f_kn |psi_kn(r)|^2
    tau_sigma(r) = 1/2 sum_{k in sigma} w_k sum_n f_kn |grad psi_kn(r)|^2

as batched inverse FFTs (`torch.fft`) and a weighted reduction over
(k, band), and their symmetrization

    rho_sym(G) = 1/|S| sum_s e^{-2 pi i G.tau_s} rho(S_s^{-1} G)

with a low-pass mask dropping the G whose orbit leaves the grid.
"""
import math
from typing import NamedTuple

import numpy as np
import torch

from ..parallel.mesh import ksum
from . import fft as fftops


def compute_density(basis_data, psi, occupation, fft_size, volume, n_spin,
                    band_chunk=None, symmetrizer=None, comm=None):
    """rho [nspin, n1, n2, n3] from psi [nk, nb, nG], occupation [nk, nb];
    band_chunk bounds the bands transformed at once (the full-grid cubes of
    a chunk are the largest temporaries); symmetrizer (`make_symmetrizer`)
    is applied to the result when given.  comm: a distributed basis'
    `KComm` (`parallel/mesh.py`): the rows are this rank's and the sum over
    k all-reduces over "kpts"."""
    N = int(np.prod(fft_size))
    w = basis_data.kweights[:, None] * occupation          # [nk, nb]
    nb = psi.shape[1]
    step = nb if band_chunk is None else band_chunk
    dens_k = 0
    for i in range(0, nb, step):
        cube = fftops.scatter_to_cube(psi[:, i:i + step], basis_data.Gidx,
                                      basis_data.mask, fft_size)
        psir = torch.fft.ifftn(cube, dim=(-3, -2, -1)) * (N / math.sqrt(volume))
        dens_k = dens_k + torch.einsum("kn,knxyz->kxyz", w[:, i:i + step],
                                       psir.real ** 2 + psir.imag ** 2)
    if n_spin == 1:
        rho = dens_k.sum(0)[None]
    else:
        sel = torch.nn.functional.one_hot(basis_data.kspin, n_spin).to(dens_k.dtype)
        rho = torch.einsum("ks,kxyz->sxyz", sel, dens_k)
    rho = ksum(rho, comm)
    return rho if symmetrizer is None else symmetrizer(rho)


def compute_density_derivative(basis_data, psi, dpsi, occupation, fft_size, volume,
                               n_spin, symmetrizer=None):
    """The first-order change of `compute_density` along dpsi at fixed
    occupations, the linear

        drho_sigma(r) = sum_{k in sigma} w_k sum_n f_kn 2 Re(conj(psi_kn(r)) dpsi_kn(r)),

    symmetrized like the density (the symmetrizer is linear)."""
    N = int(np.prod(fft_size))
    scale = N / math.sqrt(volume)
    psir, dpsir = (torch.fft.ifftn(fftops.scatter_to_cube(x, basis_data.Gidx, basis_data.mask,
                                                          fft_size), dim=(-3, -2, -1)) * scale
                   for x in (psi, dpsi))
    w = basis_data.kweights[:, None] * occupation
    prod = psir.real * dpsir.real + psir.imag * dpsir.imag
    drho_k = 2 * torch.einsum("kn,knxyz->kxyz", w.to(prod.dtype), prod)
    if n_spin == 1:
        drho = drho_k.sum(0)[None]
    else:
        sel = torch.nn.functional.one_hot(basis_data.kspin, n_spin).to(drho_k.dtype)
        drho = torch.einsum("ks,kxyz->sxyz", sel, drho_k)
    return drho if symmetrizer is None else symmetrizer(drho)


def compute_kinetic_energy_density(basis_data, psi, occupation, fft_size, volume,
                                   n_spin, band_chunk=None, symmetrizer=None, comm=None):
    """tau [nspin, n1, n2, n3] = 1/2 sum_kn w_k f_kn |grad psi_kn|^2, the
    gradient i (k+G) psi through one inverse FFT per Cartesian axis
    (reference densities.jl:110-125); arguments as `compute_density`'s, the
    Cartesian k+G from basis_data.Gpk_cart."""
    p = basis_data.Gpk_cart
    tau = sum(compute_density(basis_data, p[:, None, :, a].to(psi.real.dtype) * psi, occupation,
                              fft_size, volume, n_spin, band_chunk, comm=comm)
              for a in range(3))
    tau = 0.5 * tau
    return tau if symmetrizer is None else symmetrizer(tau)


def density_gradients(rho, G_cart):
    """grad rho [nspin, n1, n2, n3, 3] of rho [nspin, n1, n2, n3], spectral:
    i G rho(G) with G_cart [n1, n2, n3, 3] (2 pi included)."""
    rho_G = torch.fft.fftn(rho, dim=(-3, -2, -1))
    return torch.stack([torch.fft.ifftn(1j * G_cart[..., a] * rho_G, dim=(-3, -2, -1)).real
                        for a in range(3)], dim=-1)


def von_weizsaecker_tau(rho, G_cart):
    """tau_W = |grad rho|^2 / (8 rho): the meta-GGA SCFs' first tau."""
    g = density_gradients(rho, G_cart.to(rho.dtype))
    return torch.sum(g * g, dim=-1) / (8 * torch.clamp(rho, min=1e-14))


# ---------------------------------------------------------------------------
# Density symmetrization
# ---------------------------------------------------------------------------

class SymmetrizationMaps(NamedTuple):
    """The gather maps of the basis' symmetries, on the host.  The map of
    S^{-1} G depends on the rotation only, so it is kept once per distinct
    rotation (Si54 has 1296 operations and 48 rotations)."""
    rot_idx: np.ndarray    # [nrot, N] int64: flat index of S^{-1} G (N if off the grid)
    op_rot: np.ndarray     # [nsym] int64: each operation's rotation
    tau: np.ndarray        # [nsym, 3] translations
    lowpass: np.ndarray    # [N] 0/1: G whose orbit stays on the grid

    @property
    def idx(self):
        """[nsym, N]: each operation's map, as the JAX package stores it."""
        return self.rot_idx[self.op_rot]


def build_symmetrization_maps(basis):
    """The per-rotation gather maps, vectorised over the G vectors: one
    `index_G_vectors` of Gred @ invS^T for each distinct rotation."""
    Gred = basis.G_cube.reshape(-1, 3)
    N = Gred.shape[0]
    rows, op_rot, lowpass = {}, [], np.ones(N)
    for op in basis.symmetries:
        if op.W not in rows:
            S = op.S
            invS = np.rint(np.linalg.inv(S)).astype(np.int64)
            src = fftops.index_G_vectors(basis.fft_size, Gred @ invS.T)
            rows[op.W] = (len(rows), np.where(src >= 0, src, N))
            lowpass *= fftops.index_G_vectors(basis.fft_size, Gred @ S.T) >= 0
        op_rot.append(rows[op.W][0])
    return SymmetrizationMaps(
        rot_idx=np.stack([row for _, row in rows.values()]),
        op_rot=np.array(op_rot, dtype=np.int64),
        tau=np.array([op.tau for op in basis.symmetries]).reshape(-1, 3),
        lowpass=lowpass)


def make_symmetrizer(basis):
    """rho [nspin, n1, n2, n3] -> symmetrized rho on the basis' device, or
    None where the basis has the identity only.

    The operations that share a rotation gather from the same map, so

        rho_sym(G) = lowpass(G) / |S| sum_r P_r(G) rho(S_r^{-1} G),
        P_r(G) = sum_{s: S_s = S_r} e^{-2 pi i G.tau_s},

    with P_r (the low-pass mask and 1/|S| folded in) built once: each
    application is torch.fft.fftn, one gather of all rotations' maps from
    the zero-padded row of rho(G), one product with P, ifftn.  P and the
    maps stay on the device (no gradient flows through them).

    Built once per basis and set of symmetries, and kept on the basis
    instance (the SCF, the energy evaluation and the stresses all ask for
    it)."""
    cache = basis.__dict__.setdefault("_symmetrizers", {})
    key = tuple(basis.symmetries)
    if key not in cache:
        cache[key] = (None if all(op.is_identity() for op in basis.symmetries)
                      else _build_symmetrizer(basis))
    return cache[key]


def _build_symmetrizer(basis):
    maps = build_symmetrization_maps(basis)
    dev = basis.device
    nrot, N = maps.rot_idx.shape
    rot_idx = torch.as_tensor(maps.rot_idx.reshape(-1), device=dev)    # [nrot * N]
    Gred = torch.as_tensor(basis.G_cube.reshape(-1, 3), dtype=torch.float64, device=dev)
    phase_sum = torch.empty((nrot, N), dtype=torch.complex128, device=dev)
    for r in range(nrot):
        tau = torch.as_tensor(maps.tau[maps.op_rot == r], dtype=torch.float64, device=dev)
        angle = (-2 * math.pi) * (tau @ Gred.T)                          # [ops of r, N]
        phase_sum[r] = torch.polar(torch.ones_like(angle), angle).sum(0)
    phase_sum *= torch.as_tensor(maps.lowpass, device=dev) / len(maps.op_rot)

    def symmetrize(rho):
        shape = rho.shape
        rho_G = torch.fft.fftn(rho, dim=(-3, -2, -1)).reshape(shape[0], N)
        rho_pad = torch.cat([rho_G, rho_G.new_zeros(shape[0], 1)], dim=1)
        gathered = rho_pad.index_select(1, rot_idx).reshape(shape[0], nrot, N)
        out = torch.einsum("rg,srg->sg", phase_sum.to(rho_G.dtype), gathered)
        return torch.fft.ifftn(out.reshape(shape), dim=(-3, -2, -1)).real

    return symmetrize


def guess_density(basis, magnetic_moments=None, n_electrons=None):
    """Superposition of Gaussian atomic valence densities, renormalised to
    the electron count; rho [nspin, n1, n2, n3] on the basis' device.

    Under collinear spin the magnetisation density is the superposition
    weighted by each atom's moment over its valence charge (a number, or a
    vector whose last entry is the collinear moment), zero without
    moments."""
    model = basis.model
    if n_electrons is None:
        n_electrons = model.n_electrons
    rho_tot = _gaussian_superposition(basis, [1.0] * len(model.atoms))
    if model.n_spin_components == 1:
        rho = rho_tot[None]
    else:
        if magnetic_moments is None or len(magnetic_moments) == 0:
            rho_spin = np.zeros_like(rho_tot)
        else:
            coeffs = []
            for at, m in zip(model.atoms, magnetic_moments):
                mz = float(np.atleast_1d(m)[-1])
                nval = at.n_elec_valence()
                if abs(mz) > nval:
                    raise ValueError(f"magnetic moment {mz} exceeds the {nval} "
                                     f"valence electrons of {at}")
                coeffs.append(mz / nval)
            rho_spin = _gaussian_superposition(basis, coeffs)
        rho = np.stack([(rho_tot + rho_spin) / 2, (rho_tot - rho_spin) / 2])
    Ncur = rho.sum() * basis.dvol
    if Ncur > 0 and n_electrons is not None:
        rho = rho * (n_electrons / Ncur)
    return basis.tensor(rho)


def _gaussian_superposition(basis, coefficients):
    """sum_a c_a rho_a(r - r_a) of atomic valence densities on the basis'
    grid, numpy: the psp's own where it has one (a UPF file's
    PP_RHOATOM), else a Gaussian (Z_ion e^{-(|G| l_a)^2} in Fourier space,
    l_a the element's decay length)."""
    from ..models.elements import atom_decay_length
    model = basis.model
    Gnorm = basis.G_cube_cart_norm.reshape(-1)
    Gred = basis.G_cube.reshape(-1, 3).astype(float)
    rho_G = np.zeros(Gnorm.shape, dtype=np.complex128)
    ff_cache = {}
    for i, at in enumerate(model.atoms):
        if coefficients[i] == 0:
            continue
        if at not in ff_cache:
            if at.has_valence_density():
                ff_cache[at] = np.asarray(at.valence_density_fourier(Gnorm))
            else:
                ff_cache[at] = at.charge_ionic() * np.exp(
                    -((Gnorm * atom_decay_length(at)) ** 2))
        phase = np.exp(-2j * math.pi * (Gred @ np.asarray(model.positions[i])))
        rho_G += coefficients[i] * ff_cache[at] * phase
    rho_G /= math.sqrt(model.unit_cell_volume)
    N = np.prod(basis.fft_size)
    return np.fft.ifftn(rho_G.reshape(basis.fft_size)).real \
        * (N / math.sqrt(model.unit_cell_volume))


def random_density(basis, seed=0, n_electrons=None):
    """Random positive density normalised to n_electrons, on the basis'
    device: the reference's RandomDensity guess (density_methods.jl), for
    testing an SCF's robustness against a bad start.  numpy's
    default_rng(seed) draws it, as in the JAX package, so both packages
    give the same density."""
    model = basis.model
    if n_electrons is None:
        n_electrons = model.n_electrons
    rng = np.random.default_rng(seed)
    rho = rng.random((model.n_spin_components,) + tuple(basis.fft_size))
    rho *= n_electrons / (rho.sum() * basis.dvol)
    return basis.tensor(rho)


def total_density(rho):
    """rho_up + rho_down of rho [nspin, grid]."""
    return torch.sum(rho, dim=0)


def spin_density(rho):
    """rho_up - rho_down of rho [nspin, grid] (zero without spin)."""
    if rho.shape[0] == 1:
        return torch.zeros_like(rho[0])
    return rho[0] - rho[1]
