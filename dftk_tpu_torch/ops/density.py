"""Densities from orbitals, and the superposition guess density.

Port of `compute_density` and `guess_density` of `dftk_tpu/ops/density.py`
(reference `src/densities.jl:13-57`, `src/density_methods.jl`):

    rho_sigma(r) = sum_{k in sigma} w_k sum_n f_kn |psi_kn(r)|^2

as one batched inverse FFT (`torch.fft`) and a weighted reduction over
(k, band).  No symmetrizer: the slice runs symmetry-free models.
"""
import math

import numpy as np
import torch

from . import fft as fftops


def compute_density(basis_data, psi, occupation, fft_size, volume, n_spin,
                    band_chunk=None):
    """rho [nspin, n1, n2, n3] from psi [nk, nb, nG], occupation [nk, nb];
    band_chunk bounds the bands transformed at once (the full-grid cubes of
    a chunk are the largest temporaries)."""
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
        return dens_k.sum(0)[None]
    sel = torch.nn.functional.one_hot(basis_data.kspin, n_spin).to(dens_k.dtype)
    return torch.einsum("ks,kxyz->sxyz", sel, dens_k)


def guess_density(basis, n_electrons=None):
    """Superposition of Gaussian atomic valence densities, renormalised to
    the electron count; rho [nspin, n1, n2, n3] on the basis' device."""
    from ..models.elements import atom_decay_length
    model = basis.model
    if n_electrons is None:
        n_electrons = model.n_electrons
    Gnorm = basis.G_cube_cart_norm.reshape(-1)
    Gred = basis.G_cube.reshape(-1, 3).astype(float)
    rho_G = np.zeros(Gnorm.shape, dtype=np.complex128)
    ff_cache = {}
    for i, at in enumerate(model.atoms):
        if at not in ff_cache:
            ff_cache[at] = at.charge_ionic() * np.exp(-((Gnorm * atom_decay_length(at)) ** 2))
        phase = np.exp(-2j * math.pi * (Gred @ np.asarray(model.positions[i])))
        rho_G += ff_cache[at] * phase
    rho_G /= math.sqrt(model.unit_cell_volume)
    N = np.prod(basis.fft_size)
    rho_tot = np.fft.ifftn(rho_G.reshape(basis.fft_size)).real \
        * (N / math.sqrt(model.unit_cell_volume))
    if model.n_spin_components == 1:
        rho = rho_tot[None]
    else:
        rho = np.stack([rho_tot / 2, rho_tot / 2])
    Ncur = rho.sum() * basis.dvol
    if Ncur > 0:
        rho = rho * (n_electrons / Ncur)
    return basis.tensor(rho)
