"""Density of states: total, local and projected.

Port of `dftk_tpu/postprocess/dos.py` (reference
`src/postprocess/dos.jl:18-118`):

    DOS(eps)     = sum_kn w_k (-f'((eps_kn - eps)/T)) / T * filled
    LDOS(eps, r) = the same sum weighted by |psi_kn(r)|^2
    PDOS(eps)    = the same sum weighted by |<phi|psi_kn>|^2

f' by torch.autograd (`SmearingFunction.occupation_derivative`); the LDOS's
orbitals go to real space by `torch.fft` on the orbitals' device; the PDOS
projects on the pseudo-atomic orbitals of UPF pseudopotentials through
`ops/hubbard.py::build_hubbard_projectors` (HGH psps carry none).
"""
import numpy as np
import torch

from ..models.smearing import Gaussian


def _smearing(model, smearing, temperature):
    if temperature is None:
        temperature = model.temperature if model.temperature > 0 else 1e-3
    if smearing is None:
        smearing = model.smearing if model.temperature > 0 else Gaussian()
    return smearing, temperature


def _docc(smearing, eigenvalues, eps, temperature):
    """f'((e_kn - eps) / T) [n_eps, nk, nb], float64 on the CPU."""
    eps = torch.as_tensor(np.atleast_1d(np.array(eps, dtype=float)))
    ev = torch.as_tensor(np.array(eigenvalues, dtype=float))
    x = (ev[None, :, :] - eps[:, None, None]) / temperature
    return smearing.occupation_derivative(x)


def compute_dos(eps, basis, eigenvalues, smearing=None, temperature=None):
    """Total DOS at energies eps (scalar or array) per unit cell, numpy
    [n_eps]."""
    model = basis.model
    smearing, temperature = _smearing(model, smearing, temperature)
    docc = _docc(smearing, eigenvalues, eps, temperature)
    w = torch.as_tensor(np.asarray(basis.kweights, dtype=float))
    dos = -model.filled_occupation / temperature * torch.einsum("k,ekn->e", w, docc)
    return dos.numpy()


def compute_ldos(eps, basis, eigenvalues, psi, smearing=None, temperature=None):
    """Local DOS on the real-space grid, numpy [n_eps, n1, n2, n3]
    (spin-summed)."""
    from ..ops import fft as fftops
    model = basis.model
    smearing, temperature = _smearing(model, smearing, temperature)
    bd = basis.data
    N = int(np.prod(basis.fft_size))
    psi = torch.as_tensor(psi, device=basis.device)
    cube = fftops.scatter_to_cube(psi, bd.Gidx, bd.mask, basis.fft_size)
    psir = torch.fft.ifftn(cube, dim=(-3, -2, -1)) * (N / np.sqrt(model.unit_cell_volume))
    psir2 = psir.real ** 2 + psir.imag ** 2                      # [nk, nb, grid]
    docc = _docc(smearing, eigenvalues, eps, temperature).to(psir2)
    weights = -model.filled_occupation / temperature * docc * bd.kweights[None, :, None]
    return torch.einsum("ekn,knxyz->exyz", weights, psir2).cpu().numpy()


def compute_pdos(eps, basis, eigenvalues, psi, manifolds=None, smearing=None,
                 temperature=None):
    """Projected DOS onto pseudo-atomic orbitals (UPF pswfcs).

    manifolds: list of (atom_index, l, i) selecting orbitals; defaults to
    every pswfc of every atom.  Returns dict label -> numpy [n_eps]
    (reference dos.jl:88-203).
    """
    from ..ops.hubbard import HubbardManifold, build_hubbard_projectors
    model = basis.model
    smearing, temperature = _smearing(model, smearing, temperature)
    filled = model.filled_occupation

    if manifolds is None:
        manifolds = []
        for ia, at in enumerate(model.atoms):
            psp = getattr(at, "psp", None)
            if psp is None or not hasattr(psp, "n_pswfc_radial"):
                continue
            for l in range(len(psp.r2_pswfcs)):
                for i in range(1, psp.n_pswfc_radial(l) + 1):
                    manifolds.append((ia, l, i))
    mfs = [HubbardManifold(atom_index=ia, l=l, U=0.0, i=i) for (ia, l, i) in manifolds]
    Phi, slices = build_hubbard_projectors(basis, mfs)
    psi = torch.as_tensor(psi, device=basis.device)
    proj = torch.einsum("kgm,kng->knm", Phi.conj(), psi)
    weights = (proj.real ** 2 + proj.imag ** 2).cpu().numpy()     # [nk, nb, n_orb]
    docc = _docc(smearing, eigenvalues, eps, temperature).numpy()
    w_k = np.asarray(basis.kweights)

    out = {}
    for (ia, l, i), (a, b) in zip(manifolds, slices):
        sym = getattr(model.atoms[ia], "symbol", "X")
        pw = weights[:, :, a:b].sum(axis=2)            # sum over m
        out[f"{sym}{ia}_l{l}_{i}"] = -filled / temperature * np.einsum(
            "k,ekn,kn->e", w_k, docc, pw)
    return out


def plot_dos_data(basis, eigenvalues, n_points=200, margin=0.1, **kwargs):
    """Convenience: energy grid + DOS values spanning the eigenvalue range."""
    lo = float(np.min(eigenvalues)) - margin
    hi = float(np.max(eigenvalues)) + margin
    eps = np.linspace(lo, hi, n_points)
    return eps, compute_dos(eps, basis, eigenvalues, **kwargs)
