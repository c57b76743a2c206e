"""Stresses: sigma = (1/Omega) dE/d(strain) at fixed orbital coefficients.

Port of `dftk_tpu/postprocess/stresses.py` (reference
`src/postprocess/stresses.jl`).  The total energy is one torch function of
the lattice matrix: every lattice-dependent quantity (reciprocal lattice,
volume, |k+G|^2, form factors, Hartree kernel, Ewald sums, density
normalisation) is recomputed in the graph from the fixed integer G-vectors
and orbital coefficients, and `torch.autograd` of a symmetric strain gives
the stress tensor exactly.  Everything runs in float64 on the basis' device.

The density is rebuilt from psi by `torch.fft` once, outside the graph: at
fixed coefficients psi(r) scales as 1/sqrt(Omega), so rho(L) = rho(L0)
Omega0 / Omega(L), and no band cube is kept for the backward pass.

The rebuilt density is symmetrized there too, as the SCF's is: the
gather maps are lattice-independent, so symmetrizing at L0 and scaling
commute, and the symmetrizer stays outside the lattice graph.

Collinear spin, GGA functionals and finite-temperature states go through
the same function: the density keeps its spin channels, the GGA gradient
is built from the lattice-traced G, and the occupations are held fixed
(the entropy does not depend on the lattice at fixed eigenvalues).

NLCC core densities are rebuilt in the graph from form factors at the
traced |G|^2 (the psps' `*_sq` evaluators).  A meta-GGA's tau depends on
the lattice through |B (k+G)|: with q the reduced k+G,

    tau(L) = 1/2 Omega0 / Omega sum_bc (B^T B)_bc T_bc,
    T_bc = sum_kn w f Re(conj(F^-1[q_b psi]) F^-1[q_c psi]) at L0,

so the six T_bc are built once outside the graph (from the density of
(q_b + q_c) psi by the polarisation identity) and symmetrized there, and
the graph holds the 3 x 3 metric only.

Potential-only functionals (TB09) have no energy, so no stress: they
raise NotImplementedError.  So do the model Hamiltonians' terms, which the
JAX package's `energy_at_lattice` leaves out without an error (it has no
pairwise, external, magnetic, nonlinear or anyonic part, and takes the
bare kinetic energy: dftk_tpu/postprocess/stresses.py:27-213, :47-54;
ROADMAP Queue 3): the stresses, the split stresses and the elastic tensors
(by response and by finite differences of the stresses) refuse them.
"""
import math

import numpy as np
import torch

from ..ops.density import compute_density, make_symmetrizer
from ..ops.ewald import default_eta, energy_ewald, ewald_sum_bounds
from ..ops.hamiltonian import xc_energy
from ..ops.terms import Hartree, projector_form_factors, refuse_terms
from .forces import (check_supported, core_atoms, core_on_grid, f64, has_local,
                     nonlocal_group_energy, psp_groups, structure_factor)
from ..parallel.mesh import refuse_distributed

DENSITY_BAND_CHUNK = 64     # bands per batch of full-grid cubes in the density

# the terms the JAX package's lattice energy leaves out (module docstring)
UNSTRAINED_TERMS = ("PairwisePotential", "ExternalFromReal", "ExternalFromFourier",
                    "ExternalFromValues", "Magnetic", "LocalNonlinearity", "Anyonic",
                    "Kinetic blow-up")


def refuse_unstrained_terms(model, what):
    refuse_terms(model, what, UNSTRAINED_TERMS,
                 "the JAX package's energy_at_lattice leaves these terms out and takes "
                 "the bare kinetic energy (dftk_tpu/postprocess/stresses.py:27-213)")


def energy_at_lattice(basis, psi, occupation, lattice, positions=None):
    """Total energy (Ha) as a differentiable function of the lattice matrix
    [3, 3] (a float64 tensor on the basis' device, columns the lattice
    vectors).  psi and occupation are held fixed (Hellmann-Feynman);
    positions (fractional) default to the model's."""
    model = basis.model
    refuse_unstrained_terms(model, "energy_at_lattice")
    terms = basis.terms
    vol0 = model.unit_cell_volume
    occupation = torch.as_tensor(occupation, device=basis.device).to(torch.float64)
    wocc = f64(basis, basis.kweights)[:, None] * occupation
    if positions is None:
        positions = np.stack(model.positions)
    pos = f64(basis, positions)
    E = lattice_energy(basis, psi, wocc, lattice, pos, make_symmetrizer(basis))

    charges = np.array([at.charge_ionic() for at in model.atoms], dtype=float)
    if len(charges) > 0 and terms.E_ewald != 0.0:
        eta = default_eta(model.lattice)
        Gbox, Rbox = ewald_sum_bounds(model.lattice, np.stack(model.positions), eta)
        E = E + energy_ewald(lattice, charges, pos, eta=eta, device=basis.device,
                             Gbox=Gbox, Rbox=Rbox)
    # PspCorrection: corr * n_electrons / Omega
    return E + terms.E_psp_correction * vol0 / torch.abs(torch.linalg.det(lattice))


def lattice_energy(basis, psi, wocc, lattice, pos, symmetrizer, include="all"):
    """The orbital and density terms of `energy_at_lattice` (no Ewald,
    PspCorrection or Entropy) at fixed psi [nk, nb, nG] and weighted
    occupations wocc = w_k f_kn [nk, nb]: include "all", "psi" (kinetic and
    nonlocal) or "density" (local, Hartree, XC).  pos: the fractional
    positions, a float64 tensor; symmetrizer: applied to the rebuilt
    density (None: none)."""
    refuse_distributed(basis, "lattice_energy")
    model = basis.model
    terms = basis.terms
    fft_size = basis.fft_size
    N = int(np.prod(fft_size))
    vol0 = model.unit_cell_volume
    psi = torch.as_tensor(psi, device=basis.device).to(torch.complex128)
    wocc = torch.as_tensor(wocc, device=basis.device).to(torch.float64)
    with_psi = include in ("all", "psi")
    with_density = include in ("all", "density")

    B = 2 * math.pi * torch.linalg.inv(lattice.T)
    vol = torch.abs(torch.linalg.det(lattice))
    sqrt_vol = torch.sqrt(vol)
    mask = f64(basis, basis.mask_np)
    E = torch.zeros((), dtype=torch.float64, device=basis.device)

    # kinetic, through |B (k+G)|^2
    Gred_pk = f64(basis, basis.Gred_np + basis.kcoords_spin[:, None, :])
    Gpk_cart = torch.einsum("ab,knb->kna", B, Gred_pk)
    if with_psi:
        kin = 0.5 * torch.sum(Gpk_cart * Gpk_cart, -1) * mask
        abs2 = psi.real ** 2 + psi.imag ** 2
        E = E + torch.sum(wocc[:, :, None] * kin[:, None, :] * abs2) * terms.data.kinetic_scale

    # AtomicNonlocal: projectors traced through the metric
    if with_psi and terms.data.P.shape[-1] > 0:
        for group in psp_groups(model):
            ff, D = projector_form_factors(model.atoms[group[0]].psp, Gpk_cart, mask)
            E = E + nonlocal_group_energy(ff, f64(basis, D), psi, wocc, Gred_pk,
                                          pos[group], sqrt_vol)
    if not with_density:
        return E

    # density from psi at L0, rescaled by the volume in the graph (the
    # weights ride in wocc: unit k weights)
    bd64 = basis.data._replace(mask=mask, kweights=torch.ones_like(wocc[:, 0]))
    with torch.no_grad():
        rho0 = compute_density(bd64, psi, wocc, fft_size, vol0,
                               model.n_spin_components, DENSITY_BAND_CHUNK,
                               symmetrizer=symmetrizer)
    rho = rho0 * (vol0 / vol)
    rho_G = torch.fft.fftn(rho.sum(0)) * (sqrt_vol / N)

    # Cartesian G on the cube
    Gred_cube = f64(basis, basis.G_cube.reshape(-1, 3))
    G_cart = Gred_cube @ B.T
    Gsq = torch.sum(G_cart * G_cart, -1)

    hartree = next((t.scaling_factor for t in model.term_types
                    if isinstance(t, Hartree)), 0.0)
    if hartree:
        nonzero = Gsq > 0
        coeffs = torch.where(nonzero, 4 * math.pi / torch.where(nonzero, Gsq, 1.0), 0.0)
        E = E + 0.5 * hartree * torch.sum(
            coeffs * (rho_G.real ** 2 + rho_G.imag ** 2).reshape(-1))

    if terms.xc:
        # GGA: sigma from i G rho(G) with G built from the lattice in the
        # graph, so the gradient terms' strain dependence is traced too
        nspin = rho.shape[0]
        rho_xc, tau_xc = rho, None
        if terms.rho_core_np is not None:
            rho_xc = rho + _traced_core(basis, "rho", Gsq, pos, vol)[None] / nspin
        if terms.needs_tau:
            with torch.no_grad():
                T = _tau_metric_parts(basis, bd64, psi, wocc, symmetrizer)
            tau_xc = 0.5 * (vol0 / vol) * torch.einsum("bc,bcsxyz->sxyz", B.T @ B, T)
            if terms.tau_core_np is not None:
                tau_xc = tau_xc + _traced_core(basis, "tau", Gsq, pos, vol)[None] / nspin
        E = E + xc_energy(terms.xc, rho_xc, vol, terms.xc_scaling,
                          G_cart.reshape(tuple(fft_size) + (3,)), tau=tau_xc)

    # AtomicLocal: p^2 form factors keep the graph smooth at G = 0
    if has_local(model):
        rho_Gf = rho_G.reshape(-1)
        vloc_G = 0
        for group in model.atom_groups:
            ff = model.atoms[group[0]].local_potential_fourier_sq(Gsq)
            vloc_G = vloc_G + ff * structure_factor(Gred_cube, pos[group])
        E = E + torch.sum(rho_Gf.real * vloc_G.real + rho_Gf.imag * vloc_G.imag) / sqrt_vol
    return E


def _traced_core(basis, kind, Gsq, pos, vol):
    """The NLCC core density (kind "rho") or core kinetic-energy density
    ("tau") on the grid, its form factors at the traced |G|^2 Gsq [N]."""
    fn = "core_density_fourier_sq" if kind == "rho" else "core_tau_fourier_sq"
    model = basis.model
    ffs, by_element = {}, {}
    for i in core_atoms(basis, kind):
        at = model.atoms[i]
        if at not in by_element:
            by_element[at] = getattr(at.psp, fn)(Gsq)
        ffs[i] = by_element[at]
    return core_on_grid(basis, ffs, pos, vol)


def _tau_metric_parts(basis, bd64, psi, occupation, symmetrizer):
    """T [3, 3, nspin, n1, n2, n3] of the module docstring at L0 (float64,
    symmetrized like the SCF's tau)."""
    fft_size, vol0 = basis.fft_size, basis.model.unit_cell_volume
    nspin = basis.model.n_spin_components
    q = f64(basis, basis.Gred_np + basis.kcoords_spin[:, None, :])     # [nk, nG, 3]

    def dens(w):
        return compute_density(bd64, w[:, None, :] * psi, occupation, fft_size, vol0,
                               nspin, DENSITY_BAND_CHUNK)

    D = [dens(q[..., b]) for b in range(3)]
    T = torch.empty((3, 3, nspin) + tuple(fft_size), dtype=torch.float64,
                    device=basis.device)
    for b in range(3):
        T[b, b] = D[b]
        for c in range(b + 1, 3):
            T[b, c] = T[c, b] = (dens(q[..., b] + q[..., c]) - D[b] - D[c]) / 2
    if symmetrizer is not None:
        T = symmetrizer(T.reshape((9 * nspin,) + tuple(fft_size))).reshape(T.shape)
    return T


def compute_stresses_cart(scfres, basis=None):
    """Cartesian stress tensor (Ha/bohr^3), a symmetrized float64 tensor
    [3, 3] on the basis' device: sigma = (1/Omega) dE[(I + eps) L] / d eps
    at eps = 0.  scfres: an SCFResult, or anything with psi and occupation."""
    refuse_distributed(basis or scfres.basis, "compute_stresses_cart")
    basis = basis or scfres.basis
    check_supported(basis, scfres, "stresses")
    L0 = f64(basis, basis.model.lattice)
    with torch.enable_grad():
        eps = torch.zeros((3, 3), dtype=torch.float64, device=basis.device,
                          requires_grad=True)
        L = (torch.eye(3, dtype=torch.float64, device=basis.device)
             + (eps + eps.T) / 2) @ L0
        (grad,) = torch.autograd.grad(
            energy_at_lattice(basis, scfres.psi, scfres.occupation, L), eps)
    stress = grad / basis.model.unit_cell_volume
    return symmetrize_stresses(basis, (stress + stress.T) / 2)


def symmetrize_stresses(basis, stress):
    """Average the Cartesian stress [3, 3] over the basis' symmetries:
    the mean of Wc stress Wc^-1 with Wc = L W L^-1, on the stress' device."""
    L = basis.model.lattice
    Wc = np.stack([L @ op.Wmat @ np.linalg.inv(L) for op in basis.symmetries])
    Wc_inv = np.linalg.inv(Wc)
    stress = torch.as_tensor(stress)
    t = lambda a: torch.as_tensor(a, dtype=stress.dtype, device=stress.device)
    return torch.einsum("sab,bc,scd->ad", t(Wc), stress, t(Wc_inv)) / len(Wc)
