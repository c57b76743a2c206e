"""Elastic tensor by DFPT response (implicit SCF differentiation).

Port of `dftk_tpu/postprocess/elastic_response.py` (reference
src/postprocess/elastic.jl:34 + src/response/hessian.jl):

    C_ab = (1/Omega) [ d^2F/de_a de_b |_psi  (clamped orbitals)
                       + 2 sum w f Re < d_a(H psi), dpsi^(b) > ]
    (Omega + K) dpsi^(b) = - P_c d_b(H psi)

where F(eps, psi) = `postprocess/stresses.py::energy_at_lattice` at fixed
psi and L = (1 + eps) L0 carries every explicit strain dependence, and its
Hessian and gradient come by double backward.  At T > 0 the Omega + K
solve is replaced by the Dyson screening and the occupation response, as
in the metallic Gamma DFPT (`response/phonon_dfpt.py`).

d_a(H psi), the strain derivative of H(eps) psi with the potential built
from rho(psi fixed, eps), is split by the parts of H.  The double-vjp
trick (the XC gradient inside is taken with create_graph=True; one
forward and one first backward serve all six strains) differentiates the
three eps-dependent pieces, none of which holds a kernel: the kinetic energies
|B(eps)(k+G)|^2/2, the local potential V(eps) = V_loc + V_H + V_xc (a
real grid) and the projectors P(eps).  Then
  * d kin psi is a product on the sphere;
  * dV_a psi goes through `response/chi0.py::apply_dV`, kernels A -> B -> A
    on a CUDA tensor;
  * the projectors' part is dP D P^dag psi + P D dP^dag psi, by einsum.
As in the JAX package, H(eps) builds no meta-GGA Vtau (ROADMAP Queue 3).
"""
import math

import numpy as np
import torch

from ..ops import hamiltonian as hamops
from ..ops.density import compute_density, make_symmetrizer
from ..ops.terms import Hartree, projector_form_factors
from ..response.chi0 import apply_dV, make_chi0_context
from ..response.hessian import solve_omega_plus_k
from ..response.phonon_dfpt import _nonlocal_derivative, response_matrix, screened_response
from .forces import f64, psp_groups, structure_factor
from .stresses import _traced_core, energy_at_lattice
from ..parallel.mesh import refuse_distributed

_VOIGT = [(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]


def _strain_mat(a):
    """Unit engineering-strain direction (off-diagonals carry 1/2 so the
    Voigt convention matches postprocess/elastic.py exactly), numpy."""
    i, j = _VOIGT[a]
    E = np.zeros((3, 3))
    if i == j:
        E[i, j] = 1.0
    else:
        E[i, j] = E[j, i] = 0.5
    return E


def _strained_parts(basis, rho_sym, e6):
    """(kin, V, P) of H(eps) at eps = sum_a e6[a] E_a: the kinetic energies
    [nk, nG], the local potential [nspin, n1, n2, n3] built from the density
    rho_sym (L0's, rescaled by the volume) and the projectors [nk, nG,
    nproj] (ops/terms.py's column order), all traced through e6."""
    model = basis.model
    terms = basis.terms
    fft_size = basis.fft_size
    N = int(np.prod(fft_size))
    nspin = model.n_spin_components
    dev = basis.device
    E = torch.as_tensor(np.stack([_strain_mat(a) for a in range(6)]), device=dev)
    eps = torch.einsum("a,aij->ij", e6, E)
    lattice = (torch.eye(3, dtype=torch.float64, device=dev) + eps) @ f64(basis, model.lattice)
    B = 2 * math.pi * torch.linalg.inv(lattice.T)
    vol = torch.abs(torch.linalg.det(lattice))
    sqrt_vol = torch.sqrt(vol)

    mask = f64(basis, basis.mask_np)
    Gred_pk = f64(basis, basis.Gred_np + basis.kcoords_spin[:, None, :])
    Gpk_cart = torch.einsum("ab,knb->kna", B, Gred_pk)
    kin = 0.5 * torch.sum(Gpk_cart * Gpk_cart, -1) * mask * terms.data.kinetic_scale

    rho = rho_sym * (model.unit_cell_volume / vol)
    Gred_cube = f64(basis, basis.G_cube.reshape(-1, 3))
    G_cart = Gred_cube @ B.T
    Gsq = torch.sum(G_cart * G_cart, -1)
    pos = f64(basis, np.stack(model.positions))

    vloc_G = torch.zeros(N, dtype=torch.complex128, device=dev)
    for group in model.atom_groups:
        el = model.atoms[group[0]]
        if hasattr(el, "local_potential_fourier"):
            vloc_G = vloc_G + el.local_potential_fourier_sq(Gsq) \
                * structure_factor(Gred_cube, pos[group]) / sqrt_vol
    Vloc = torch.fft.ifftn(vloc_G.reshape(fft_size)).real * (N / sqrt_vol)

    hartree = next((t.scaling_factor for t in model.term_types if isinstance(t, Hartree)), 0.0)
    nonzero = Gsq > 0
    coeffs = torch.where(nonzero, 4 * math.pi / torch.where(nonzero, Gsq, 1.0), 0.0) * hartree
    VH = torch.fft.ifftn(coeffs.reshape(fft_size) * torch.fft.fftn(rho.sum(0))).real
    V = (Vloc + VH).expand((nspin,) + tuple(fft_size))
    if terms.xc:
        rho_xc = rho
        if terms.rho_core_np is not None:
            rho_xc = rho + _traced_core(basis, "rho", Gsq, pos, vol)[None] / nspin
        exc = hamops.xc_energy(terms.xc, rho_xc, vol, terms.xc_scaling,
                               G_cart.reshape(tuple(fft_size) + (3,)))
        if exc.requires_grad:
            (Vxc,) = torch.autograd.grad(exc, rho_xc, create_graph=True)
            V = V + Vxc / (vol / N)

    Ps = []
    for group in psp_groups(model):
        ff, _ = projector_form_factors(model.atoms[group[0]].psp, Gpk_cart, mask)
        for atom_idx in group:
            sf = torch.exp(-2j * math.pi * (Gred_pk @ pos[atom_idx]))
            Ps.append(ff * sf[..., None] / sqrt_vol)
    P = torch.cat(Ps, -1) if Ps else torch.zeros(
        kin.shape + (0,), dtype=torch.complex128, device=dev)
    return kin, V, P


def strain_derivatives(basis, psi, occupation):
    """The bare strain derivatives r_a = d_a(H psi) [nk, nb, nG], a = 0..5
    (Voigt), at fixed psi [nk, nb, nG] and occupations [nk, nb]: a list of
    six tensors on the basis' device, zero on the padding."""
    refuse_distributed(basis, "strain_derivatives")
    model = basis.model
    bd = basis.data
    rho_sym = compute_density(bd, psi, occupation, basis.fft_size, model.unit_cell_volume,
                              model.n_spin_components, symmetrizer=make_symmetrizer(basis))
    e6 = torch.zeros(6, dtype=torch.float64, device=basis.device, requires_grad=True)
    with torch.enable_grad():
        kin, V, P = _strained_parts(basis, rho_sym, e6)
        outs = [kin, V] + ([torch.view_as_real(P)] if P.requires_grad else [])
        # the jvp along each unit strain by the double-vjp trick, with one
        # forward and one first backward for all six: g = J^T u, and
        # d g_a / d u = J e_a
        us = [torch.zeros_like(o, requires_grad=True) for o in outs]
        (g,) = torch.autograd.grad(outs, e6, us, create_graph=True)
        cols = [torch.autograd.grad(g[a], us, retain_graph=a < 5) for a in range(6)]

    # the local apply of dV_a psi takes dV_a in the Ham's V's place
    ham = hamops.build_ham(bd, basis.terms.data, torch.zeros_like(rho_sym), basis.pruned)
    D = basis.terms.data.D.to(psi.dtype)
    P = P.detach()
    rhs = []
    for dkin, dV, *dPr in cols:
        r = dkin[:, None, :] * psi + apply_dV(ham, psi, dV, bd.kspin)
        if dPr:
            r = r + _nonlocal_derivative(P, torch.view_as_complex(dPr[0].contiguous()), D, psi)
        rhs.append(r * bd.mask[:, None, :])
    return rhs


def clamped_orbital_tensor(basis, psi, occupation):
    """The clamped-orbital part of C (Voigt [6, 6], numpy): the Hessian of
    F(e) = energy_at_lattice((1 + sum e_a E_a) L0) over the volume, the
    volume's derivative term and the finite-prestress geometric term."""
    refuse_distributed(basis, "clamped_orbital_tensor")
    model = basis.model
    vol = model.unit_cell_volume
    dev = basis.device
    L0 = f64(basis, model.lattice)
    E = torch.as_tensor(np.stack([_strain_mat(a) for a in range(6)]), device=dev)
    eye = torch.eye(3, dtype=torch.float64, device=dev)

    # at fixed psi and occupations; the entropy is strain-independent at
    # fixed occupations, so it drops out of the second derivative
    def F(e6):
        return energy_at_lattice(basis, psi, occupation,
                                 (eye + torch.einsum("a,aij->ij", e6, E)) @ L0)

    z6 = torch.zeros(6, dtype=torch.float64, device=dev)
    with torch.enable_grad():
        HF = torch.autograd.functional.hessian(F, z6).cpu().numpy()
        e = z6.clone().requires_grad_(True)
        (gF,) = torch.autograd.grad(F(e), e)                # dF/de_a = sigma Omega
    gF = gF.cpu().numpy()
    # C = d/de_b [(1/Omega) dF/de_a]; dOmega/de_b = Omega * tr(E_b)
    trE = np.array([np.trace(_strain_mat(a)) for a in range(6)])
    C = HF / vol - np.outer(gF, trE) / vol
    # finite-prestress geometric term: the finite-difference route
    # differentiates the stress of the deformed configuration, where
    # incremental and base strains compose as (1+e)(1+eps); the e*eps cross
    # term adds sum_ij gF_ij sym(E_a E_b)_ij (zero at zero stress; Wallace,
    # "Thermodynamics of Crystals", ch. 1)
    gM = np.zeros((3, 3))
    for a, (i, j) in enumerate(_VOIGT):
        gM[i, j] = gM[j, i] = gF[a]
    for a in range(6):
        Ea = _strain_mat(a)
        for b in range(6):
            Eb = _strain_mat(b)
            C[a, b] += np.sum(gM * (Ea @ Eb + Eb @ Ea) / 2) / vol
    return C


def elastic_tensor_response(scfres, cg_tol=1e-9, cg_maxiter=200, dyson_tol=1e-8,
                            sternheimer_tol=1e-10):
    """Voigt 6x6 elastic tensor C (Ha/bohr^3, numpy) by DFPT response.

    Insulators (T = 0: the Omega + K CG route) and metals (T > 0: Dyson
    screening + occupation and Fermi-level response).  Requires a tightly
    converged result (an SCFResult, or an `interop.SCFState`).  A strain
    perturbation does not have the crystal symmetry: the result is unfolded
    onto the full k-point set first."""
    refuse_distributed(scfres.basis, "elastic_tensor_response")
    from .stresses import refuse_unstrained_terms
    from .unfold import unfold_bz
    refuse_unstrained_terms((scfres.basis).model, "elastic_tensor_response")
    scfres = unfold_bz(scfres)
    basis = scfres.basis
    model = basis.model
    metallic = model.temperature > 0
    bd = basis.data
    vol = model.unit_cell_volume
    filled = model.filled_occupation
    psi = torch.as_tensor(scfres.psi, device=basis.device).to(basis.dtype)
    if metallic:
        occ = torch.as_tensor(scfres.occupation, dtype=basis.rdtype, device=basis.device)
    else:
        psi = psi[:, :int(model.n_electrons // filled)]
        occ = torch.full(psi.shape[:2], float(filled), dtype=basis.rdtype, device=basis.device)

    C = clamped_orbital_tensor(basis, psi, occ)
    rhs = strain_derivatives(basis, psi, occ)
    rho0 = compute_density(bd, psi, occ, basis.fft_size, vol, model.n_spin_components)
    w = bd.kweights[:, None] * occ
    if not metallic:
        dpsi = [solve_omega_plus_k(basis, psi, occ, r_a, rho=rho0, cg_tol=cg_tol,
                                   cg_maxiter=cg_maxiter) for r_a in rhs]
        C = C + response_matrix(basis, psi, w, rhs, dpsi) / vol
        return (C + C.T) / 2

    # metals: screen each bare perturbation self-consistently, then the
    # detailed chi0 apply gives (dpsi, df); the free energy adds
    # sum w df_b <psi|d_a H|psi> (de Gironcoli, PRB 51, 6773)
    ctx = make_chi0_context(scfres, basis)
    dpsi, df = zip(*(screened_response(ctx, basis, rho0, r_a, dyson_tol, sternheimer_tol)
                     for r_a in rhs))
    C = C + response_matrix(basis, psi, w, rhs, list(dpsi), list(df)) / vol
    return (C + C.T) / 2
