"""Analytic (DFPT) dynamical matrix at Gamma via Sternheimer response.

Port of `dftk_tpu/response/phonon_dfpt.py` (reference DFTK
`src/postprocess/phonon.jl` + `src/response/`): the second derivative of
the total energy is assembled as

    C[s a, t b] = d2E_explicit / du du'   (clamped ion: local + nonlocal +
                                           Ewald at FIXED psi, rho - the
                                           Hessian, by double backward, of
                                           the position energy the forces
                                           use)
                + 2 Re sum_kn w f <dpsi^{(t b)} | dH^{(s a)}_bare psi_n>

with dH_bare = dV_loc + dV_nl the bare perturbation of one Cartesian
displacement and dpsi the self-consistently screened first-order orbitals
(Dyson by GMRES over chi0, then one Sternheimer solve with the screened
perturbation).  At T > 0 the occupation response adds
sum w df^{(t)} <psi|d_s V|psi>.

Every product of a local potential with the orbitals, the bare dV_loc psi
and the induced dV psi, goes through `response/chi0.py::apply_dV`
(kernels A -> B -> A on a CUDA tensor), as every apply of H in the
Sternheimer solves does; the nonlocal dP terms are einsums.  As in the
JAX package, the bare perturbation has no NLCC core-density term while
the clamped-ion energy has one (ROADMAP Queue 3).  The JAX module's
`_chi0_rhs` and `_screened_dpsi` are called nowhere there and are not
ported.
"""
import math

import numpy as np
import torch

from ..models.elements import ElementPsp
from ..ops.terms import refuse_terms
from .chi0 import apply_chi0, apply_chi0_generic, apply_dV, make_chi0_context
from .hessian import apply_kernel, gmres
from ..parallel.mesh import refuse_distributed


def _dVloc_grids(basis):
    """d V_loc / d u_{s, alpha}: real grids [n_atoms, 3, n1, n2, n3] (float64
    on the basis' device).

    V_loc(G) = sum_s ff_s(|G|) e^{-2 pi i G_red . r_s} / sqrt(vol);
    d/d u_cart,alpha brings down (-i G_cart,alpha)."""
    model = basis.model
    Gnorm = basis.G_cube_cart_norm.reshape(-1)
    Gred = basis.G_cube.reshape(-1, 3).astype(float)
    Gcart = torch.as_tensor(basis.G_cube_cart.reshape(-1, 3), device=basis.device)
    N = int(np.prod(basis.fft_size))
    sqrt_vol = math.sqrt(model.unit_cell_volume)
    out = torch.zeros((len(model.atoms), 3) + tuple(basis.fft_size), dtype=torch.float64,
                      device=basis.device)
    ff_cache = {}
    for s, at in enumerate(model.atoms):
        if not hasattr(at, "local_potential_fourier"):
            continue
        if at not in ff_cache:
            ff_cache[at] = np.asarray(at.local_potential_fourier(Gnorm))
        phase = np.exp(-2j * math.pi * (Gred @ np.asarray(model.positions[s])))
        base = torch.as_tensor(ff_cache[at] * phase / sqrt_vol, device=basis.device)
        dv = (-1j * Gcart.T) * base                                     # [3, N]
        out[s] = torch.fft.ifftn(dv.reshape((3,) + tuple(basis.fft_size)),
                                 dim=(-3, -2, -1)).real * (N / sqrt_vol)
    return out


def _atom_of_projector_column(basis):
    """[n_proj] atom index per nonlocal projector column (ops/terms.py order)."""
    model = basis.model
    cols = []
    for group in model.atom_groups:
        if isinstance(model.atoms[group[0]], ElementPsp):
            np_atom = model.atoms[group[0]].psp.n_proj()
            for atom_idx in group:
                cols.extend([atom_idx] * np_atom)
    return np.array(cols, dtype=int)


def _nonlocal_derivative(P, dP, D, psi, P_out=None, dP_out=None):
    """dP D P^dag psi + P D dP^dag psi [nk, nb, nG]: the first-order change
    of the nonlocal apply when the projectors P [nk, nG, nproj] move by dP.
    P_out and dP_out (default P and dP) are the projectors and their change
    on the output side where it lies on other spheres than psi: at q, the
    k+q partners' P[perm] (`response/phonon_q.py::_bare_rhs_q`)."""
    def DPd(Q):
        return torch.einsum("pq,knq->knp", D, torch.einsum("kgp,kng->knp", Q.conj(), psi))
    P_out = P if P_out is None else P_out
    dP_out = dP if dP_out is None else dP_out
    return (torch.einsum("kgp,knp->kng", dP_out, DPd(P))
            + torch.einsum("kgp,knp->kng", P_out, DPd(dP)))


def _bare_rhs(basis, ctx, dVloc):
    """rhs[j] [nk, nb, nG] = dH^{(j)}_bare psi for j = (s, alpha) flattened;
    dVloc [n_atoms, 3, n1, n2, n3] from `_dVloc_grids`."""
    bd = basis.data
    psi = ctx.psi
    nspin = basis.model.n_spin_components
    P, D = ctx.ham.P, ctx.ham.D.to(psi.dtype)
    have_nl = P is not None and P.shape[-1] > 0
    if have_nl:
        atom_col = _atom_of_projector_column(basis)

    rhs = []
    for s in range(dVloc.shape[0]):
        for alpha in range(3):
            dV = dVloc[s, alpha].expand((nspin,) + tuple(basis.fft_size))
            r = apply_dV(ctx.ham, psi, dV, bd.kspin)
            if have_nl:
                sel = basis.tensor((atom_col == s).astype(float))
                dP = (-1j) * bd.Gpk_cart[:, :, alpha, None] * P * sel[None, None, :]
                r = r + _nonlocal_derivative(P, dP, D, psi)
            rhs.append(r * bd.mask[:, None, :])
    return rhs


def clamped_ion_hessian(scfres, basis=None):
    """d2E / dr dr' [n_atoms, 3, n_atoms, 3] in fractional positions at
    fixed psi, occupations and rho: the Hessian of the forces' position
    energy (`postprocess/forces.py::_positions_energy`) by double backward,
    float64 on the basis' device."""
    refuse_distributed(basis or scfres.basis, "clamped_ion_hessian")
    from ..postprocess.forces import _positions_energy
    basis = basis or scfres.basis
    dev = basis.device
    psi = torch.as_tensor(scfres.psi, device=dev).to(torch.complex128)
    occ = torch.as_tensor(scfres.occupation, device=dev).to(torch.float64)
    rho = torch.as_tensor(scfres.rho, device=dev).to(torch.float64)
    positions = torch.as_tensor(np.stack(basis.model.positions), dtype=torch.float64,
                                device=dev)
    with torch.enable_grad():
        return torch.autograd.functional.hessian(
            lambda pos: _positions_energy(basis, psi, occ, rho, pos), positions)


def screened_response(ctx, basis, rho0, rhs, tol, sternheimer_tol, verbose=False):
    """(dpsi, df) of the self-consistent response to a bare perturbation
    rhs = dH psi [nk, nb, nG]: the Dyson equation (1 - chi0 K) drho =
    chi0 rhs by GMRES, then one detailed chi0 apply of rhs + dV_ind psi
    (the induced dV = K drho through `apply_dV`); K is
    `response/hessian.py::apply_kernel` at rho0."""
    def K(drho):
        return apply_kernel(basis, rho0, drho)

    def matvec(drho):
        return drho - apply_chi0(ctx, basis, K(drho), tol=sternheimer_tol)

    drho_bare = apply_chi0_generic(ctx, basis, rhs, tol=sternheimer_tol)
    drho = gmres(matvec, drho_bare, tol=tol, verbose=verbose)
    dV_ind = K(drho)
    rhs_tot = rhs + apply_dV(ctx.ham, ctx.psi, dV_ind, basis.data.kspin)
    _, dpsi, df, _ = apply_chi0_generic(ctx, basis, rhs_tot, tol=sternheimer_tol,
                                        with_detail=True)
    return dpsi, df


def response_matrix(basis, psi, w, rhs, dpsi, df=None):
    """M[a, b] = 2 Re sum_kn w <dpsi_b | rhs_a> (+ sum_kn w_k df_b
    <psi|rhs_a>_nn where df is given), numpy [n, n]: one host read."""
    R, dP = torch.stack(rhs), torch.stack(dpsi)
    M = 2.0 * torch.einsum("kn,bkng,akng->ab", w.to(R.dtype), dP.conj(), R).real
    if df is not None:
        dVnn = torch.einsum("kng,akng->akn", psi.conj(), R).real
        M = M + torch.einsum("k,bkn,akn->ab", basis.data.kweights, torch.stack(df), dVnn)
    return M.cpu().numpy()


def refuse_pairwise(model, what):
    """The JAX package's DFPT dynamical matrices have no PairwisePotential
    part: their clamped-ion Hessian is that of the forces' position energy,
    to which the pairwise forces are added only as constants."""
    refuse_terms(model, what, ["PairwisePotential"],
                 "the JAX package's clamped-ion Hessian leaves the pairwise energy out "
                 "(dftk_tpu/response/phonon_dfpt.py, dftk_tpu/response/phonon_q.py; "
                 "the finite-difference phonons of postprocess/phonon.py include it)")


def dynmat_dfpt_gamma(scfres, tol=1e-7, sternheimer_tol=1e-10, acoustic_sum_rule=True,
                      verbose=False):
    """Cartesian force-constant matrix [3 na, 3 na] (numpy) at q = 0 by DFPT.

    Works for insulators and metals (T > 0: the free-energy second
    derivative adds the occupation-response term sum w df <psi|dV|psi> and
    the divided-difference band pairs inside chi0; de Gironcoli, PRB 51,
    6773 (1995)).  Requires a tightly converged result (an SCFResult, or
    an `interop.SCFState`).  Mass-weight and diagonalize with
    `postprocess.phonon.phonon_modes_from_dynmat`."""
    # a single-atom displacement does not have the crystal symmetry: the
    # response is evaluated on the full k-point set
    refuse_distributed(scfres.basis, "dynmat_dfpt_gamma")
    from ..postprocess.unfold import unfold_bz
    refuse_pairwise(scfres.basis.model, "dynmat_dfpt_gamma")
    scfres = unfold_bz(scfres)
    basis = scfres.basis
    model = basis.model
    metallic = model.temperature > 0
    na = len(model.atoms)
    rho0 = torch.as_tensor(scfres.rho, dtype=basis.rdtype, device=basis.device)
    ctx = make_chi0_context(scfres, basis)

    H_red = clamped_ion_hessian(scfres, basis).cpu().numpy()       # [na,3,na,3] reduced
    Linv = np.linalg.inv(model.lattice)
    C = np.einsum("aA,satb,bB->sAtB", Linv, H_red, Linv).reshape(3 * na, 3 * na)

    rhs_list = _bare_rhs(basis, ctx, _dVloc_grids(basis))
    dpsi_all, df_all = [], []
    for j, rhs in enumerate(rhs_list):
        dpsi, df = screened_response(ctx, basis, rho0, rhs, tol, sternheimer_tol, verbose)
        dpsi_all.append(dpsi)
        df_all.append(df)
        if verbose:
            print(f"  perturbation {j + 1}/{len(rhs_list)} solved")

    w = basis.data.kweights[:, None] * ctx.occupation
    C = C + response_matrix(basis, ctx.psi, w, rhs_list, dpsi_all,
                            df_all if metallic else None)
    C = (C + C.T) / 2
    if acoustic_sum_rule:
        blocks = C.reshape(na, 3, na, 3)
        corr = blocks.sum(axis=2)                     # [na, 3, 3]
        for s in range(na):
            blocks[s, :, s, :] -= corr[s]
        C = blocks.reshape(3 * na, 3 * na)
    return C


def phonon_modes_dfpt_gamma(scfres, **kwargs):
    """Frequencies (Ha) + eigenvectors at Gamma from the DFPT dynmat."""
    from ..postprocess.phonon import phonon_modes_from_dynmat
    C = dynmat_dfpt_gamma(scfres, **kwargs)
    return phonon_modes_from_dynmat(C, scfres.basis.model.atoms)
