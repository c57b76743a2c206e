"""Post-SCF refinement on a finer basis (the two-grid scheme).

Port of `dftk_tpu/postprocess/refine.py` (reference
`src/postprocess/refine.jl`, Cances/Dusson/Kemlin/Levitt 2022): after
converging on a coarse Ecut, transfer to a larger Ecut basis and compute
the first-order correction delta_psi by the Schur-complement split of
(Omega + K) (reference refine.jl:116-168):

  * high frequencies (outside the coarse basis): one TPA-metric solve
      e2 = M^{-1} res_HF,   M_n = tpa_shift * mean_kin[n] + kin
  * low frequencies (the coarse space): a full (Omega + K) solve
      (Omega + K) e1 = res_LF - [(Omega + K) e2]_LF
    by the CG of `response/hessian.py::solve_omega_plus_k`.

delta_psi = e1 + e2 and delta_rho (the exact first-order change of the
density, which is bilinear in psi: `ops/density.py::
compute_density_derivative`) then refine energies and forces.
`refine_forces` is the directional derivative of the force functional
along (delta_psi, delta_rho): the JAX package takes `jax.jvp` of
`jax.grad`; here it is reverse over reverse, the gradient in the positions
of the energy's directional derivative along (delta_psi, delta_rho), two
backward passes whatever the atom count.  Every apply of H runs on the
basis' device (through the local-apply kernels on a card).
"""
import numpy as np
import torch

from ..basis import PlaneWaveBasis
from ..ops import hamiltonian as hamops
from ..ops.density import compute_density, compute_density_derivative, make_symmetrizer
from ..ops.eigen.lobpcg import ortho_qr
from ..response.chi0 import _project_out
from ..transfer import transfer_blochwave
from ..parallel.mesh import refuse_distributed


class RefinementResult:
    """psi/rho and their first-order corrections on the fine basis.

    Mirrors the reference RefinementResult (refine.jl:95-105): the refined
    quantities are psi + dpsi and rho + drho.
    """
    pass


@torch.no_grad()
def refine_scfres(scfres, Ecut_fine, tpa_shift=1.0, cg_tol=1e-8, cg_maxiter=200):
    """Refine a converged scfres on a finer basis (insulators).

    tpa_shift scales the per-band mean-kinetic shift of the TPA refinement
    metric M_n = tpa_shift * <psi_n|T|psi_n> + kin used on the
    high-frequency complement (reference invert_refinement_metric,
    refine.jl:43-85; 1.0 = the reference metric).  The fine basis is built
    on the coarse one's device and dtype.
    """
    refuse_distributed(scfres.basis, "refine_scfres")
    from ..response.hessian import make_omega_plus_k, solve_omega_plus_k
    from ..scf.driver import constant_energies
    basis = scfres.basis
    model = basis.model
    dev = basis.device
    occ_np = np.array(scfres.occupation, dtype=float)
    n_occ = int(np.sum(occ_np[0] > 1e-8))
    psi_c = torch.as_tensor(scfres.psi, device=dev)[:, :n_occ]
    occ = torch.as_tensor(occ_np[:, :n_occ], device=dev, dtype=basis.rdtype)

    fine = PlaneWaveBasis(model, Ecut=Ecut_fine, kgrid=basis.kgrid, fft_size=None,
                          device=dev, dtype=basis.dtype,
                          use_symmetries_for_kpoint_reduction=
                          basis.use_symmetries_for_kpoint_reduction)
    bd, td = fine.data, fine.terms.data
    mask = bd.mask[:, None, :]
    psi = ortho_qr(transfer_blochwave(psi_c, basis, fine) * mask)

    vol = model.unit_cell_volume
    nspin = model.n_spin_components
    symmetrizer = make_symmetrizer(fine)

    rho = compute_density(bd, psi, occ, fine.fft_size, vol, nspin, symmetrizer=symmetrizer)
    V, _, _ = hamops.total_potential(fine.terms, rho, vol)
    ham = hamops.build_ham(bd, td, V, fine.pruned)
    hpsi = hamops.apply_H(ham, psi)
    R = _project_out(hpsi, psi)
    res = -R                                     # reference refine.jl:136

    # frequency split of the residual across the two bases
    res_LF_c = transfer_blochwave(res, fine, basis)      # coarse coefficients
    res_HF = res - transfer_blochwave(res_LF_c, basis, fine)

    # ---- high frequencies: TPA metric solve (refine.jl:43-85) -------------
    kin = ham.kin                                         # [nk, nG]
    mean_kin = torch.einsum("kng,kg,kng->kn", psi.conj(), kin.to(psi.dtype), psi).real
    denom = torch.clamp(tpa_shift * mean_kin[:, :, None] + kin[:, None, :], min=1e-3)
    e2 = (res_HF / denom) * mask
    e2 = _project_out(e2, psi)

    # ---- low frequencies: (Omega + K) solve on the coarse space -------------
    OmegaK_fine, _, _ = make_omega_plus_k(fine, psi, occ, rho=rho)
    rhs = transfer_blochwave(OmegaK_fine(e2), fine, basis) - res_LF_c
    # solve_omega_plus_k solves (Omega + K) x = -P_c rhs, the reference
    # solve_OmegaplusK convention (refine.jl:158)
    e1_c = solve_omega_plus_k(basis, psi_c, occ, rhs, cg_tol=cg_tol, cg_maxiter=cg_maxiter)
    e1 = transfer_blochwave(e1_c, basis, fine)

    dpsi = (e1 + e2) * mask
    # first-order density correction (refine.jl:170)
    drho = compute_density_derivative(bd, psi, dpsi, occ, fine.fft_size, vol, nspin,
                                      symmetrizer=symmetrizer)

    psi_ref = ortho_qr(psi + dpsi)
    rho_ref = compute_density(bd, psi_ref, occ, fine.fft_size, vol, nspin,
                              symmetrizer=symmetrizer)
    V2, _, energies2 = hamops.total_potential(fine.terms, rho_ref, vol)
    ham2 = hamops.build_ham(bd, td, V2, fine.pruned)
    energies2.update(hamops.psi_energies(ham2, psi_ref, occ, bd.kweights))
    energies_out = {k: float(v) for k, v in energies2.items()}
    energies_out.update(constant_energies(fine.terms))
    energies_out["total"] = float(sum(energies_out.values()))

    out = RefinementResult()
    out.basis = fine
    out.psi = psi_ref
    out.rho = rho_ref
    out.psi0 = psi                       # transferred, unrefined
    out.dpsi = dpsi
    out.rho0 = rho
    out.drho = drho
    out.occupation = occ.cpu().numpy()
    out.energies = energies_out
    out.total_energy = energies_out["total"]
    out.residual_norm = float(torch.linalg.vector_norm(R))
    return out


def refine_forces(refinement):
    """First-order force correction from the refinement (refine.jl:190-203).

    Returns dict with F (forces at the transferred state), dF (directional
    derivative of the force functional along (dpsi, drho)), and
    F_refined = F + dF, numpy [n_atoms, 3] in reduced coordinates.  dF is
    the gradient in the positions of Re<grad_psi E, dpsi> + <grad_rho E,
    drho> (torch's gradient in a complex tensor is the conjugate of
    jax.grad's, so the pairing is Re(sum(conj(g) dpsi))).
    """
    from .forces import _positions_energy, f64
    fine = refinement.basis
    dev = fine.device
    occ = torch.as_tensor(refinement.occupation, device=dev, dtype=torch.float64)
    c128 = torch.complex128
    with torch.enable_grad():
        positions = f64(fine, np.stack(fine.model.positions)).requires_grad_(True)
        psi = refinement.psi0.detach().to(c128).requires_grad_(True)
        rho = refinement.rho0.detach().to(torch.float64).requires_grad_(True)
        E = _positions_energy(fine, psi, occ, rho, positions)
        g_pos, g_psi, g_rho = torch.autograd.grad(E, (positions, psi, rho), create_graph=True,
                                                  allow_unused=True)
        D = torch.zeros((), dtype=torch.float64, device=dev)
        if g_psi is not None:
            D = D + torch.sum(g_psi.conj() * refinement.dpsi.to(c128)).real
        if g_rho is not None:
            D = D + torch.sum(g_rho * refinement.drho.to(torch.float64))
        (dg,) = (torch.autograd.grad(D, positions, allow_unused=True) if D.requires_grad
                 else (None,))
    F = -g_pos.detach().cpu().numpy()
    dF = np.zeros_like(F) if dg is None else -dg.cpu().numpy()
    if fine.terms.pairwise_forces is not None:
        F = F + fine.terms.pairwise_forces
    return {"F": F, "dF": dF, "F_refined": F + dF}


def refine_forces_cart(refinement):
    """Cartesian refined forces (symmetrized), numpy [n_atoms, 3]."""
    from .forces import symmetrize_forces
    model = refinement.basis.model
    res = refine_forces(refinement)
    inv_lat = np.linalg.inv(model.lattice)
    return {key: symmetrize_forces(refinement.basis, torch.as_tensor(f)).numpy() @ inv_lat
            for key, f in res.items()}
