"""Newton SCF for insulators: solve (Omega + K) dpsi = -residual.

Port of `dftk_tpu/scf/newton.py` (reference `src/scf/newton.jl` and
`src/response/hessian.jl:31-115`):
  * residual   r_n = P_c H psi_n,  P_c = 1 - psi psi^dag
  * Omega dpsi = P_c (H - eps_n) P_c dpsi
  * K dpsi     = P_c [K_Hxc(drho[dpsi]) psi]_n,  drho = 2 sum_n w f Re(conj(psi_n) dpsi_n)
with the Hessian (`response/hessian.py::omega_plus_k_operators`, K
applied exactly, the density change symmetrized like the density) solved
by preconditioned CG (`response/hessian.py::preconditioned_cg`, one host
read of the residual norm a step).  Every apply of H
and every dV psi goes through the kernels A -> B -> A on a CUDA tensor.
Quadratic convergence near the minimum; a few steps of the LOBPCG SCF
warm-start it.  The JAX package's Newton reports no PairwisePotential
energy and drops the Anyonic term, so a model with either raises here.
"""
import time

import torch

from ..ops import hamiltonian as hamops
from ..ops.density import compute_density, make_symmetrizer
from ..ops.eigen.lobpcg import ortho_qr
from ..response.hessian import omega_plus_k_operators, preconditioned_cg
from ..ops.terms import refuse_anyonic, refuse_terms
from .driver import SCFResult, self_consistent_field
from ..parallel.mesh import refuse_distributed


@torch.no_grad()
def newton(basis, tol=1e-10, maxiter=20, cg_tol_ratio=1e-3, cg_maxiter=100, psi=None,
           scf_start_iters=2, callback=None, seed=42) -> SCFResult:
    """Newton iteration on the orbitals for insulating systems."""
    refuse_distributed(basis, "newton")
    t0 = time.time()
    model = basis.model
    terms = basis.terms
    if model.temperature > 0:
        raise ValueError("newton supports insulators only (like the reference)")
    refuse_anyonic(model, "newton")
    refuse_terms(model, "newton", ["PairwisePotential"],
                 "the JAX package's Newton adds no pairwise energy "
                 "(dftk_tpu/scf/newton.py:79,165-166)")
    nspin = model.n_spin_components
    filled = model.filled_occupation
    n_occ = model.n_electrons // filled
    bd, td = basis.data, terms.data
    fft_size, volume = basis.fft_size, model.unit_cell_volume
    occ = torch.full((basis.n_kpoints, n_occ), float(filled), dtype=basis.rdtype,
                     device=basis.device)
    # the symmetrized-density functional of self_consistent_field (linear, so the
    # density derivative through it is exact)
    symmetrizer = make_symmetrizer(basis)

    if psi is None:               # warm start: a few cheap SCF steps
        res0 = self_consistent_field(basis, tol=1e-2, maxiter=scf_start_iters, n_bands=n_occ,
                                     n_extra_bands=2, seed=seed)
        psi = res0.psi[:, :n_occ]
    psi = ortho_qr(torch.as_tensor(psi, device=basis.device, dtype=basis.dtype))

    def newton_rhs(psi):
        rho = compute_density(bd, psi, occ, fft_size, volume, nspin, symmetrizer=symmetrizer)
        V, _, energies = hamops.total_potential(terms, rho, volume)
        ham = hamops.build_ham(bd, td, V, basis.pruned)
        hpsi = hamops.apply_H(ham, psi)
        lam = torch.einsum("kng,kmg->knm", psi.conj(), hpsi)
        r = hpsi - torch.einsum("knm,kng->kmg", lam, psi)          # P_c H psi
        energies.update(hamops.psi_energies(ham, psi, occ, bd.kweights))
        E = sum(energies.values()) + terms.E_ewald + terms.E_psp_correction
        return r, rho, ham, lam, E, energies

    E_prev, converged, info = None, False, None
    for it in range(maxiter):
        r, rho, ham, lam, E, energies = newton_rhs(psi)
        rnorm = float(torch.linalg.vector_norm(r))
        E = float(E)
        if callback:
            callback(dict(n_iter=it + 1, E=E, rnorm=rnorm))
        info = (rho, lam, energies)
        if E_prev is not None and abs(E - E_prev) < tol and rnorm < 1e-6:
            converged = True
            break
        E_prev = E
        hessian, _, precond = omega_plus_k_operators(
            basis, ham, psi, occ, rho, torch.diagonal(lam, dim1=-2, dim2=-1).real,
            symmetrizer=symmetrizer)
        dpsi = preconditioned_cg(hessian, precond, -r, max(cg_tol_ratio * rnorm, 1e-12),
                                 cg_maxiter)
        psi = ortho_qr((psi + dpsi) * bd.mask[:, None, :])

    rho, lam, energies = info
    w, Y = torch.linalg.eigh((lam + lam.conj().transpose(1, 2)) / 2)
    psi = torch.einsum("knm,kng->kmg", Y, psi)
    energies_out = {k: float(v) for k, v in energies.items()}
    energies_out["Ewald"] = terms.E_ewald
    energies_out["PspCorrection"] = terms.E_psp_correction
    energies_out["total"] = float(sum(energies_out.values()))
    eigenvalues = w.cpu().numpy()
    return SCFResult(
        basis=basis, energies=energies_out, eigenvalues=eigenvalues,
        occupation=occ.cpu().numpy(), psi=psi, rho=rho, epsF=float(eigenvalues.max()),
        converged=bool(converged), n_iter=it + 1, n_bands_converge=n_occ, history_Etot=[],
        history_Drho=[], n_matvec=0, runtime_s=time.time() - t0)
