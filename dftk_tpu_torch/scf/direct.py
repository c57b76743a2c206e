"""Direct minimization of the Kohn-Sham energy over the orbitals.

Port of `dftk_tpu/scf/direct.py` (reference
`src/scf/direct_minimization.jl`, which runs Optim's LBFGS on the Stiefel
manifold): Riemannian TPA-preconditioned gradient descent with momentum,
the orthonormalising retraction and Armijo backtracking, for insulators.
The total energy is one differentiable function of the orbitals
(`energy_from_orbitals`), whose gradient `torch.autograd` supplies.

The gradient convention: torch's gradient of a real function of a complex
tensor is dE/dRe + i dE/dIm, the steepest-ascent direction, which is the
conjugate of what `jax.grad` returns; so the JAX package's `g.conj()`
(`dftk_tpu/scf/direct.py:104`) has no counterpart here (ROADMAP "Known
differences: Complex gradients").

Every term of the model enters the energy: the kinetic blow-ups through
the explicit kinetic (which the TPA preconditioner reads too), Magnetic
through `psi_energies`, LocalNonlinearity through `density_energies`, and
the Anyonic term as `ops/anyonic.py::anyonic_energy` of the orbitals and
their density, whose autograd gradient carries the reference's
current-response operator (this solver is the anyons' one, as in the
reference example examples/anyons.jl).  The JAX package's direct
minimization adds no PairwisePotential energy
(`dftk_tpu/scf/direct.py:45,176-178`), so a model with one raises here.
"""
import math
import time
from typing import Optional

import torch

from ..ops import hamiltonian as hamops
from ..ops.anyonic import anyonic_energy
from ..ops.density import compute_density, guess_density, make_symmetrizer
from ..ops.eigen.lobpcg import lobpcg, ortho_qr
from ..ops.terms import refuse_terms
from .driver import SCFResult, random_orbitals
from ..parallel.mesh import refuse_distributed


def _anyonic_energy(basis, psi, occupation, rho):
    """The Anyonic energy of psi at its density rho [nspin, grid]."""
    hbar, beta, rho_ref, Aref = basis.terms.anyonic
    t = lambda a: basis.tensor(a).to(rho.dtype)
    return anyonic_energy(basis.data, psi, occupation, torch.sum(rho, dim=0), t(rho_ref),
                          t(Aref), basis.terms.data.G_cart.to(rho.dtype), hbar, beta,
                          basis.fft_size, basis.model.unit_cell_volume)


def energy_from_orbitals(basis, psi, occupation, symmetrizer=None):
    """(E, rho): the total energy without entropy of orthonormal psi [nk, nb,
    nG] at fixed occupations, differentiable in psi (the XC energy of the
    live density, `ops/hamiltonian.py::density_energies`), and its density."""
    refuse_distributed(basis, "energy_from_orbitals")
    model = basis.model
    terms = basis.terms
    bd, td = basis.data, terms.data
    rho = compute_density(bd, psi, occupation, basis.fft_size, model.unit_cell_volume,
                          model.n_spin_components, symmetrizer=symmetrizer)
    energies = hamops.density_energies(terms, rho, model.unit_cell_volume)
    # the kinetic, nonlocal and magnetic energies need no potential
    ham = hamops.build_ham(bd, td, None, basis.pruned)
    energies.update(hamops.psi_energies(ham, psi, occupation, bd.kweights))
    if terms.anyonic is not None:
        energies["Anyonic"] = _anyonic_energy(basis, psi, occupation, rho)
    return sum(energies.values()) + terms.E_ewald + terms.E_psp_correction, rho


@torch.no_grad()
def direct_minimization(basis, tol=1e-8, maxiter=300, psi=None, n_bands: Optional[int] = None,
                        step: float = 1.0, momentum: float = 0.7, seed: int = 42,
                        callback=None) -> SCFResult:
    """Minimize E[psi] at fixed integer occupations (insulators only)."""
    refuse_distributed(basis, "direct_minimization")
    t0 = time.time()
    model = basis.model
    terms = basis.terms
    if model.temperature > 0:
        raise ValueError("direct_minimization supports insulators only (zero temperature), "
                         "like the reference")
    refuse_terms(model, "direct_minimization", ["PairwisePotential"],
                 "the JAX package's direct minimization adds no pairwise energy "
                 "(dftk_tpu/scf/direct.py:45,176-178)")
    filled = model.filled_occupation
    n_occ = model.n_electrons // filled
    if n_bands is None:
        n_bands = n_occ
    bd = basis.data
    volume = model.unit_cell_volume
    if psi is None:
        # warm start: one diagonalisation of H at the guess density (random
        # orbitals make the descent unstable)
        V0, _, _ = hamops.total_potential(terms, guess_density(basis), volume)
        ham0 = hamops.build_ham(bd, terms.data, V0, basis.pruned)
        psi = lobpcg(lambda p: hamops.apply_H(ham0, p), random_orbitals(basis, n_bands, seed=seed),
                     ham0.kin, bd.mask, tol=1e-4, maxiter=60).X
    psi = torch.as_tensor(psi, device=basis.device, dtype=basis.dtype)
    occ = torch.full((basis.n_kpoints, n_bands), float(filled), dtype=basis.rdtype,
                     device=basis.device)
    kin = hamops.kinetic(bd, terms.data)
    # the symmetrized-density functional of self_consistent_field (the symmetrizer
    # is linear, so autograd through it is exact)
    symmetrizer = make_symmetrizer(basis)

    def energy(p):
        return energy_from_orbitals(basis, p, occ, symmetrizer)[0]

    wocc = bd.kweights[:, None] * occ

    def gradient(p):
        """The Riemannian, TPA-preconditioned descent data at p: (natural
        gradient g, preconditioned pg)."""
        with torch.enable_grad():
            x = p.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(energy(x), x)
        # natural gradient: divide out the weight * occupation (g = 2 w f H psi)
        g = g / (2 * wocc[:, :, None])
        ov = torch.einsum("kng,kmg->knm", p.conj(), g)
        g = g - torch.einsum("knm,kng->kmg", (ov + ov.conj().transpose(1, 2)) / 2, p)
        mean_kin = torch.clamp(torch.einsum("kng,kg,kng->kn", p.conj(), kin.to(p.dtype),
                                            p).real, min=1e-12)
        return g, g * (mean_kin[:, :, None] / (mean_kin[:, :, None] + kin[:, None, :] + 1e-20))

    def move(p, vel, pg, tau):
        vel = momentum * vel - tau * pg
        p_new = ortho_qr((p + vel) * bd.mask[:, None, :])
        O = torch.einsum("kng,kmg->knm", p_new.conj(), p_new)
        eye = torch.eye(O.shape[-1], dtype=O.dtype, device=O.device)
        return p_new, vel, float((O - eye).abs().max())

    def bad(e, oerr):
        # a retraction that lost orthonormality, a NaN or a higher energy
        return not math.isfinite(e) or e > E_cur + 1e-14 or oerr > 1e-8

    vel = torch.zeros_like(psi)
    E_prev, converged = None, False
    tau = step
    E_cur = float(energy(psi))
    for it in range(maxiter):
        g, pg = gradient(psi)
        gnorm = float(torch.linalg.vector_norm(g))
        psi_new, vel_new, oerr = move(psi, vel, pg, tau)
        E_new = float(energy(psi_new))
        n_bt = 0
        while bad(E_new, oerr) and n_bt < 12:           # Armijo backtracking
            tau = tau / 2
            vel = torch.zeros_like(vel)
            psi_new, vel_new, oerr = move(psi, vel, pg, tau)
            E_new = float(energy(psi_new))
            n_bt += 1
        if bad(E_new, oerr):
            converged = abs(E_cur - (E_prev if E_prev is not None else 0)) < tol
            break          # no progress: keep the last good iterate
        if n_bt == 0:
            tau = min(tau * 1.2, step)
        psi, vel = psi_new, vel_new
        E_prev, E_cur = E_cur, E_new
        if callback:
            callback(dict(n_iter=it + 1, E=E_cur, gnorm=gnorm))
        if abs(E_cur - E_prev) < tol and gnorm < 1e-3:
            converged = True
            break

    # Rayleigh-Ritz in the converged subspace
    _, rho = energy_from_orbitals(basis, psi, occ, symmetrizer)
    V, _, energies = hamops.total_potential(terms, rho, volume)
    ham = hamops.build_ham(bd, terms.data, V, basis.pruned)
    hsub = torch.einsum("kng,kmg->knm", psi.conj(), hamops.apply_H(ham, psi))
    w, Y = torch.linalg.eigh((hsub + hsub.conj().transpose(1, 2)) / 2)
    psi = torch.einsum("knm,kng->kmg", Y, psi)
    energies.update(hamops.psi_energies(ham, psi, occ, bd.kweights))
    if terms.anyonic is not None:
        energies["Anyonic"] = _anyonic_energy(basis, psi, occ, rho)
    energies_out = {k: float(v) for k, v in energies.items()}
    energies_out["Ewald"] = terms.E_ewald
    energies_out["PspCorrection"] = terms.E_psp_correction
    energies_out["total"] = float(sum(energies_out.values()))
    eigenvalues = w.cpu().numpy()
    return SCFResult(
        basis=basis, energies=energies_out, eigenvalues=eigenvalues,
        occupation=occ.cpu().numpy(), psi=psi, rho=rho,
        epsF=float(eigenvalues[:, :n_occ].max()), converged=bool(converged), n_iter=it + 1,
        n_bands_converge=n_bands, history_Etot=[], history_Drho=[], n_matvec=0,
        runtime_s=time.time() - t0, V_local=V)
