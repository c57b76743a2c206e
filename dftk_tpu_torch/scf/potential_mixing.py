"""SCF by mixing in potential space (reference `src/scf/potential_mixing.jl`).

Port of `dftk_tpu/scf/potential_mixing.py`: the fixed point is on the total
local potential, V_out = V[rho(V_in)], with Anderson acceleration and the
reference's quadratic-model AdaptiveDamping: a trial step that raises the
energy is backtracked from the previous potential with the step length
that minimises the quadratic model fitted to (E_prev, slope, E_trial),
the slope along the step being dE/dalpha ~ dvol <dV_dir, rho_out - rho_in>
(potential_mixing.jl:29-160).  Each step's LOBPCG applies H through the
kernels; at T > 0 the energy carries the Entropy term.  The JAX package's
loop reports no PairwisePotential energy and drops the Anyonic term, so a
model with either raises here.
"""
import math
import time

import torch

from ..ops import hamiltonian as hamops
from ..ops.density import compute_density, guess_density, make_symmetrizer
from ..ops.eigen.lobpcg import lobpcg
from ..ops.occupation import compute_occupation, entropy_energy
from .anderson import AndersonAcceleration
from ..ops.terms import refuse_anyonic, refuse_terms
from .driver import SCFResult, random_orbitals
from ..parallel.mesh import refuse_distributed


@torch.no_grad()
def scf_potential_mixing(basis, tol=1e-6, maxiter=100, damping=0.8, anderson_depth=10,
                         n_bands=None, n_extra_bands=None, eigensolver_maxiter=100,
                         callback=None, seed=42) -> SCFResult:
    """The eigensolver tolerance is min(5e-3, dV / 10), at least tol / 100."""
    refuse_distributed(basis, "scf_potential_mixing")
    t0 = time.time()
    model = basis.model
    terms = basis.terms
    refuse_anyonic(model, "scf_potential_mixing")
    refuse_terms(model, "scf_potential_mixing", ["PairwisePotential"],
                 "the JAX package's potential mixing adds no pairwise energy "
                 "(dftk_tpu/scf/potential_mixing.py:94-95)")
    nspin = model.n_spin_components
    filled = model.filled_occupation
    if n_bands is None:
        n_bands = model.default_n_bands()
    if n_extra_bands is None:
        n_extra_bands = max(3, n_bands // 10)

    rho = guess_density(basis)
    psi = random_orbitals(basis, n_bands + n_extra_bands, seed=seed)
    symmetrizer = make_symmetrizer(basis)
    bd, td = basis.data, terms.data
    volume = model.unit_cell_volume
    dvol = basis.dvol

    def step(V_in, psi_in, diagtol):
        ham = hamops.build_ham(bd, td, V_in, basis.pruned)
        res = lobpcg(lambda p: hamops.apply_H(ham, p), psi_in, ham.kin, bd.mask, tol=diagtol,
                     maxiter=eigensolver_maxiter, n_conv=n_bands)
        occ, epsF = compute_occupation(res.eigenvalues, bd.kweights, model.n_electrons,
                                       filled, model.temperature, model.smearing)
        rho_out = compute_density(bd, res.X, occ, basis.fft_size, volume, nspin,
                                  symmetrizer=symmetrizer)
        V_out, _, energies = hamops.total_potential(terms, rho_out, volume)
        # the kinetic and nonlocal parts of H do not depend on V
        energies.update(hamops.psi_energies(ham, res.X, occ, bd.kweights))
        if terms.has_entropy:
            energies["Entropy"] = entropy_energy(res.eigenvalues, bd.kweights, epsF,
                                                 model.temperature, model.smearing, filled)
        return V_out, rho_out, res.X, res.eigenvalues, occ, epsF, energies

    V, _, _ = hamops.total_potential(terms, rho, volume)
    anderson = AndersonAcceleration(m=anderson_depth)
    alpha = damping
    alpha_min, alpha_max = 0.05, max(1.0, damping)
    E_prev, info, converged = None, None, False
    rho_prev = rho
    V_prev, psi_prev = None, None
    backtracks_left = 0
    history_E, history_dV = [], []
    E_const = {"Ewald": terms.E_ewald, "PspCorrection": terms.E_psp_correction}
    it = n_steps = 0
    while it < maxiter and n_steps < 3 * maxiter:
        n_steps += 1
        diagtol = max(min(5e-3, (history_dV[-1] if history_dV else 1) * 0.1), tol / 100)
        V_out, rho_out, psi_new, eigvals, occ, epsF, energies = step(V, psi, diagtol)
        E_total = float(sum(float(v) for v in energies.values()) + sum(E_const.values()))

        if (E_prev is not None and backtracks_left > 0
                and E_total > E_prev + max(1e-10, 0.1 * tol)):
            # quadratic-model backtracking along dV_dir = (V - V_prev)/alpha from
            # E(0) = E_prev, E'(0) = slope, E(alpha) = E_total
            dV_dir = (V - V_prev) / alpha
            slope = float(torch.sum(dV_dir * (rho_out - rho_prev))) * dvol
            denom = 2 * (E_total - E_prev - slope * alpha)
            alpha_model = slope * alpha ** 2 / denom if abs(denom) > 1e-300 else alpha / 2
            if not (alpha_min <= alpha_model <= 0.75 * alpha):
                alpha_model = max(alpha / 2, alpha_min)
            alpha = alpha_model
            anderson.reset()
            backtracks_left -= 1
            V = V_prev + alpha * dV_dir        # redo from the previous state
            psi = psi_prev
            continue

        # accepted
        psi = psi_new
        dV = V_out - V
        ndV = float(torch.linalg.vector_norm(dV)) * math.sqrt(dvol)
        history_E.append(E_total)
        history_dV.append(ndV)
        it += 1
        if callback:
            callback(dict(n_iter=it, E=E_total, dV=ndV, alpha=alpha))
        converged = ndV < tol
        info = (rho_out, eigvals, occ, epsF, energies, V_out)
        if converged:
            break
        V_prev, psi_prev, rho_prev = V, psi, rho_out
        E_prev = E_total
        backtracks_left = 3
        alpha = min(alpha * math.sqrt(2.0), alpha_max) if alpha < damping else damping
        V = anderson(V, dV, alpha)

    rho_out, eigvals, occ, epsF, energies, V_out = info
    energies_out = {k: float(v) for k, v in energies.items()}
    energies_out.update(E_const)
    energies_out["total"] = float(sum(energies_out.values()))
    return SCFResult(
        basis=basis, energies=energies_out, eigenvalues=eigvals.cpu().numpy(),
        occupation=occ.cpu().numpy(), psi=psi, rho=rho_out, epsF=float(epsF),
        converged=bool(converged), n_iter=it, n_bands_converge=n_bands,
        history_Etot=history_E, history_Drho=history_dV, n_matvec=0,
        runtime_s=time.time() - t0, V_local=V_out)
