"""Self-consistent field driver.

Port of `dftk_tpu/scf/driver.py::self_consistent_field` (reference
`src/scf/self_consistent_field.jl:80-289`): a Python fixed-point loop around
one SCF step

    rho_in -> V(rho_in) -> LOBPCG (warm-started) -> occupations / Fermi level
           -> rho_out -> energies at rho_out

with Anderson-accelerated, preconditioned density updates (Simple, Kerker,
dielectric, or the LDOS-based LdosMixing, KerkerDosMixing and HybridMixing,
which get the LDOS at the Fermi level of each iteration, and Chi0Mixing,
which gets the iterate: H at rho_out, the orbitals, occupations,
eigenvalues and Fermi level, `response/chi0.py::Chi0Context`) and an adaptive
eigensolver tolerance (AdaptiveDiagtol, scf_callbacks.jl:191-230).  At
finite temperature the occupations come from the smearing and the energy
carries the Entropy term; `nbandsalg` (`scf/nbands.py`) sets the band
counts and grows them between iterations.  Under a meta-GGA the step
also carries the kinetic-energy density tau: the potential takes tau_in
(Vtau enters H through the DivAgrad apply), tau_out comes from the new
orbitals, and tau follows psi without mixing, from the von Weizsaecker
tau of the first density.  The JAX package jit-compiles the step; here it
runs eagerly on the basis' device.

Exact exchange and Hubbard lag one step, as in the JAX package: H at step
n uses the orbitals and the occupations that went into step n (the aufbau
occupations at the first step, and zeros for bands AdaptiveBands adds).
With `use_ace` (default) the Fock operator of those orbitals is compressed
once per step (`ops/exx_ace.py`) and LOBPCG applies two GEMMs for it; the
exchange energy is evaluated with the bare operator of the new orbitals.

A run that ends unconverged, or with a non-finite energy, dumps its final
density, eigenvalues and occupations where DFTK_TPU_DEBUG_DUMP names a
directory (`utils/debugdump.py`), as the JAX package's does.
"""
import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..ops import hamiltonian as hamops
from ..ops.density import (compute_density, compute_kinetic_energy_density,
                           guess_density, make_symmetrizer, von_weizsaecker_tau)
from ..ops.eigen.lobpcg import lobpcg, ortho_qr
from ..ops.exx_ace import apply_ace, build_ace
from ..ops.hubbard import HubbardSetup
from ..ops.occupation import compute_occupation, entropy_energy
from ..ops.terms import refuse_anyonic
from ..response.chi0 import Chi0Context
from ..utils.debugdump import debug_dump
from .anderson import AndersonAcceleration
from .mixing import KerkerMixing, SimpleMixing


@dataclasses.dataclass
class SCFResult:
    basis: Any
    energies: Dict[str, float]
    eigenvalues: np.ndarray      # [nk, nb]
    occupation: np.ndarray       # [nk, nb]
    psi: Any                     # [nk, nb, nG] tensor
    rho: Any                     # [nspin, n1, n2, n3] tensor
    epsF: float
    converged: bool
    n_iter: int
    n_bands_converge: int
    history_Etot: list
    history_Drho: list
    n_matvec: int
    runtime_s: float
    V_local: Any = None          # total local potential at convergence
    tau: Any = None              # kinetic-energy density (meta-GGA)

    @property
    def total_energy(self):
        return self.energies["total"]


def random_orbitals(basis, n_bands, seed=42, generator=None):
    """Orthonormalised random orbitals [nk, n_bands, nG] on the basis' device,
    drawn from `generator` (a torch.Generator on that device) or from a new
    one seeded with `seed`."""
    if generator is None:
        generator = torch.Generator(device=basis.device).manual_seed(seed)
    shape = (basis.n_kpoints, n_bands, basis.nG_max)
    X = torch.randn(shape, dtype=basis.dtype, device=basis.device,
                    generator=generator)
    return ortho_qr(X * basis.data.mask[:, None, :])


def aufbau_occupation(basis, n_bands):
    """[nk, n_bands]: the filled occupation on the lowest
    n_electrons / filled bands of every k row (the first step's generator
    occupations of exact exchange and Hubbard)."""
    model = basis.model
    filled = model.filled_occupation
    n_occ = int(round(model.n_electrons / filled))
    occ = torch.zeros((basis.n_kpoints, n_bands), dtype=basis.rdtype, device=basis.device)
    occ[:, :n_occ] = filled
    return occ


def constant_energies(terms):
    """The energies that do not depend on the state: Ewald, PspCorrection
    and, where it is not zero, PairwisePotential (as the JAX package's
    self_consistent_field reports them)."""
    E = {"Ewald": terms.E_ewald, "PspCorrection": terms.E_psp_correction}
    if terms.E_pairwise:
        E["PairwisePotential"] = terms.E_pairwise
    return E


def default_mixing(model):
    return KerkerMixing() if model.temperature > 0 else SimpleMixing()


def ldos_at(basis, psi, eigenvalues, epsF):
    """The local density of states at the Fermi level, [1, n1, n2, n3]:

        ldos(r) = sum_kn w_k (-filled / T) f'((e_kn - epsF) / T) |psi_kn(r)|^2

    summed over both spins, with the model's smearing (a Fermi-Dirac of
    T = 1e-3 at zero temperature), f' by torch.autograd."""
    model = basis.model
    T = model.temperature if model.temperature > 0 else 1e-3
    occupation = (model.smearing.occupation if model.temperature > 0
                  else lambda t: torch.sigmoid(-t))
    with torch.enable_grad():
        x = ((eigenvalues - epsF) / T).detach().requires_grad_(True)
        (docc,) = torch.autograd.grad(occupation(x).sum(), x)
    w = -model.filled_occupation / T * docc
    return compute_density(basis.data, psi, w, basis.fft_size, model.unit_cell_volume, 1)


@torch.no_grad()
def self_consistent_field(
        basis,
        tol: float = 1e-6,
        maxiter: int = 100,
        rho=None,
        psi=None,
        n_bands: Optional[int] = None,
        n_extra_bands: Optional[int] = None,
        nbandsalg=None,
        mixing=None,
        damping: float = 0.8,
        anderson_depth: int = 10,
        eigensolver_maxiter: int = 100,
        diagtol_max: float = 5e-3,
        diagtol_min: float = None,
        diagtol_ratio: float = 0.2,
        is_converged="density",   # "density" | "energy" | callable(info)->bool
        callback: Optional[Callable] = None,
        maxtime: Optional[float] = None,      # seconds; soft SCF timeout
        seed: int = 42,
        generator: Optional[torch.Generator] = None,
        use_ace: bool = True,    # compress the Fock exchange (Lin Lin's ACE)
) -> SCFResult:
    t0 = time.time()
    model = basis.model
    terms = basis.terms
    refuse_anyonic(model, "self_consistent_field")
    if mixing is None:
        mixing = default_mixing(model)
    needs_state = getattr(mixing, "needs_state", False)
    needs_ldos = getattr(mixing, "needs_ldos", False)
    if nbandsalg is not None:
        n_bands, nb_total = nbandsalg.bands(model)
        n_extra_bands = nb_total - n_bands
    else:
        if n_bands is None:
            n_bands = model.default_n_bands()
        if n_extra_bands is None:
            n_extra_bands = max(3, n_bands // 10)
    if rho is None:
        rho = guess_density(basis)
    if generator is None:
        generator = torch.Generator(device=basis.device).manual_seed(seed)
    if psi is None:
        psi = random_orbitals(basis, n_bands + n_extra_bands, generator=generator)
    if diagtol_min is None:
        diagtol_min = max(tol / 100, 100 * torch.finfo(basis.rdtype).eps)

    # rho is symmetrized (with the grid's low-pass) and V applied as it is,
    # pointwise, as the JAX package and the reference do (see the note at
    # dftk_tpu/scf/driver.py:190-199)
    symmetrizer = make_symmetrizer(basis)
    bd = basis.data
    td = terms.data
    nspin = model.n_spin_components
    volume = model.unit_cell_volume
    dvol = basis.dvol
    needs_tau = terms.needs_tau
    filled = model.filled_occupation
    has_exx = td.exx_kernel is not None
    hub = HubbardSetup(basis) if terms.hubbard_manifolds is not None else None

    def scf_step(rho_in, psi_in, diagtol, tau_in, occ_in):
        V, Vtau, _ = hamops.total_potential(terms, rho_in, volume, tau=tau_in)
        exx = (hamops.make_exchange(bd, td, psi_in, occ_in, filled, volume)
               if has_exx else None)
        ham = hamops.build_ham(bd, td, V, basis.pruned, Vtau=Vtau,
                               exx=None if use_ace else exx)
        extra = []
        if has_exx and use_ace:
            # compress the Fock operator once per step: the eigensolver then
            # applies two GEMMs instead of one Poisson solve per orbital
            xi = build_ace(exx)
            extra.append(lambda p: apply_ace(xi, p))
        if hub is not None:
            extra.append(hub.potential_apply(psi_in, occ_in))

        def applyH(p):
            out = hamops.apply_H(ham, p)
            for x in extra:
                out = out + x(p) * bd.mask[:, None, :]
            return out

        res = lobpcg(applyH, psi_in, ham.kin, bd.mask,
                     tol=diagtol, maxiter=eigensolver_maxiter, n_conv=n_bands)
        occ, epsF = compute_occupation(res.eigenvalues, bd.kweights,
                                       model.n_electrons, model.filled_occupation,
                                       model.temperature, model.smearing)
        rho_out = compute_density(bd, res.X, occ, basis.fft_size, volume, nspin,
                                  symmetrizer=symmetrizer)
        # energies at rho_out (consistent at convergence); the kinetic and
        # nonlocal parts of H do not depend on V, so `ham` serves for both
        tau_out = None
        if needs_tau:
            tau_out = compute_kinetic_energy_density(bd, res.X, occ, basis.fft_size, volume,
                                                     nspin, symmetrizer=symmetrizer)
        V_out, _, energies = hamops.total_potential(terms, rho_out, volume, tau=tau_out)
        energies.update(hamops.psi_energies(ham, res.X, occ, bd.kweights))
        if has_exx:
            energies["ExactExchange"] = hamops.exchange_energy(
                hamops.make_exchange(bd, td, res.X, occ, filled, volume), res.X, occ,
                bd.kweights)
        if hub is not None:
            energies["Hubbard"] = hub.energy(res.X, occ)
        if terms.has_entropy:
            energies["Entropy"] = entropy_energy(
                res.eigenvalues, bd.kweights, epsF, model.temperature,
                model.smearing, model.filled_occupation)
        return rho_out, res, occ, epsF, energies, V_out, tau_out

    anderson = AndersonAcceleration(m=anderson_depth)
    history_E, history_drho = [], []
    E_prev = None
    converged = False
    diagtol = diagtol_max
    n_matvec_total = 0
    E_const = constant_energies(terms)
    tau = von_weizsaecker_tau(rho, td.G_cart) if needs_tau else None
    # exchange and Hubbard take the occupations of psi_in: the aufbau guess
    # at the first step
    occ_x = aufbau_occupation(basis, psi.shape[1]) if has_exx or hub is not None else None
    for it in range(maxiter):
        rho_out, res, occ, epsF, energies, V_out, tau_out = scf_step(rho, psi, diagtol, tau,
                                                                     occ_x)
        psi = res.X
        occ_x = occ
        n_matvec_total += res.n_matvec
        delta_F = rho_out - rho
        energies_h = {k: float(v) for k, v in energies.items()}
        E_total = float(sum(energies_h.values()) + sum(E_const.values()))
        drho = float(torch.linalg.vector_norm(delta_F)) * math.sqrt(dvol)
        history_E.append(E_total)
        history_drho.append(drho)
        if callback is not None:
            callback(dict(n_iter=it + 1, E=E_total, drho=drho, epsF=float(epsF),
                          eig_iters=res.n_iter))

        if callable(is_converged):
            converged = bool(is_converged(dict(E=E_total, drho=drho, n_iter=it + 1)))
        elif is_converged == "density":
            converged = drho < tol
        else:
            converged = E_prev is not None and abs(E_total - E_prev) < tol
        E_prev = E_total
        if maxtime is not None and time.time() - t0 > maxtime:
            break
        # band growth (AdaptiveBands): random orthonormalised bands join the
        # block while the top computed bands are occupied
        if nbandsalg is not None and not converged:
            grown = nbandsalg.update(occ, None)
            if grown is not None:
                n_bands, nb_total_new = grown
                extra = nb_total_new - psi.shape[1]
                if extra > 0:
                    pad = random_orbitals(basis, extra, generator=generator)
                    psi = ortho_qr(torch.cat([psi, pad], dim=1))
                    if occ_x is not None:      # the new bands start unoccupied
                        occ_x = torch.nn.functional.pad(occ_x, (0, extra))
        if converged:
            break
        tau = tau_out            # tau follows psi (no mixing)
        # density update: precondition + Anderson + damping
        if needs_state:
            ctx = Chi0Context(ham=hamops.build_ham(bd, td, V_out, basis.pruned), psi=res.X,
                              occupation=occ, eigenvalues=res.eigenvalues, epsF=epsF)
            delta_rho = mixing.mix_density(delta_F, td.Gsq_cart, basis=basis, ctx=ctx)
        elif needs_ldos:
            delta_rho = mixing.mix_density(
                delta_F, td.Gsq_cart, ldos=ldos_at(basis, res.X, res.eigenvalues, epsF),
                dvol=dvol, volume=volume)
        else:
            delta_rho = mixing.mix_density(delta_F, td.Gsq_cart)
        rho = anderson(rho, delta_rho, damping)
        # adaptive eigensolver tolerance, tightening with the density residual
        diagtol = min(diagtol, max(diagtol_ratio * drho, diagtol_min))

    energies_out = dict(energies_h)
    energies_out.update(E_const)
    energies_out["total"] = float(sum(energies_out.values()))
    if not converged or not math.isfinite(energies_out["total"]):
        path = debug_dump(
            "scf-not-converged",
            meta=dict(energies=energies_out, n_iter=it + 1, epsF=float(epsF),
                      history_E=history_E, history_drho=history_drho),
            rho=rho_out, eigenvalues=res.eigenvalues, occupation=occ)
        if path:
            print(f"SCF debug state dumped to {path}")
    return SCFResult(
        basis=basis, energies=energies_out,
        eigenvalues=res.eigenvalues.cpu().numpy(),
        occupation=occ.cpu().numpy(),
        psi=psi, rho=rho_out, epsF=float(epsF), converged=bool(converged),
        n_iter=it + 1, n_bands_converge=n_bands,
        history_Etot=history_E, history_Drho=history_drho,
        n_matvec=n_matvec_total, runtime_s=time.time() - t0, V_local=V_out,
        tau=tau_out)
