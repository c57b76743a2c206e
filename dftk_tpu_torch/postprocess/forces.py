"""Forces: -dE/dR at fixed orbitals and occupations (Hellmann-Feynman).

Port of `dftk_tpu/postprocess/forces.py` (reference
`src/postprocess/forces.jl`, `terms/local.jl:147-181`,
`terms/nonlocal.jl:49-100`).  The position-dependent energy terms
(AtomicLocal, AtomicNonlocal, Ewald) are one differentiable torch function
of the fractional positions, and `torch.autograd` gives the exact
derivative.  Everything runs in float64 on the basis' device.

Forces are in reduced coordinates (covectors) from `compute_forces`;
`compute_forces_cart` symmetrizes and converts them with inv(lattice)^T.

Collinear spin, GGA and finite temperature need nothing more: without a
core density no XC term depends on the positions, and the occupations are
held fixed.  A meta-GGA's tau is the result's (`scfres.tau`), or, where it
has none (the split adapters), the kinetic-energy density of its orbitals.

A PairwisePotential's forces (`ops/pairwise.py`, by autograd at setup)
join the total, as in the JAX package.  The other terms of the model
Hamiltonians (External*, LocalNonlinearity, Magnetic, Anyonic and the
kinetic blow-ups) do not depend on the positions.  Potential-only
functionals (TB09) have no energy, so no forces: they raise
NotImplementedError.
"""
import math

import numpy as np
import torch

from ..models.elements import ElementPsp
from ..ops.ewald import default_eta, energy_ewald, ewald_sum_bounds
from ..ops.terms import AtomicLocal, projector_form_factors
from ..parallel.mesh import ksum, local_rows

# complex entries of one atom chunk's phase or projector tensor (256 MB)
CHUNK_ELEMS = 2 ** 24


def check_supported(basis, scfres, what):
    """Raise NotImplementedError for what the derivatives do not have."""
    if any(f.potential is not None for f, _ in basis.terms.xc):
        raise NotImplementedError(
            f"{what} are undefined for potential-only functionals (TB09/mBJ has "
            f"no energy functional to differentiate)")


def f64(basis, arr):
    """numpy -> float64 tensor on the basis' device."""
    return torch.as_tensor(np.ascontiguousarray(arr), dtype=torch.float64,
                           device=basis.device)


def has_local(model):
    return any(isinstance(t, AtomicLocal) for t in model.term_types)


def psp_groups(model):
    """The atom groups whose psp has nonlocal projectors."""
    return [g for g in model.atom_groups if isinstance(model.atoms[g[0]], ElementPsp)
            and model.atoms[g[0]].psp.n_proj() > 0]


def structure_factor(Gred, pos):
    """sum_a exp(-2 pi i G.r_a) over the atoms pos [na, 3] for reduced
    G [M, 3] -> [M] complex, atom chunks bounded by CHUNK_ELEMS."""
    n = max(1, CHUNK_ELEMS // Gred.shape[0])
    sf = 0
    for i in range(0, pos.shape[0], n):
        sf = sf + torch.exp(-2j * math.pi * (Gred @ pos[i:i + n].T)).sum(1)
    return sf


def nonlocal_group_energy(ff, D, psi, wocc, Gred_pk, pos, sqrt_vol):
    """sum_kn w_k f_kn (P^dag psi)^dag D (P^dag psi) summed over the atoms
    pos [na, 3] of one psp group, P = ff e^{-2 pi i (k+G).r} / sqrt(vol),
    batched over chunks of atoms.  ff [nk, nG, npp], D [npp, npp]."""
    n = max(1, CHUNK_ELEMS // ff.numel())
    D = D.to(psi.dtype)
    E = 0
    for i in range(0, pos.shape[0], n):
        sf = torch.exp(-2j * math.pi * torch.einsum("kgd,ad->akg", Gred_pk, pos[i:i + n]))
        Pd = torch.einsum("akgp,kng->aknp", (ff * sf[..., None]).conj(), psi) / sqrt_vol
        band_e = torch.einsum("aknp,pq,aknq->kn", Pd.conj(), D, Pd).real
        E = E + torch.sum(wocc * band_e)
    return E


def core_form_factor(basis, at, kind):
    """The core density's (kind "rho") or core kinetic-energy density's
    ("tau") form factor of element `at` at the cube's |G|, a float64 tensor
    [N], cached on the basis instance."""
    cache = basis.__dict__.setdefault("_core_ff_cache", {})
    if (at, kind) not in cache:
        fn = at.core_density_fourier if kind == "rho" else at.core_tau_fourier
        cache[at, kind] = f64(basis, fn(basis.G_cube_cart_norm.reshape(-1)))
    return cache[at, kind]


def core_on_grid(basis, ffs, positions, volume):
    """sum_i ff_i(G) e^{-2 pi i G.r_i} on the real grid, clipped at 0: the
    NLCC core (kinetic-energy) density of the atoms `ffs` maps to their
    form factors [N], at positions [n_atoms, 3] (fractional) and the cell
    volume (a float or a 0-d tensor), differentiable in both."""
    Gred = f64(basis, basis.G_cube.reshape(-1, 3))
    core_G = 0
    for i, ff in ffs.items():
        core_G = core_G + ff * structure_factor(Gred, positions[i:i + 1])
    N = int(np.prod(basis.fft_size))
    sqrt_vol = volume ** 0.5
    core = torch.fft.ifftn((core_G / sqrt_vol).reshape(basis.fft_size)).real * (N / sqrt_vol)
    return torch.maximum(core, torch.zeros_like(core))


def core_atoms(basis, kind):
    """The indices of the atoms with a core density (kind "rho") or core
    kinetic-energy density ("tau")."""
    has = "has_core_density" if kind == "rho" else "has_core_tau"
    return [i for i, at in enumerate(basis.model.atoms) if getattr(at, has, lambda: False)()]


def kinetic_density_of(basis, psi, occupation):
    """The symmetrized kinetic-energy density of a state, float64 on the
    basis' device (a meta-GGA result without its own tau)."""
    from ..ops.density import compute_kinetic_energy_density, make_symmetrizer
    bd = basis.data._replace(Gpk_cart=f64(basis, local_rows(basis, basis.Gpk_cart_np)),
                             mask=f64(basis, local_rows(basis, basis.mask_np)),
                             kweights=f64(basis, local_rows(basis, basis.kweights)))
    return compute_kinetic_energy_density(
        bd, psi, occupation, basis.fft_size, basis.model.unit_cell_volume,
        basis.model.n_spin_components, 64, symmetrizer=make_symmetrizer(basis),
        comm=basis.comm)


def _positions_energy(basis, psi, occupation, rho, positions, tau=None, parts="all"):
    """The explicitly position-dependent energy terms as a torch function of
    positions [n_atoms, 3] (fractional, float64); tau is needed for
    meta-GGA models with a core kinetic-energy density.  parts: "all",
    "kpoints" (the nonlocal term, a sum over the k rows of psi) or "grid"
    (the others)."""
    model = basis.model
    terms = basis.terms
    sqrt_vol = math.sqrt(model.unit_cell_volume)
    N = int(np.prod(basis.fft_size))
    E = torch.zeros((), dtype=torch.float64, device=basis.device)

    if parts == "kpoints":
        return _nonlocal_energy(basis, psi, occupation, positions, sqrt_vol)
    # AtomicLocal: E = sum_G conj(rho_G) Vloc_G
    if has_local(model):
        rho_G = (torch.fft.fftn(rho.sum(0)) * (sqrt_vol / N)).reshape(-1)
        Gred = f64(basis, basis.G_cube.reshape(-1, 3))
        Gnorm = basis.G_cube_cart_norm.reshape(-1)
        vloc_G = 0
        for group in model.atom_groups:
            ff = f64(basis, model.atoms[group[0]].local_potential_fourier(Gnorm))
            vloc_G = vloc_G + ff * structure_factor(Gred, positions[group]) / sqrt_vol
        E = E + torch.sum(rho_G.real * vloc_G.real + rho_G.imag * vloc_G.imag)

    if parts == "all":
        E = E + _nonlocal_energy(basis, psi, occupation, positions, sqrt_vol)

    # Ewald
    charges = np.array([at.charge_ionic() for at in model.atoms], dtype=float)
    if len(charges) > 0 and terms.E_ewald != 0.0:
        eta = default_eta(model.lattice)
        Gbox, Rbox = ewald_sum_bounds(model.lattice, np.stack(model.positions), eta)
        E = E + energy_ewald(model.lattice, charges, positions, eta=eta,
                             device=basis.device, Gbox=Gbox, Rbox=Rbox)

    # NLCC: the core densities move with the atoms, so Exc[rho + rho_core]
    # (and tau + tau_core under a meta-GGA) gives a force
    if terms.xc and (terms.rho_core_np is not None or terms.tau_core_np is not None):
        from ..ops.hamiltonian import xc_energy
        nspin = rho.shape[0]
        vol = model.unit_cell_volume
        rho_xc, tau_xc = rho, tau
        if terms.rho_core_np is not None:
            ffs = {i: core_form_factor(basis, model.atoms[i], "rho")
                   for i in core_atoms(basis, "rho")}
            rho_xc = rho + core_on_grid(basis, ffs, positions, vol)[None] / nspin
        if tau is not None and terms.tau_core_np is not None:
            ffs = {i: core_form_factor(basis, model.atoms[i], "tau")
                   for i in core_atoms(basis, "tau")}
            tau_xc = tau + core_on_grid(basis, ffs, positions, vol)[None] / nspin
        E = E + xc_energy(terms.xc, rho_xc, vol, terms.xc_scaling,
                          f64(basis, basis.G_cube_cart), tau=tau_xc)
    return E


def _nonlocal_energy(basis, psi, occupation, positions, sqrt_vol):
    """AtomicNonlocal of the k rows of psi (this rank's on a distributed
    basis)."""
    model = basis.model
    E = torch.zeros((), dtype=torch.float64, device=basis.device)
    if basis.terms.data.P.shape[-1] == 0:
        return E
    wocc = f64(basis, local_rows(basis, basis.kweights))[:, None] * occupation
    Gred_pk = f64(basis, local_rows(basis, basis.Gred_np + basis.kcoords_spin[:, None, :]))
    for group in psp_groups(model):
        ff, D = _projector_form_factors(basis, model.atoms[group[0]].psp)
        E = E + nonlocal_group_energy(local_rows(basis, ff), D, psi, wocc, Gred_pk,
                                      positions[group], sqrt_vol)
    return E


def _projector_form_factors(basis, psp):
    """`ops/terms.py::projector_form_factors` at the basis' own k+G, with D
    as a tensor.

    Cached on the basis instance: a module-level dict keyed on id(basis)
    would hand a new basis the stale factors of a dead one whose id was
    reused."""
    cache = basis.__dict__.setdefault("_ff_cache", {})
    if psp not in cache:
        ff, D = projector_form_factors(psp, f64(basis, basis.Gpk_cart_np),
                                       f64(basis, basis.mask_np))
        cache[psp] = (ff, f64(basis, D))
    return cache[psp]


def compute_forces(scfres, basis=None):
    """Forces in reduced coordinates, a float64 tensor [n_atoms, 3] on the
    basis' device.  scfres: an SCFResult, or anything with psi, occupation
    and rho.  On a distributed basis psi and occupation are this rank's k
    rows: the nonlocal forces are all-reduced over "kpts", the others
    (from the replicated density) computed on every rank."""
    basis = basis or scfres.basis
    check_supported(basis, scfres, "forces")
    dev = basis.device
    psi = torch.as_tensor(scfres.psi, device=dev).to(torch.complex128)
    occ = torch.as_tensor(scfres.occupation, device=dev).to(torch.float64)
    rho = torch.as_tensor(scfres.rho, device=dev).to(torch.float64)
    tau = None
    if basis.terms.needs_tau:
        tau = getattr(scfres, "tau", None)
        tau = (kinetic_density_of(basis, psi, occ) if tau is None
               else torch.as_tensor(tau, device=dev).to(torch.float64))
    with torch.enable_grad():
        positions = f64(basis, np.stack(basis.model.positions)).requires_grad_(True)
        grad = torch.zeros_like(positions)
        for part, reduce in (("grid", None), ("kpoints", basis.comm)):
            E = _positions_energy(basis, psi, occ, rho, positions, tau, part)
            if E.requires_grad:
                grad = grad + ksum(torch.autograd.grad(E, positions)[0], reduce)
    F = -grad
    if basis.terms.pairwise_forces is not None:
        F = F + f64(basis, basis.terms.pairwise_forces)
    return F


def compute_forces_cart(scfres, basis=None):
    """Symmetrized Cartesian forces, a float64 tensor [n_atoms, 3] on the
    basis' device."""
    basis = basis or scfres.basis
    f_red = symmetrize_forces(basis, compute_forces(scfres, basis))
    return f_red @ f64(basis, np.linalg.inv(basis.model.lattice))  # rows: inv(L)^T f


def symmetrize_forces(basis, forces_red):
    """Average the reduced forces [n_atoms, 3] over the basis' symmetries
    (reference symmetry.jl:392-421): atom i gets inv(W)^T F_j from the atom
    j of its group that the operation maps onto it, W r_j + w = r_i (mod 1).
    The preimages are found on the host; the sum runs on the forces'
    device."""
    positions = np.stack(basis.model.positions)
    syms = basis.symmetries
    tol = 1e-5
    src = np.empty((len(syms), len(positions)), dtype=np.int64)
    for s, op in enumerate(syms):
        W, w = op.Wmat, op.wvec
        targets = np.linalg.solve(W, (positions - w).T).T      # [n_atoms, 3]
        for group in basis.model.atom_groups:
            d = positions[group][None, :, :] - targets[group][:, None, :]
            d -= np.round(d)
            dist = np.abs(d).max(axis=2)                      # [target, source]
            j = np.argmin(dist, axis=1)
            if not np.all(dist[np.arange(len(group)), j] < 10 * tol):
                raise ValueError("symmetrize_forces: an operation maps no atom "
                                 "of the group onto an atom")
            src[s, group] = np.asarray(group)[j]
    invWt = np.stack([np.linalg.inv(op.Wmat.T) for op in syms])
    F = torch.as_tensor(forces_red)
    out = torch.einsum("sab,sib->ia", torch.as_tensor(invWt, dtype=F.dtype, device=F.device),
                       F[torch.as_tensor(src, device=F.device)])
    return out / len(syms)
