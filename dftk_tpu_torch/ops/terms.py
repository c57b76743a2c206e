"""Energy terms and their instantiation on a PlaneWaveBasis.

Port of `dftk_tpu/ops/terms.py::instantiate_terms`, every term of the JAX
package: Kinetic (with the energy-cutoff blow-ups `BlowupIdentity`,
`BlowupCHV` and `BlowupAbinit`), AtomicLocal, AtomicNonlocal, Hartree, Xc
(LDA, GGA and meta-GGA), Ewald, PspCorrection, Entropy, ExactExchange
(its Coulomb kernels at G + q for every k-point difference, from
`ops/coulomb.py::exx_q_kernels`), Hubbard (its manifolds; the projectors
are built where the SCF starts, `ops/hubbard.py`), the external potentials
`ExternalFromReal`, `ExternalFromFourier` and `ExternalFromValues` (added
to the static local potential), `LocalNonlinearity` (its energy and
potential are assembled each step, `ops/hamiltonian.py`), `Magnetic` (the
vector potential on the grid), `Anyonic` (its reference fields,
`ops/anyonic.py`) and `PairwisePotential` (its energy and forces,
`ops/pairwise.py`), with any element (HGH or UPF pseudopotentials,
Coulomb, Gaussian, Cohen-Bergstresser, or a user's object with
`local_potential_fourier`).
Density-independent data (the local potential, the Hartree kernel, the
nonlocal projectors P and couplings D, the Ewald and psp correction
energies, the Cartesian G of the cube for gradients, and the NLCC core
density and, for meta-GGA, the core kinetic-energy density on the grid)
are built once on the host (the projectors' form factors by
`projector_form_factors`, a torch function that the stresses also trace
through the lattice) and held as tensors on the basis' device in
`Terms.data`; the density-dependent potentials are assembled each SCF step
by `ops/hamiltonian.py`.

A kinetic blow-up gives the explicit kinetic [nk, nG] (`TermsData.kin`,
scaling_factor included), evaluated in float64 numpy on the host (the
blow-ups take exp(-1/t) near t = 0); the Hamiltonian, the preconditioners
and the split SCF's filters read it (`hamiltonian.kinetic`) in place of
kinetic_scale * |k+G|^2 / 2.  A plain kinetic scaling stays in
kinetic_scale alone (the JAX package also writes it out as kin_np).

The user callables: ExternalFromReal's potential(r_cart),
ExternalFromFourier's potential(G_cart) and Magnetic's Apot(r_cart) take
and return numpy arrays, as in the JAX package; LocalNonlinearity's f(rho)
and PairwisePotential's V(d2, params) are differentiated, so they take and
return torch tensors here (jnp arrays in the JAX package).

Where the JAX package leaves one of these terms out of a computation
without an error, the port raises NotImplementedError naming the
reference's gap (`refuse_terms`; ROADMAP Queue 3).
"""
import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import scipy.linalg
import torch

from ..models.elements import ElementPsp
from ..utils.special import LM_INDEX, solid_harmonics_real
from .ewald import default_eta, energy_ewald
from .xc.functionals import resolve_functionals


class BlowupIdentity:
    """Standard kinetic energies (no Ecut smearing)."""
    def __call__(self, x, Ecut):
        return np.ones_like(x)


class BlowupCHV:
    """The C^2-regular energy-band blow-up of Cances, Hassan and Vidal
    (arXiv:2210.00442; reference terms/kinetic.jl:72-91), at y = |k+G|."""
    def __call__(self, y, Ecut):
        y = np.asarray(y, dtype=float)
        x = y / np.sqrt(2 * Ecut)
        x1, x2 = 0.85, 0.90
        Ca = 0.013952310177257383

        def f(t):
            return np.where(t <= 0, 0.0, np.exp(-1 / np.maximum(t, 1e-300)))

        t = (x - x1) / (x2 - x1)
        sstep = f(t) / (f(t) + f(1 - t))
        blow = Ca / np.maximum((1 - x) ** 2, 1e-300)
        Ekin = np.maximum(y ** 2 / 2, 1e-300)
        mid = (Ecut / Ekin) * ((1 - sstep) * x ** 2 + sstep * blow)
        hi = (Ecut / Ekin) * blow
        return np.where(x < x1, 1.0, np.where(x < x2, mid, hi))


class BlowupAbinit:
    """Abinit-style Ecut smearing (reference terms/kinetic.jl:97-111)."""
    def __init__(self, Ecutsm=0.5):
        self.Ecutsm = Ecutsm

    def __call__(self, y, Ecut):
        y = np.asarray(y, dtype=float)
        Ekin = y ** 2 / 2
        Ecutsm = Ecut * self.Ecutsm
        x = (Ecut - Ekin) / Ecutsm
        xs = np.maximum(x, 1e-10)
        smoothed = 1 / (xs ** 2 * (3 + xs - 6 * xs ** 2 + 3 * xs ** 3))
        return np.where(Ekin <= Ecut - Ecutsm, 1.0, smoothed)


def has_blowup(term):
    """A Kinetic term whose blow-up changes the bare kinetic energies."""
    return term.blowup is not None and not isinstance(term.blowup, BlowupIdentity)


@dataclasses.dataclass(frozen=True)
class Kinetic:
    scaling_factor: float = 1.0
    blowup: object = None      # BlowupIdentity / BlowupCHV / BlowupAbinit


@dataclasses.dataclass(frozen=True)
class AtomicLocal:
    pass


@dataclasses.dataclass(frozen=True)
class AtomicNonlocal:
    pass


@dataclasses.dataclass(frozen=True)
class Hartree:
    scaling_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class Xc:
    functionals: tuple = ()
    scaling_factor: float = 1.0

    def __init__(self, functionals=(), scaling_factor=1.0):
        if isinstance(functionals, str):
            functionals = (functionals,)
        object.__setattr__(self, "functionals", tuple(functionals))
        object.__setattr__(self, "scaling_factor", float(scaling_factor))


@dataclasses.dataclass(frozen=True)
class Ewald:
    eta: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class PspCorrection:
    pass


@dataclasses.dataclass(frozen=True)
class Entropy:
    """The smearing entropy -T S of finite-temperature models; its energy
    needs the eigenvalues and the Fermi level, so the SCF loops add it
    (`ops/occupation.py::entropy_energy`)."""


@dataclasses.dataclass(frozen=True)
class Hubbard:
    """DFT+U on pseudo-atomic orbital manifolds (`ops/hubbard.py`);
    manifolds: a tuple of HubbardManifold."""
    manifolds: tuple = ()


@dataclasses.dataclass(frozen=True)
class ExactExchange:
    """(Screened) Hartree-Fock exchange (reference terms/exact_exchange.jl):
    E = -1/2 sum_nm (f_n f_m / filled) <nm|kernel|mn>, the kernel from
    `ops/coulomb.py` (default: Coulomb with ProbeCharge).  At Gamma, and on
    unreduced uniform k-grids (symmetries=False) through the kernels at
    G + q, as in the JAX package."""
    scaling_factor: float = 1.0
    kernel: object = None


@dataclasses.dataclass(frozen=True)
class ExternalFromReal:
    """potential(r_cart) -> V: numpy [n1, n2, n3, 3] -> [n1, n2, n3],
    evaluated on the real-space grid at setup."""
    potential: Callable = None


@dataclasses.dataclass(frozen=True)
class ExternalFromFourier:
    """potential(G_cart) -> V(G) (unnormalised): numpy [n1, n2, n3, 3] ->
    [n1, n2, n3], inverse-FFT'd at setup."""
    potential: Callable = None


@dataclasses.dataclass(frozen=True)
class ExternalFromValues:
    """An external potential given by its values on the real-space grid
    (shape == basis.fft_size; reference src/terms/local.jl:26-39)."""
    potential_values: Any = None


@dataclasses.dataclass(frozen=True)
class LocalNonlinearity:
    """The energy term int f(rho) (e.g. Gross-Pitaevskii C rho^alpha);
    f maps the total density, a torch tensor [n1, n2, n3], to the energy
    density, and its potential is the torch.autograd derivative."""
    f: Callable = None


@dataclasses.dataclass(frozen=True)
class Magnetic:
    """The A.(-i grad) vector-potential term (reference terms/magnetic.jl):
    Apot(r_cart) -> [n1, n2, n3, 3] numpy.  Breaks time-reversal symmetry;
    use symmetries=False."""
    Apot: Callable = None


@dataclasses.dataclass(frozen=True)
class Anyonic:
    """Average-field anyons in 2D (reference terms/anyonic.jl;
    arXiv:1901.10739): a density-dependent Chern-Simons gauge field
    (`ops/anyonic.py`), solved by `direct_minimization` with
    Kinetic(scaling_factor=2), as the reference example does.  Gamma only,
    a square 2D lattice, one spin component."""
    hbar: float = 1.0
    beta: float = 0.0


@dataclasses.dataclass(frozen=True)
class PairwisePotential:
    """The classical pairwise interaction sum_{i<j,R} V(|ri - rj - R|)
    (reference terms/pairwise.jl), e.g. Lennard-Jones between the nuclei.
    V(d2, params) takes the squared distance as a torch tensor; params per
    sorted species pair (symA, symB) (`ops/pairwise.py`)."""
    V: Callable = None
    params: dict = None
    max_radius: float = 100.0


class TermsData(NamedTuple):
    """Tensors consumed by the Hamiltonian and the SCF step."""
    vloc_static: torch.Tensor     # [n1,n2,n3] static local potential
    hartree_coeffs: torch.Tensor  # [n1,n2,n3] 4 pi / |G|^2 (0 at DC), scaled
    P: torch.Tensor               # [nk, nG, nproj] complex projectors
    D: torch.Tensor               # [nproj, nproj] couplings
    Gsq_cart: torch.Tensor        # [n1,n2,n3] |G|^2 Cartesian (Kerker mixing)
    kinetic_scale: float
    G_cart: Optional[torch.Tensor] = None   # [n1,n2,n3,3] Cartesian G (gradients)
    rho_core: Optional[torch.Tensor] = None  # [n1,n2,n3] NLCC core density
    tau_core: Optional[torch.Tensor] = None  # [n1,n2,n3] core kinetic density (meta-GGA)
    exx_kernel: Optional[torch.Tensor] = None  # [nq, n1,n2,n3] exchange kernels at G + q,
    #                                             the scaling factor included
    exx_iq: Optional[torch.Tensor] = None      # [nk, nk] int64 q index of k - k'
    kin: Optional[torch.Tensor] = None         # [nk, nG] a blow-up's explicit kinetic,
    #                                             or None: kinetic_scale * kin
    Apot: Optional[torch.Tensor] = None        # [n1,n2,n3,3] vector potential (Magnetic)


@dataclasses.dataclass
class Terms:
    """Scalars of the terms, and their tensors in `data`."""
    E_ewald: float
    E_psp_correction: float
    xc: Sequence[Any]
    xc_scaling: float
    data: TermsData
    has_entropy: bool = False
    rho_core_np: Optional[np.ndarray] = None   # NLCC core density on the grid
    tau_core_np: Optional[np.ndarray] = None   # its kinetic-energy density (meta-GGA)
    exx_kernel_np: Optional[np.ndarray] = None  # [nq, n1,n2,n3] (TermsData.exx_kernel)
    exx_iq_np: Optional[np.ndarray] = None      # [nk, nk] int32
    hubbard_manifolds: Optional[tuple] = None
    kin_np: Optional[np.ndarray] = None         # [nk, nG] explicit kinetic (TermsData.kin)
    Apot_np: Optional[np.ndarray] = None        # [n1,n2,n3,3] vector potential
    anyonic: Optional[tuple] = None             # (hbar, beta, rho_ref, Aref), numpy fields
    local_nonlinearity: Optional[Callable] = None   # f(rho) of LocalNonlinearity
    E_pairwise: float = 0.0
    pairwise_forces: Optional[np.ndarray] = None    # [n_atoms, 3] reduced

    @property
    def needs_tau(self):
        """A meta-GGA functional is present: the SCF carries tau."""
        return any(f.family == "mgga" for f, _ in self.xc)


def instantiate_terms(basis) -> Terms:
    model = basis.model
    fft_size = basis.fft_size
    vloc = np.zeros(fft_size)
    hartree_coeffs = np.zeros(fft_size)
    P = np.zeros((basis.n_kpoints, basis.nG_max, 0), dtype=np.complex128)
    D = np.zeros((0, 0))
    E_ewald = 0.0
    E_psp = 0.0
    xc_functionals = []
    xc_scaling = 1.0
    kinetic_scale = 1.0
    has_entropy = False
    rho_core = tau_core = None
    exx_kernel = exx_iq = hubbard_manifolds = None
    kin = Apot = anyonic = local_nonlinearity = pairwise_forces = None
    E_pairwise = 0.0
    Gsq = basis.G_cube_cart_norm ** 2

    def r_cart():
        return np.einsum("ab,xyzb->xyza", model.lattice, basis.r_cube)

    for term in model.term_types:
        if isinstance(term, Kinetic):
            kinetic_scale = term.scaling_factor
            # the explicit kinetic only for a blow-up: a plain scaling
            # lives in kinetic_scale alone
            if has_blowup(term):
                pk = np.linalg.norm(basis.Gpk_cart_np, axis=-1)
                kin = (term.scaling_factor * 0.5 * pk ** 2 * term.blowup(pk, basis.Ecut)
                       * basis.mask_np)
        elif isinstance(term, ExternalFromReal):
            vloc += np.asarray(term.potential(r_cart()), dtype=np.float64)
        elif isinstance(term, ExternalFromValues):
            vals = np.asarray(term.potential_values, dtype=np.float64)
            if vals.shape != tuple(fft_size):
                raise ValueError(f"ExternalFromValues shape {vals.shape} != fft_size "
                                 f"{tuple(fft_size)}")
            vloc += vals
        elif isinstance(term, ExternalFromFourier):
            sqrt_vol = math.sqrt(model.unit_cell_volume)
            pot_G = np.asarray(term.potential(basis.G_cube_cart), dtype=np.complex128) / sqrt_vol
            vloc += np.fft.ifftn(pot_G).real * (np.prod(fft_size) / sqrt_vol)
        elif isinstance(term, LocalNonlinearity):
            local_nonlinearity = term.f
        elif isinstance(term, Magnetic):
            Apot = np.asarray(term.Apot(r_cart()), dtype=np.float64)
            if Apot.shape != tuple(fft_size) + (3,):
                raise ValueError(f"Magnetic: Apot gives shape {Apot.shape}, not "
                                 f"{tuple(fft_size) + (3,)}")
        elif isinstance(term, Anyonic):
            from .anyonic import make_div_free, reference_fields
            lat = model.lattice
            if model.n_dim != 2:
                raise ValueError("Anyonic requires a 2D lattice")
            if model.n_spin_components != 1:
                raise ValueError("Anyonic requires one spin component")
            if not (lat[0, 1] == lat[1, 0] == 0 and lat[0, 0] == lat[1, 1]):
                raise ValueError("Anyonic requires a square lattice (reference anyonic.jl:71-75)")
            rho_ref, Aref = reference_fields(lat, fft_size, model.n_electrons)
            anyonic = (float(term.hbar), float(term.beta), rho_ref,
                       make_div_free(Aref, basis.G_cube_cart))
        elif isinstance(term, PairwisePotential):
            from .pairwise import energy_forces_pairwise
            E, F = energy_forces_pairwise(model.lattice, model.atoms, np.stack(model.positions),
                                          term.V, term.params, max_radius=term.max_radius)
            E_pairwise, pairwise_forces = float(E), F.numpy()
        elif isinstance(term, AtomicLocal):
            vloc += _atomic_local_potential(basis)
        elif isinstance(term, AtomicNonlocal):
            PD = _build_nonlocal_projectors(basis)
            if PD is not None:
                P, D = PD
        elif isinstance(term, Hartree):
            coeffs = np.where(Gsq > 0, 4 * math.pi / np.where(Gsq > 0, Gsq, 1.0), 0.0)
            hartree_coeffs = term.scaling_factor * coeffs
        elif isinstance(term, Xc):
            xc_functionals = resolve_functionals(term.functionals)
            xc_scaling = term.scaling_factor
            rho_core = _atomic_superposition(basis, "has_core_density",
                                             "core_density_fourier")
            if any(f.family == "mgga" for f, _ in xc_functionals):
                tau_core = _atomic_superposition(basis, "has_core_tau", "core_tau_fourier")
        elif isinstance(term, Ewald):
            charges = np.array([at.charge_ionic() for at in model.atoms], dtype=float)
            if len(charges) > 0:
                eta = term.eta or default_eta(model.lattice)
                E_ewald = float(energy_ewald(model.lattice, charges,
                                             np.stack(model.positions), eta=eta,
                                             device=basis.device))
        elif isinstance(term, PspCorrection):
            E_psp = _energy_psp_correction(model)
        elif isinstance(term, Entropy):
            has_entropy = True
        elif isinstance(term, ExactExchange):
            # kernels for every k-difference q = k - k' (one cube at Gamma,
            # the reference's Gamma-only kernel)
            from .coulomb import Coulomb, exx_q_kernels
            vq, exx_iq = exx_q_kernels(term.kernel if term.kernel is not None
                                       else Coulomb(), basis)
            exx_kernel = term.scaling_factor * np.asarray(vq)
        elif isinstance(term, Hubbard):
            hubbard_manifolds = tuple(term.manifolds)
        else:
            raise NotImplementedError(f"Term {term} is not a term of this package")

    data = TermsData(
        vloc_static=basis.tensor(vloc), hartree_coeffs=basis.tensor(hartree_coeffs),
        P=basis.tensor(P, basis.dtype), D=basis.tensor(D),
        Gsq_cart=basis.tensor(Gsq), kinetic_scale=float(kinetic_scale),
        G_cart=basis.tensor(basis.G_cube_cart),
        rho_core=None if rho_core is None else basis.tensor(rho_core),
        tau_core=None if tau_core is None else basis.tensor(tau_core),
        exx_kernel=None if exx_kernel is None else basis.tensor(exx_kernel),
        exx_iq=None if exx_iq is None else basis.tensor(exx_iq, torch.int64),
        kin=None if kin is None else basis.tensor(kin),
        Apot=None if Apot is None else basis.tensor(Apot))
    return Terms(E_ewald=E_ewald, E_psp_correction=E_psp, xc=xc_functionals,
                 xc_scaling=xc_scaling, data=data, has_entropy=has_entropy,
                 rho_core_np=rho_core, tau_core_np=tau_core, exx_kernel_np=exx_kernel,
                 exx_iq_np=exx_iq, hubbard_manifolds=hubbard_manifolds, kin_np=kin,
                 Apot_np=Apot, anyonic=anyonic, local_nonlinearity=local_nonlinearity,
                 E_pairwise=E_pairwise, pairwise_forces=pairwise_forces)


def term_names(model):
    """The class names of the model's terms, with a Kinetic term whose
    blow-up changes the bare kinetic energies named "Kinetic blow-up"."""
    return {"Kinetic blow-up" if isinstance(t, Kinetic) and has_blowup(t)
            else type(t).__name__ for t in model.term_types}


def refuse_terms(model, what, names, gap):
    """Raise NotImplementedError where the model has one of the terms
    `names` (see `term_names`), which `what` leaves out in the JAX package
    without an error: `gap` says where (ROADMAP Queue 3)."""
    found = sorted(term_names(model) & set(names))
    if found:
        raise NotImplementedError(f"{what} with {', '.join(found)}: {gap}")


def refuse_anyonic(model, what):
    """Raise for an Anyonic model: its Hamiltonian depends on the orbitals
    through the current, so it is solved by `direct_minimization`, as the
    JAX package's self_consistent_field says (dftk_tpu/scf/driver.py:
    162-166); its other solvers and the response drop the term."""
    refuse_terms(model, what, ["Anyonic"],
                 "its Hamiltonian depends on the orbitals through the current, so it is "
                 "solved by direct_minimization, as in the JAX package and the reference "
                 "example examples/anyons.jl")


def _atomic_local_potential(basis):
    """Form factors x structure factors, iFFT'd (reference
    terms/local.jl:108-140); numpy, computed on the basis' device (the
    structure factors of a large cell are most of a basis' setup on the
    host)."""
    model = basis.model
    dev = basis.device
    Gnorm = basis.G_cube_cart_norm.reshape(-1)
    Gred = torch.as_tensor(basis.G_cube.reshape(-1, 3), dtype=torch.float64, device=dev)
    pot = torch.zeros(Gnorm.shape, dtype=torch.complex128, device=dev)
    for group in model.atom_groups:
        el = model.atoms[group[0]]
        if not hasattr(el, "local_potential_fourier"):
            continue
        ff = torch.as_tensor(np.asarray(el.local_potential_fourier(Gnorm)), device=dev)
        sf = torch.zeros_like(pot)
        for idx in group:
            pos = torch.as_tensor(model.positions[idx], device=dev)
            sf += torch.exp(-2j * math.pi * (Gred @ pos))
        pot += ff * sf
    pot /= math.sqrt(model.unit_cell_volume)
    N = np.prod(basis.fft_size)
    return (torch.fft.ifftn(pot.reshape(basis.fft_size)).real
            * (N / math.sqrt(model.unit_cell_volume))).cpu().numpy()


def projector_form_factors(psp, Gpk_cart, mask):
    """Projector form factors of one psp (no structure factor) at the
    Cartesian k+G tensor [nk, nG, 3]: complex [nk, nG, npp], zero on the
    padding and differentiable in Gpk_cart (the stresses trace it through
    the lattice), and the couplings D [npp, npp] (numpy, block diagonal).

    Projector order: l ascending, then m, then the radial index i
    (reference terms/nonlocal.jl:166-244)."""
    Gpk_sq = torch.sum(Gpk_cart * Gpk_cart, -1)
    Y = solid_harmonics_real(Gpk_cart, psp.lmax)
    D = np.zeros((psp.n_proj(), psp.n_proj()))
    cols = []
    for l in range(psp.lmax + 1):
        nproj_l = psp.n_proj_radial(l)
        if nproj_l == 0:
            continue
        rad = [psp.projector_fourier_sq(i, l, Gpk_sq) for i in range(1, nproj_l + 1)]
        for m in range(-l, l + 1):
            cols += [r * (-1j) ** l * Y[..., LM_INDEX[(l, m)]] for r in rad]
            blk = slice(len(cols) - nproj_l, len(cols))
            D[blk, blk] = np.array(psp.h[l])
    return torch.stack(cols, -1) * mask[..., None], D


def _build_nonlocal_projectors(basis):
    """P[nk, nG, nproj] with P[:, :, a] = ff * sf / sqrt(Omega) for each atom
    of each psp, D block diagonal; numpy, computed on the basis' device."""
    model = basis.model
    psp_groups = [g for g in model.atom_groups
                  if isinstance(model.atoms[g[0]], ElementPsp)
                  and model.atoms[g[0]].psp.n_proj() > 0]
    if not psp_groups:
        return None
    sqrt_vol = math.sqrt(model.unit_cell_volume)
    dev = basis.device
    Gpk = torch.as_tensor(basis.Gpk_cart_np, device=dev)
    mask = torch.as_tensor(basis.mask_np, device=dev)
    Gred_pk = torch.as_tensor(basis.Gred_np + basis.kcoords_spin[:, None, :], device=dev)
    Ps, Ds = [], []
    for group in psp_groups:
        ff, D = projector_form_factors(model.atoms[group[0]].psp, Gpk, mask)
        for atom_idx in group:
            pos = torch.as_tensor(model.positions[atom_idx], device=dev)
            sf = torch.exp(-2j * math.pi * (Gred_pk @ pos))
            Ps.append(ff * sf[..., None] / sqrt_vol)
            Ds.append(D)
    return torch.cat(Ps, -1).cpu().numpy(), scipy.linalg.block_diag(*Ds)


def _atomic_superposition(basis, has_attr, fourier_attr):
    """The superposition of the atoms' radial densities (the form factor
    `fourier_attr` of each atom that `has_attr`) on the real grid, clipped
    at 0, or None if no atom has one (reference atomic_total_density,
    src/density_methods.jl:117-121; the NLCC core density and the meta-GGA
    core kinetic-energy density, src/terms/xc.jl:45-53)."""
    model = basis.model
    if not any(getattr(at, has_attr, lambda: False)() for at in model.atoms):
        return None
    Gnorm = basis.G_cube_cart_norm.reshape(-1)
    Gred = basis.G_cube.reshape(-1, 3).astype(float)
    rho_G = np.zeros(Gnorm.shape, dtype=np.complex128)
    ff_cache = {}
    for i, at in enumerate(model.atoms):
        if not getattr(at, has_attr, lambda: False)():
            continue
        if at not in ff_cache:
            ff_cache[at] = np.asarray(getattr(at, fourier_attr)(Gnorm))
        rho_G += ff_cache[at] * np.exp(-2j * math.pi * (Gred @ np.asarray(model.positions[i])))
    rho_G /= math.sqrt(model.unit_cell_volume)
    N = np.prod(basis.fft_size)
    rho = np.fft.ifftn(rho_G.reshape(basis.fft_size)).real \
        * (N / math.sqrt(model.unit_cell_volume))
    return np.maximum(rho, 0.0)


def _energy_psp_correction(model):
    corr = sum(len(g) * model.atoms[g[0]].psp.energy_correction()
               for g in model.atom_groups if isinstance(model.atoms[g[0]], ElementPsp))
    return corr * model.n_electrons / model.unit_cell_volume
