"""Energy terms and their instantiation on a PlaneWaveBasis.

Port of `dftk_tpu/ops/terms.py::instantiate_terms` for the terms of the
DFT and hybrid paths: Kinetic, AtomicLocal, AtomicNonlocal, Hartree, Xc
(LDA, GGA and meta-GGA), Ewald, PspCorrection, Entropy, ExactExchange
(its Coulomb kernels at G + q for every k-point difference, from
`ops/coulomb.py::exx_q_kernels`) and Hubbard (its manifolds; the projectors
are built where the SCF starts, `ops/hubbard.py`), with any element (HGH
or UPF pseudopotentials, Coulomb, Gaussian, Cohen-Bergstresser).
Density-independent data (the local potential, the Hartree kernel, the
nonlocal projectors P and couplings D, the Ewald and psp correction
energies, the Cartesian G of the cube for gradients, and the NLCC core
density and, for meta-GGA, the core kinetic-energy density on the grid)
are built once on the host (the projectors' form factors by
`projector_form_factors`, a torch function that the stresses also trace
through the lattice) and held as tensors on the basis' device in
`Terms.data`; the density-dependent potentials are assembled each SCF step
by `ops/hamiltonian.py`.

Any other term raises NotImplementedError naming its ROADMAP item (11b).
"""
import dataclasses
import math
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import scipy.linalg
import torch

from ..models.elements import ElementPsp
from ..utils.special import LM_INDEX, solid_harmonics_real
from .ewald import default_eta, energy_ewald
from .xc.functionals import resolve_functionals


@dataclasses.dataclass(frozen=True)
class Kinetic:
    scaling_factor: float = 1.0


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
    Gsq = basis.G_cube_cart_norm ** 2

    for term in model.term_types:
        if isinstance(term, Kinetic):
            kinetic_scale = term.scaling_factor
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
            raise NotImplementedError(
                f"Term {term} is not ported yet: the port has Kinetic, "
                f"AtomicLocal, AtomicNonlocal, Hartree, Xc, Ewald, "
                f"PspCorrection, Entropy, ExactExchange and Hubbard (Magnetic, "
                f"Anyonic, PairwisePotential, LocalNonlinearity and the "
                f"External* terms: ROADMAP Queue 1, item 11b)")

    data = TermsData(
        vloc_static=basis.tensor(vloc), hartree_coeffs=basis.tensor(hartree_coeffs),
        P=basis.tensor(P, basis.dtype), D=basis.tensor(D),
        Gsq_cart=basis.tensor(Gsq), kinetic_scale=float(kinetic_scale),
        G_cart=basis.tensor(basis.G_cube_cart),
        rho_core=None if rho_core is None else basis.tensor(rho_core),
        tau_core=None if tau_core is None else basis.tensor(tau_core),
        exx_kernel=None if exx_kernel is None else basis.tensor(exx_kernel),
        exx_iq=None if exx_iq is None else basis.tensor(exx_iq, torch.int64))
    return Terms(E_ewald=E_ewald, E_psp_correction=E_psp, xc=xc_functionals,
                 xc_scaling=xc_scaling, data=data, has_entropy=has_entropy,
                 rho_core_np=rho_core, tau_core_np=tau_core, exx_kernel_np=exx_kernel,
                 exx_iq_np=exx_iq, hubbard_manifolds=hubbard_manifolds)


def _atomic_local_potential(basis):
    """Form factors x structure factors, iFFT'd on the host
    (reference terms/local.jl:108-140)."""
    model = basis.model
    Gnorm = basis.G_cube_cart_norm.reshape(-1)
    Gred = basis.G_cube.reshape(-1, 3).astype(float)
    pot = np.zeros(Gnorm.shape, dtype=np.complex128)
    for group in model.atom_groups:
        el = model.atoms[group[0]]
        ff = np.asarray(el.local_potential_fourier(Gnorm))
        sf = np.zeros(Gnorm.shape, dtype=np.complex128)
        for idx in group:
            sf += np.exp(1j * (-2 * math.pi * (Gred @ np.asarray(model.positions[idx]))))
        pot += ff * sf
    pot /= math.sqrt(model.unit_cell_volume)
    N = np.prod(basis.fft_size)
    return np.fft.ifftn(pot.reshape(basis.fft_size)).real \
        * (N / math.sqrt(model.unit_cell_volume))


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
    of each psp, D block diagonal."""
    model = basis.model
    psp_groups = [g for g in model.atom_groups
                  if isinstance(model.atoms[g[0]], ElementPsp)
                  and model.atoms[g[0]].psp.n_proj() > 0]
    if not psp_groups:
        return None
    sqrt_vol = math.sqrt(model.unit_cell_volume)
    Gpk = torch.as_tensor(basis.Gpk_cart_np)
    mask = torch.as_tensor(basis.mask_np)
    Gred_pk = torch.as_tensor(basis.Gred_np + basis.kcoords_spin[:, None, :])
    Ps, Ds = [], []
    for group in psp_groups:
        ff, D = projector_form_factors(model.atoms[group[0]].psp, Gpk, mask)
        for atom_idx in group:
            pos = torch.as_tensor(model.positions[atom_idx])
            sf = torch.exp(-2j * math.pi * (Gred_pk @ pos))
            Ps.append(ff * sf[..., None] / sqrt_vol)
            Ds.append(D)
    return torch.cat(Ps, -1).numpy(), scipy.linalg.block_diag(*Ds)


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
