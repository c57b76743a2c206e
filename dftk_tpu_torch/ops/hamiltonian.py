"""Hamiltonian assembly and application (the hot path).

Port of `dftk_tpu/ops/hamiltonian.py` for the semilocal (LDA, GGA and
meta-GGA) path.  One batched function applies H to all k-points and bands
at once:

    H psi = kin .* psi  +  local(V) psi  +  1/2 sum_a p_a local(Vtau) p_a psi
            +  P D P^dag psi

with p = k + G.  Each local part goes sphere -> compact cube (a torch
gather) -> `kernels/local_apply.py::local_apply` (the hand-written CUDA
kernels A -> B -> A on a CUDA tensor, the plain einsum chain on a CPU
tensor) -> compact cube -> sphere.  The meta-GGA DivAgrad term (reference
DivAgradOperator, src/terms/operators.jl:145-161) stacks its three
p_a-scaled copies of psi along the band axis, so it is one more local apply
of 3 nb bands with Vtau in V's place.  Kinetic and nonlocal parts are
torch ops (the nonlocal part is two GEMMs over the G axis), as XLA computed
them in the JAX package.

`apply_H(..., precision="default")` is the one-pass bf16 apply of the
split SCF's sphere filter: complex64 data, the bf16 kernels, and the
nonlocal GEMMs on operands rounded to bf16 (P rounded once where the
complex64 Ham is made, `ops/engine_split.py::default_ham`), as the compact
filter's 'default' apply rounds them.

The Magnetic term A.(-i grad) (a Ham with `Apot`) is torch ops over cuFFT
on the whole cube, as XLA computed it in the JAX package
(`apply_magnetic`, the symmetrised 1/2 {A, p}).  The kinetic part is the
terms' explicit kinetic where one is set (a blow-up's), else
kinetic_scale |k+G|^2 / 2.

Exact (Fock) exchange, where the Ham carries an `Exchange`, is torch ops
over cuFFT, as XLA computed it in the JAX package: per generating orbital
a pair product on the full real-space cube, a forward FFT, a multiply by
the Coulomb kernel, an inverse FFT and an accumulation (`apply_exchange`;
at Gamma k-diagonal, on a k-grid every generator (k', m) acts on every
same-spin k through the kernel at G + (k - k')).  The SCF loops apply it
compressed (`ops/exx_ace.py`).

The total local potential V fuses AtomicLocal (with the External*
potentials) + Hartree(rho) + Xc(rho) + LocalNonlinearity(rho); the XC and
the nonlinearity's potentials are the `torch.autograd` gradients of their
energies, and under a
meta-GGA Vtau is its gradient in tau.  With an NLCC core density the
functional sees rho + rho_core (and tau + tau_core).  Under collinear spin
V has one channel per spin, and each k-point row applies its own spin's
channel (`basis_data.kspin`).
"""
import math
from typing import NamedTuple, Optional

import torch

from ..kernels.local_apply import local_apply, round_bf16
from ..parallel.mesh import ksum
from .density import density_gradients
from .fft import gather_from_cube, scatter_to_cube
from .pruned import PrunedFFT, compact_to_sphere, sphere_to_compact


class Exchange(NamedTuple):
    """The Fock exchange operator of a set of generating orbitals."""
    kernel: torch.Tensor     # [n1,n2,n3] at Gamma; [nq, n1,n2,n3] with iq
    psi: torch.Tensor        # [nk, nx, nG] generating orbitals
    occ: torch.Tensor        # [nk, nx] generator weights w_k f / filled
    Gidx: torch.Tensor       # [nk, nG] flat full-cube indices of the spheres
    mask: torch.Tensor       # [nk, nG]
    volume: float
    iq: Optional[torch.Tensor] = None     # [nk, nk'] q index of k - k' (k-grids)
    kspin: Optional[torch.Tensor] = None  # [nk] spin of each k row (k-grids)
    gen: Optional[tuple] = None           # (psi, occ, Gidx, mask, kspin) of the
    #                                       generators at every k' where they are not
    #                                       the rows above (a distributed k-grid)


def make_exchange(basis_data, terms_data, psi, occupation, filled, volume, comm=None):
    """The Exchange of generators psi [nk, nx, nG] at occupations [nk, nx]
    (weights w_k f / filled): the one kernel of a basis with one spatial
    k-point (exchange is then k-diagonal), else the kernels at G + q with
    their index map.  On a distributed k-grid (comm, `parallel/mesh.py::
    KComm`) each k row needs the generators at every k': they are
    all-gathered over "kpts" (with their spheres), and the q map's rows
    are this rank's."""
    kern = terms_data.exx_kernel
    gamma = kern.shape[0] == 1
    occ = basis_data.kweights[:, None] * occupation / filled
    gen = None
    if not gamma and comm is not None and comm.ksize > 1:
        gen = tuple(comm.kgather(t) for t in (psi, occ, basis_data.Gidx, basis_data.mask,
                                              basis_data.kspin))
    return Exchange(kernel=kern[0] if gamma else kern, psi=psi, occ=occ,
                    Gidx=basis_data.Gidx, mask=basis_data.mask, volume=volume,
                    iq=None if gamma else terms_data.exx_iq,
                    kspin=None if gamma else basis_data.kspin, gen=gen)


class Ham(NamedTuple):
    """Everything needed to apply H at a fixed potential."""
    mask: torch.Tensor       # [nk, nG]
    kin: torch.Tensor        # [nk, nG] (includes the kinetic scaling)
    V_zxy: torch.Tensor      # [nk, n3, n1, n2] total local potential of each
    #                          k-point's spin, in the plane layout of local_apply
    P: torch.Tensor          # [nk, nG, nproj]
    D: torch.Tensor          # [nproj, nproj]
    pruned: PrunedFFT
    Vtau_zxy: Optional[torch.Tensor] = None   # [nk, n3, n1, n2] meta-GGA Vtau
    Gpk: Optional[torch.Tensor] = None        # [nk, nG, 3] Cartesian k+G (Vtau, Apot)
    exx: Optional[Exchange] = None            # the bare Fock exchange term
    Apot: Optional[torch.Tensor] = None       # [n1,n2,n3,3] vector potential (Magnetic)
    Gidx: Optional[torch.Tensor] = None       # [nk, nG] full-cube indices (with Apot)


def to_zxy(V, kspin):
    """A potential [nspin, n1, n2, n3] as each k row's spin channel in the
    plane layout of local_apply: [nk, n3, n1, n2]."""
    return V[kspin].permute(0, 3, 1, 2).contiguous()


def kinetic(basis_data, terms_data):
    """The kinetic energies [nk, nG]: the terms' explicit kinetic (a
    blow-up's) where one is set, else kinetic_scale |k+G|^2 / 2."""
    if getattr(terms_data, "kin", None) is not None:
        return terms_data.kin
    return terms_data.kinetic_scale * basis_data.kin


def build_ham(basis_data, terms_data, V, pruned: PrunedFFT, Vtau=None, exx=None):
    """The Ham of the potential V [nspin, grid] (and Vtau), with the terms'
    kinetic, projectors and vector potential; V None gives a Ham for the
    parts that need no local potential (`psi_energies`)."""
    Apot = getattr(terms_data, "Apot", None)
    return Ham(mask=basis_data.mask, kin=kinetic(basis_data, terms_data),
               V_zxy=None if V is None else to_zxy(V, basis_data.kspin),
               P=terms_data.P, D=terms_data.D, pruned=pruned,
               Vtau_zxy=None if Vtau is None else to_zxy(Vtau, basis_data.kspin),
               Gpk=None if Vtau is None and Apot is None else basis_data.Gpk_cart, exx=exx,
               Apot=Apot, Gidx=None if Apot is None else basis_data.Gidx)


def apply_local(ham: Ham, psi, V_zxy=None, precision="highest"):
    """The local-potential part of H psi for psi [nk, nb, nG], with the
    potential V_zxy (default: ham's V)."""
    V = ham.V_zxy if V_zxy is None else V_zxy
    xc = sphere_to_compact(psi, ham.pruned)
    y = local_apply(xc, V, ham.pruned.factors, precision)
    return compact_to_sphere(y, ham.pruned, ham.mask)


def apply_divagrad(ham: Ham, psi, precision="highest"):
    """The meta-GGA term -1/2 div(Vtau grad psi) of H psi:
    1/2 sum_a p_a F[Vtau F^-1[p_a psi]] with p = k + G, the three axes
    stacked along the band axis into one local apply of 3 nb bands."""
    nb = psi.shape[1]
    p = ham.Gpk
    y3 = apply_local(ham, torch.cat([p[:, None, :, a] * psi for a in range(3)], dim=1),
                     ham.Vtau_zxy, precision)
    return 0.5 * sum(p[:, None, :, a] * y3[:, a * nb:(a + 1) * nb] for a in range(3))


def _p_dag(ham: Ham, psi):
    """P^dag psi: [nk, nb, nproj]."""
    return torch.einsum("kgp,kng->knp", ham.P.conj(), psi)


def apply_H(ham: Ham, psi, precision="highest"):
    """H @ psi for psi [nk, nb, nG] -> [nk, nb, nG].  precision "default"
    is the bf16 one-pass apply (module docstring) of a complex64 Ham."""
    out = ham.kin[:, None, :] * psi + apply_local(ham, psi, precision=precision)
    if ham.Vtau_zxy is not None:
        out = out + apply_divagrad(ham, psi, precision)
    if ham.P.shape[-1] > 0:
        r = round_bf16 if precision == "default" else (lambda a: a)
        DPd = _p_dag(ham, r(psi)) @ ham.D.to(psi.dtype).T
        out = out + torch.einsum("kgp,knp->kng", ham.P, r(DPd))
    if ham.Apot is not None:
        out = out + apply_magnetic(ham, psi)
    if ham.exx is not None:
        out = out + apply_exchange(ham.exx, psi)
    return out * ham.mask[:, None, :]


def apply_magnetic(ham: Ham, psi):
    """The Magnetic term A.(-i grad) psi for psi [nk, nb, nG], symmetrised,
    1/2 sum_a (A_a p_a + p_a A_a) with p = k + G (reference
    terms/magnetic.jl; exact when div A = 0), on the whole cube."""
    fft_size = tuple(ham.Apot.shape[:3])
    dims = (-3, -2, -1)
    Apot = ham.Apot.to(psi.real.dtype)
    p = ham.Gpk.to(psi.real.dtype)

    def to_r(x):
        return torch.fft.ifftn(scatter_to_cube(x, ham.Gidx, ham.mask, fft_size), dim=dims)

    def to_g(xr):
        return gather_from_cube(torch.fft.fftn(xr, dim=dims), ham.Gidx, ham.mask)

    psir = to_r(psi)
    out = 0.0
    for a in range(3):
        A = Apot[..., a]
        out = out + 0.5 * (to_g(A * to_r(p[:, None, :, a] * psi))
                           + p[:, None, :, a] * to_g(A * psir))
    return out


def apply_exchange(exx: Exchange, phi):
    """(Vx phi) for phi [nk, nb, nG] (reference operators.jl:192-210):

        (Vx phi)_kn(r) = - sum_{k'm} w_k' (f_k'm / filled) u_k'm(r)
                           Poisson_{k-k'}[u_k'm^* u_kn](r)

    on the periodic parts u; the Bloch phase difference q = k - k' moves
    into the kernel at G + q (exx.kernel[exx.iq[k, k']]).  One batched
    Poisson solve over all (k, n) per generating orbital; generators of
    zero weight add exactly nothing and are skipped."""
    fft_size = tuple(exx.kernel.shape[-3:])
    N = math.prod(fft_size)
    scale = N / math.sqrt(exx.volume)
    dims = (-3, -2, -1)
    phir = torch.fft.ifftn(scatter_to_cube(phi, exx.Gidx, exx.mask, fft_size), dim=dims) * scale
    gpsi, gocc, gGidx, gmask, gkspin = exx.gen or (exx.psi, exx.occ, exx.Gidx, exx.mask,
                                                   exx.kspin)
    psir = phir if phi is gpsi else torch.fft.ifftn(
        scatter_to_cube(gpsi.to(phi.dtype), gGidx, gmask, fft_size), dim=dims) * scale
    occ = gocc.to(phi.real.dtype)
    kern = exx.kernel.to(phi.real.dtype)
    acc = torch.zeros_like(phir)
    if exx.iq is None:
        for m in torch.nonzero(occ.ne(0).any(0)).flatten().tolist():
            psin = psir[:, m]                                    # [nk, grid]
            V = torch.fft.fftn(psin.conj()[:, None] * phir, dim=dims)
            V = torch.fft.ifftn(V.mul_(kern), dim=dims)
            acc.sub_(V.mul_((occ[:, m, None, None, None] * psin)[:, None]))
    else:
        # every generator (k', m) acts on the bands of every same-spin k
        iq, kspin = exx.iq, exx.kspin
        for kp, m in torch.nonzero(occ.ne(0)).tolist():
            psin = psir[kp, m]                                   # [grid]
            w = occ[kp, m] * (kspin == gkspin[kp]).to(occ.dtype)  # [nk]
            V = torch.fft.fftn(psin.conj() * phir, dim=dims)
            V = torch.fft.ifftn(V.mul_(kern[iq[:, kp]][:, None]), dim=dims)
            acc.sub_(V.mul_(w[:, None, None, None, None] * psin))
    back = torch.fft.fftn(acc, dim=dims) * (math.sqrt(exx.volume) / N)
    return gather_from_cube(back, exx.Gidx, exx.mask)


def exchange_energy(exx: Exchange, psi, occupation, kweights, comm=None):
    """E_x = 1/2 sum_kn w_k f_kn <psi_kn | Vx psi_kn> (operator-consistent;
    summed over the "kpts" axis of comm)."""
    band_e = torch.sum(psi.conj() * apply_exchange(exx, psi), -1).real
    return ksum(0.5 * torch.sum(kweights[:, None] * occupation * band_e), comm)


# ---------------------------------------------------------------------------
# Density-dependent potential assembly + energies
# ---------------------------------------------------------------------------

def density_gradient_sigma(rho, G_cart):
    """The contracted density gradients of rho [nspin, n1, n2, n3]: sigma
    [1, grid] (|grad rho|^2), or [3, grid] (aa, ab, bb) under spin; the
    gradient is spectral, i G rho(G), with G_cart [n1, n2, n3, 3] (2 pi
    included), so autograd through it gives the GGA divergence term and,
    with G_cart built from the lattice, the GGA stress."""
    grads = density_gradients(rho, G_cart)                  # [nspin, grid, 3]
    if rho.shape[0] == 1:
        return torch.sum(grads * grads, dim=-1)
    return torch.stack([torch.sum(grads[0] * grads[0], dim=-1),
                        torch.sum(grads[0] * grads[1], dim=-1),
                        torch.sum(grads[1] * grads[1], dim=-1)])


def xc_energy(functionals, rho, volume, scaling=1.0, G_cart=None, tau=None):
    """Total XC energy of rho [nspin, n1, n2, n3]; G_cart [n1, n2, n3, 3]
    (Cartesian G of the cube) is needed by GGA and meta-GGA functionals, tau
    (as rho) by meta-GGA ones.  Potential-only functionals (TB09) add no
    energy."""
    zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
    if not functionals:
        return zero
    dvol = volume / rho[0].numel()
    sigma = None
    if any(f.family in ("gga", "mgga") for f, _ in functionals):
        sigma = density_gradient_sigma(rho, G_cart.to(rho.dtype))
    E = zero
    for f, fscale in functionals:
        if f.energy is None:
            continue
        e = f.energy(rho, sigma, tau) if f.family == "mgga" else f.energy(rho, sigma)
        E = E + fscale * torch.sum(e)
    return scaling * E * dvol


def total_potential(terms, rho, volume, tau=None):
    """Fused local potential V [nspin, grid] and the rho-dependent energies.

    rho: [nspin, n1, n2, n3]; tau (as rho) is required by meta-GGA models.
    Returns (V, Vtau, energies) with 0-d tensors; Vtau is None unless tau
    is given."""
    td = terms.data
    nspin = rho.shape[0]
    dvol = volume / rho[0].numel()
    VH, energies = _local_hartree(td, rho, dvol)
    V = td.vloc_static.expand(rho.shape).to(rho.dtype) + VH[None]

    Vtau = None
    if terms.xc:
        # NLCC: the functional sees the valence plus the core density (and
        # the core kinetic-energy density, reference src/terms/xc.jl:100-104);
        # the constant shifts leave the gradients as they are
        rho_xc = _xc_density(terms, rho)
        tau_xc = None
        if tau is not None:
            tau_xc = tau if td.tau_core is None else tau + td.tau_core.to(tau.dtype)[None] / nspin
        with torch.enable_grad():
            r = rho_xc.detach().requires_grad_(True)
            t = None if tau_xc is None else tau_xc.detach().requires_grad_(True)
            exc = xc_energy(terms.xc, r, volume, terms.xc_scaling, td.G_cart, tau=t)
            if exc.requires_grad:
                grads = torch.autograd.grad(exc, [r] if t is None else [r, t],
                                            allow_unused=True)
            else:                        # no functional with an energy
                grads = (None, None)
        Vxc = grads[0] if grads[0] is not None else torch.zeros_like(rho)
        energies["Xc"] = exc.detach()
        V = V + Vxc / dvol
        if t is not None:
            Vtau = (grads[1] if grads[1] is not None else torch.zeros_like(tau)) / dvol
        # potential-only functionals (TB09): their multiplicative V is added
        # as it is, with no energy (not variational)
        for f, fscale in terms.xc:
            if f.potential is not None:
                if tau_xc is None:
                    raise ValueError(f"{f.name} needs tau")
                V = V + (terms.xc_scaling * fscale) * f.potential(
                    rho_xc, td.G_cart.to(rho.dtype), tau_xc)
    if terms.local_nonlinearity is not None:
        with torch.enable_grad():
            r = rho.detach().requires_grad_(True)
            e_nl = nonlinearity_energy(terms, r, volume)
            (v_nl,) = torch.autograd.grad(e_nl, r)
        energies["LocalNonlinearity"] = e_nl.detach()
        V = V + v_nl / dvol
    return V, Vtau, energies


def nonlinearity_energy(terms, rho, volume):
    """The LocalNonlinearity energy int f(rho_total) of rho [nspin, grid], a
    0-d tensor differentiable in rho (Gross-Pitaevskii: f = C rho^alpha;
    a non-integer alpha takes no negative density)."""
    return torch.sum(terms.local_nonlinearity(torch.sum(rho, dim=0))) * (volume / rho[0].numel())


def _local_hartree(td, rho, dvol):
    """The Hartree potential [grid] of rho [nspin, grid] and the AtomicLocal
    and Hartree energies (0-d tensors)."""
    rho_tot = torch.sum(rho, dim=0)
    VH = torch.fft.ifftn(td.hartree_coeffs * torch.fft.fftn(rho_tot)).real
    return VH, {"AtomicLocal": torch.sum(rho_tot * td.vloc_static) * dvol,
                "Hartree": 0.5 * torch.sum(VH * rho_tot) * dvol}


def _xc_density(terms, rho):
    """The density the functional sees: rho plus the NLCC core density."""
    rho_core = terms.data.rho_core
    return rho if rho_core is None else rho + rho_core.to(rho.dtype)[None] / rho.shape[0]


def _require_energy_functionals(terms, what):
    """Raise for functionals whose potential is not the derivative of an
    energy of rho alone: the potential-only ones (TB09) and the meta-GGAs
    (which need tau), as the JAX package's rho-only potential raises."""
    for f, _ in terms.xc:
        if f.potential is not None or f.family == "mgga":
            raise ValueError(f"{what} needs functionals of rho alone; {f.name} "
                             f"is {'potential-only' if f.potential is not None else 'a meta-GGA'}")


def density_energies(terms, rho, volume):
    """The rho-dependent energies of `total_potential` (AtomicLocal, Hartree,
    Xc, LocalNonlinearity), as differentiable functions of rho: what
    `total_potential` returns with its Xc and nonlinearity energies
    detached, here with the graph kept through the XC density (NLCC core
    included) and the nonlinearity, so that autograd of an energy of the
    orbitals carries their potentials (direct minimization).  Functionals
    of rho alone (LDA, GGA)."""
    _require_energy_functionals(terms, "density_energies")
    td = terms.data
    _, energies = _local_hartree(td, rho, volume / rho[0].numel())
    if terms.xc:
        energies["Xc"] = xc_energy(terms.xc, _xc_density(terms, rho), volume,
                                   terms.xc_scaling, td.G_cart)
    if terms.local_nonlinearity is not None:
        energies["LocalNonlinearity"] = nonlinearity_energy(terms, rho, volume)
    return energies


def xc_potential_derivative(terms, rho, drho, volume):
    """dV_xc/drho . drho [nspin, grid] at rho: the Hessian of the XC energy
    applied to drho (double backward through `xc_energy`), over dvol, the
    derivative of `total_potential`'s XC part.  Functionals of rho alone."""
    _require_energy_functionals(terms, "the XC kernel")
    if not terms.xc:
        return torch.zeros_like(rho)
    dvol = volume / rho[0].numel()
    with torch.enable_grad():
        r = _xc_density(terms, rho).detach().requires_grad_(True)
        exc = xc_energy(terms.xc, r, volume, terms.xc_scaling, terms.data.G_cart)
        if not exc.requires_grad:
            return torch.zeros_like(rho)
        (vxc,) = torch.autograd.grad(exc, r, create_graph=True)
        (dvxc,) = torch.autograd.grad(vxc, r, grad_outputs=drho.to(r.dtype))
    return dvxc / dvol


def nonlinearity_potential_derivative(terms, rho, drho, volume):
    """dV_nl/drho . drho [nspin, grid] of the LocalNonlinearity potential
    at rho (double backward through `nonlinearity_energy`, over dvol): the
    term's part of the response kernel K, as the JAX package's jvp of
    `total_potential` carries it."""
    dvol = volume / rho[0].numel()
    with torch.enable_grad():
        r = rho.detach().requires_grad_(True)
        (v,) = torch.autograd.grad(nonlinearity_energy(terms, r, volume), r, create_graph=True)
        (dv,) = torch.autograd.grad(v, r, grad_outputs=drho.to(r.dtype), allow_unused=True)
    return (torch.zeros_like(rho) if dv is None else dv) / dvol


def psi_energies(ham: Ham, psi, occupation, kweights, comm=None):
    """Kinetic, nonlocal and Magnetic energies from the orbitals (summed
    over the "kpts" axis of comm)."""
    energies = {}
    wocc = kweights[:, None] * occupation
    abs2 = psi.real ** 2 + psi.imag ** 2
    energies["Kinetic"] = torch.sum(wocc[:, :, None] * ham.kin[:, None, :] * abs2)
    if ham.P.shape[-1] > 0:
        Pd = _p_dag(ham, psi)
        band_e = torch.einsum("knp,pq,knq->kn", Pd.conj(), ham.D.to(Pd.dtype), Pd).real
        energies["AtomicNonlocal"] = torch.sum(wocc * band_e)
    if ham.Apot is not None:
        band_m = torch.sum(psi.conj() * apply_magnetic(ham, psi), -1).real
        energies["Magnetic"] = torch.sum(wocc * band_m)
    if comm is not None:
        energies = {k: comm.ksum(v) for k, v in energies.items()}
    return energies
