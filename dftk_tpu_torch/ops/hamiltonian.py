"""Hamiltonian assembly and application (the hot path).

Port of `dftk_tpu/ops/hamiltonian.py` for the semilocal (LDA and GGA)
path.  One batched
function applies H to all k-points and bands at once:

    H psi = kin .* psi  +  local(V) psi  +  P D P^dag psi

The local part goes sphere -> compact cube (a torch gather) ->
`kernels/local_apply.py::local_apply` (the hand-written CUDA kernels on a
CUDA tensor, the plain einsum chain on a CPU tensor) -> compact cube ->
sphere.  Kinetic and nonlocal parts are torch ops (the nonlocal part is two
GEMMs over the G axis), as XLA computed them in the JAX package.

The total local potential V fuses AtomicLocal + Hartree(rho) + Xc(rho); the
XC potential is the `torch.autograd` gradient of the XC energy.  Under
collinear spin V has one channel per spin, and each k-point row applies
its own spin's channel (`basis_data.kspin`).
"""
from typing import NamedTuple

import torch

from ..kernels.local_apply import local_apply
from .pruned import PrunedFFT, compact_to_sphere, sphere_to_compact


class Ham(NamedTuple):
    """Everything needed to apply H at a fixed potential."""
    mask: torch.Tensor       # [nk, nG]
    kin: torch.Tensor        # [nk, nG] (includes the kinetic scaling)
    V_zxy: torch.Tensor      # [nk, n3, n1, n2] total local potential of each
    #                          k-point's spin, in the plane layout of local_apply
    P: torch.Tensor          # [nk, nG, nproj]
    D: torch.Tensor          # [nproj, nproj]
    pruned: PrunedFFT


def build_ham(basis_data, terms_data, V, pruned: PrunedFFT):
    V_zxy = V[basis_data.kspin].permute(0, 3, 1, 2).contiguous()
    return Ham(mask=basis_data.mask, kin=terms_data.kinetic_scale * basis_data.kin,
               V_zxy=V_zxy, P=terms_data.P, D=terms_data.D, pruned=pruned)


def apply_local(ham: Ham, psi):
    """The local-potential part of H psi for psi [nk, nb, nG]."""
    xc = sphere_to_compact(psi, ham.pruned)
    y = local_apply(xc, ham.V_zxy, ham.pruned.factors)
    return compact_to_sphere(y, ham.pruned, ham.mask)


def _p_dag(ham: Ham, psi):
    """P^dag psi: [nk, nb, nproj]."""
    return torch.einsum("kgp,kng->knp", ham.P.conj(), psi)


def apply_H(ham: Ham, psi):
    """H @ psi for psi [nk, nb, nG] -> [nk, nb, nG]."""
    out = ham.kin[:, None, :] * psi + apply_local(ham, psi)
    if ham.P.shape[-1] > 0:
        DPd = _p_dag(ham, psi) @ ham.D.to(psi.dtype).T
        out = out + torch.einsum("kgp,knp->kng", ham.P, DPd)
    return out * ham.mask[:, None, :]


# ---------------------------------------------------------------------------
# Density-dependent potential assembly + energies
# ---------------------------------------------------------------------------

def density_gradient_sigma(rho, G_cart):
    """The contracted density gradients of rho [nspin, n1, n2, n3]: sigma
    [1, grid] (|grad rho|^2), or [3, grid] (aa, ab, bb) under spin; the
    gradient is spectral, i G rho(G), with G_cart [n1, n2, n3, 3] (2 pi
    included), so autograd through it gives the GGA divergence term and,
    with G_cart built from the lattice, the GGA stress."""
    rho_G = torch.fft.fftn(rho, dim=(-3, -2, -1))
    grads = torch.stack([torch.fft.ifftn(1j * G_cart[..., a] * rho_G, dim=(-3, -2, -1)).real
                         for a in range(3)], dim=-1)          # [nspin, grid, 3]
    if rho.shape[0] == 1:
        return torch.sum(grads * grads, dim=-1)
    return torch.stack([torch.sum(grads[0] * grads[0], dim=-1),
                        torch.sum(grads[0] * grads[1], dim=-1),
                        torch.sum(grads[1] * grads[1], dim=-1)])


def xc_energy(functionals, rho, volume, scaling=1.0, G_cart=None):
    """Total XC energy of rho [nspin, n1, n2, n3]; G_cart [n1, n2, n3, 3]
    (Cartesian G of the cube) is needed by GGA functionals."""
    if not functionals:
        return torch.zeros((), dtype=rho.dtype, device=rho.device)
    dvol = volume / rho[0].numel()
    sigma = None
    if any(f.family == "gga" for f, _ in functionals):
        sigma = density_gradient_sigma(rho, G_cart.to(rho.dtype))
    E = sum(fscale * torch.sum(f.energy(rho, sigma)) for f, fscale in functionals)
    return scaling * E * dvol


def total_potential(terms, rho, volume):
    """Fused local potential V [nspin, grid] and the rho-dependent energies.

    rho: [nspin, n1, n2, n3].  Returns (V, energies) with 0-d tensors."""
    td = terms.data
    dvol = volume / rho[0].numel()
    rho_tot = torch.sum(rho, dim=0)
    energies = {}

    V = td.vloc_static.expand(rho.shape).to(rho.dtype)
    energies["AtomicLocal"] = torch.sum(rho_tot * td.vloc_static) * dvol

    VH = torch.fft.ifftn(td.hartree_coeffs * torch.fft.fftn(rho_tot)).real
    energies["Hartree"] = 0.5 * torch.sum(VH * rho_tot) * dvol
    V = V + VH[None]

    if terms.xc:
        with torch.enable_grad():
            r = rho.detach().requires_grad_(True)
            exc = xc_energy(terms.xc, r, volume, terms.xc_scaling, td.G_cart)
            (Vxc,) = torch.autograd.grad(exc, r)
        energies["Xc"] = exc.detach()
        V = V + Vxc / dvol
    return V, energies


def psi_energies(ham: Ham, psi, occupation, kweights):
    """Kinetic and nonlocal energies from the orbitals."""
    energies = {}
    wocc = kweights[:, None] * occupation
    abs2 = psi.real ** 2 + psi.imag ** 2
    energies["Kinetic"] = torch.sum(wocc[:, :, None] * ham.kin[:, None, :] * abs2)
    if ham.P.shape[-1] > 0:
        Pd = _p_dag(ham, psi)
        band_e = torch.einsum("knp,pq,knq->kn", Pd.conj(), ham.D.to(Pd.dtype), Pd).real
        energies["AtomicNonlocal"] = torch.sum(wocc * band_e)
    return energies
