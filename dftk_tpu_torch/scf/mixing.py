"""SCF mixing preconditioners (reference `src/scf/mixing.jl`).

Port of `SimpleMixing`, `KerkerMixing`, `DielectricMixing`, `LdosMixing`,
`KerkerDosMixing`, `HybridMixing` and `Chi0Mixing` of
`dftk_tpu/scf/mixing.py`.  A mixing
maps the density residual delta_F = rho_out - rho_in to a preconditioned
residual before damping and acceleration.  The spin channel passes through
unmixed, as in the reference (mixing.jl:54-103), except for
KerkerDosMixing's Delta-DOS coupling.

The LDOS-based mixings (`needs_ldos`) take the local density of states at
the Fermi level from the SCF driver (`scf/driver.py::ldos_at`); the model
dielectric equation of LdosMixing and HybridMixing is solved by the port's
`response/hessian.py::gmres`.  Chi0Mixing (`needs_state`) takes the current
iterate from `self_consistent_field` and applies the exact chi0 through the Sternheimer
equations (`response/chi0.py`).
"""
import dataclasses
import math

import torch

from ..response.chi0 import apply_chi0
from ..response.hessian import gmres


@dataclasses.dataclass(frozen=True)
class SimpleMixing:
    def mix_density(self, delta_F, Gsq):
        return delta_F


@dataclasses.dataclass(frozen=True)
class KerkerMixing:
    """delta_rho(G) = delta_F(G) * G^2/(kTF^2 + G^2); DC component killed."""
    kTF: float = 0.8

    def mix_density(self, delta_F, Gsq):
        return _apply_fourier_factor_total(delta_F, Gsq / (self.kTF ** 2 + Gsq))


@dataclasses.dataclass(frozen=True)
class DielectricMixing:
    """Model dielectric of Levitt: eps^-1 with parameters (epsilon_r, kTF)."""
    epsilon_r: float = 10.0
    kTF: float = 0.8

    def mix_density(self, delta_F, Gsq):
        # eps(G) = 1 + (eps_r - 1) kTF^2 / (kTF^2 + G^2); mix with 1/eps
        eps = 1 + (self.epsilon_r - 1) * self.kTF ** 2 / (self.kTF ** 2 + Gsq)
        return _apply_fourier_factor_total(delta_F, 1.0 / eps)


def _hartree_kernel(Gsq):
    """4 pi / G^2, 0 at G = 0."""
    nonzero = Gsq > 0
    return torch.where(nonzero, 4 * math.pi / torch.where(nonzero, Gsq, 1.0), 0.0)


def _fourier_apply(factor, x):
    return torch.fft.ifftn(factor * torch.fft.fftn(x)).real


def _with_spin(mixed_tot, delta_F):
    """[mixed total] or the spin channels of (mixed total, unmixed spin)."""
    if delta_F.shape[0] == 1:
        return mixed_tot[None]
    spin = delta_F[0] - delta_F[1]
    return torch.stack([(mixed_tot + spin) / 2, (mixed_tot - spin) / 2])


def _ldos_chi0(ldos, dvol):
    """The LDOS model of chi0, dV -> -ldos dV + ldos <ldos, dV> / D, with
    ldos the spin-summed LDOS [grid] and D its integral; None for None."""
    if ldos is None:
        return None
    ldos_tot = torch.sum(ldos, dim=0)
    dos = torch.clamp(torch.sum(ldos_tot) * dvol, min=1e-14)
    return lambda dV: -ldos_tot * dV + ldos_tot * (torch.sum(ldos_tot * dV) * dvol / dos)


@dataclasses.dataclass(frozen=True)
class LdosMixing:
    """chi0-model mixing (the reference default, mixing.jl:196-233):
    delta_rho solves (1 - K chi0_model) delta_rho = delta_F with the LDOS
    rank-1 + diagonal model of chi0 and K the Hartree kernel, by GMRES of
    elementwise and FFT matvecs.  Kerker-like in metals, about the identity
    in insulators (ldos -> 0)."""
    alpha: float = 0.8
    tol: float = 1e-5
    maxiter: int = 20
    needs_ldos = True

    def mix_density(self, delta_F, Gsq, ldos=None, dvol=None, volume=None):
        """volume is taken (and not used) as the other LDOS mixings take it."""
        if ldos is None or dvol is None:
            return delta_F
        vc = _hartree_kernel(Gsq)
        chi0 = _ldos_chi0(ldos, dvol)
        eps = lambda drho: drho - chi0(_fourier_apply(vc, drho))
        return _with_spin(gmres(eps, torch.sum(delta_F, dim=0), tol=self.tol,
                                maxiter=self.maxiter), delta_F)


@dataclasses.dataclass(frozen=True)
class KerkerDosMixing:
    """Kerker with kTF^2 = 4 pi DOS / Omega from the current spectrum, and
    the spin channel's Delta-DOS coupling
        drho_spin = dF_spin - 4 pi (DDOS / Omega) dF_tot / (kTF^2 + G^2)
    (reference mixing.jl:54-121).  The driver's LDOS sums the spins, as the
    JAX package's does, and then DDOS is 0."""
    alpha: float = 0.8
    needs_ldos = True

    def mix_density(self, delta_F, Gsq, ldos=None, dvol=None, volume=None):
        if ldos is None:
            return delta_F
        dos_sigma = torch.sum(ldos, dim=(1, 2, 3)) * dvol          # [nspin of ldos]
        vol = volume if volume is not None else 1.0
        kTF2 = torch.clamp(4 * math.pi * torch.sum(dos_sigma) / vol, min=1e-8)
        tot_F = torch.fft.fftn(torch.sum(delta_F, dim=0))
        mixed_tot = torch.fft.ifftn(tot_F * Gsq / (kTF2 + Gsq)).real
        if delta_F.shape[0] == 1:
            return mixed_tot[None]
        ddos = ((dos_sigma[0] - dos_sigma[1]) / vol if dos_sigma.shape[0] > 1
                else torch.zeros((), dtype=dos_sigma.dtype, device=dos_sigma.device))
        spin_F = torch.fft.fftn(delta_F[0] - delta_F[1]) \
            - tot_F * (4 * math.pi * ddos) / (kTF2 + Gsq)
        mixed_spin = torch.fft.ifftn(spin_F).real
        return torch.stack([(mixed_tot + mixed_spin) / 2, (mixed_tot - mixed_spin) / 2])


@dataclasses.dataclass(frozen=True)
class HybridMixing:
    """chi0-model mixing with the LDOS and a model-dielectric term (reference
    mixing.jl:196, chi0terms = [DielectricModel, LdosModel]):

        chi0(dV) = -ldos dV + ldos <ldos, dV> / D
                   + IFFT[ C0 G^2 / (4 pi (1 - C0 G^2 / kTF^2)) ] FFT dV

    with C0 = 1 - eps_r; solves (1 - K chi0) drho = dF by GMRES."""
    epsilon_r: float = 10.0
    kTF: float = 0.8
    alpha: float = 0.8
    tol: float = 1e-5
    maxiter: int = 20
    needs_ldos = True

    def mix_density(self, delta_F, Gsq, ldos=None, dvol=None, volume=None):
        C0 = 1.0 - self.epsilon_r
        diel = C0 * Gsq / (4 * math.pi * (1 - C0 * Gsq / self.kTF ** 2))
        vc = _hartree_kernel(Gsq)
        chi0_ldos = _ldos_chi0(ldos, dvol)

        def chi0(dV):
            out = _fourier_apply(diel, dV)
            return out if chi0_ldos is None else out + chi0_ldos(dV)

        eps = lambda drho: drho - chi0(_fourier_apply(vc, drho))
        return _with_spin(gmres(eps, torch.sum(delta_F, dim=0), tol=self.tol,
                                maxiter=self.maxiter), delta_F)


@dataclasses.dataclass(frozen=True)
class Chi0Mixing:
    """Exact chi0 mixing (reference Applychi0Model, chi0models.jl:45): solves
    (1 - K chi0) drho = dF by GMRES with K the Hartree kernel and chi0
    applied through the Sternheimer equations of the current iterate (a
    batched CG per GMRES matvec, each step one apply of H).  Expensive but
    free of parameters; a reference mixing for hard cases.  needs_state:
    `self_consistent_field` passes the iterate as a
    `response/chi0.py::Chi0Context`."""
    tol: float = 1e-3
    maxiter: int = 6
    sternheimer_tol: float = 1e-6
    needs_state = True

    def mix_density(self, delta_F, Gsq, basis=None, ctx=None):
        vc = _hartree_kernel(Gsq)

        def K(drho):              # the RPA (Hartree) kernel of the total density
            return _fourier_apply(vc, torch.sum(drho, dim=0)).expand(drho.shape)

        return gmres(lambda drho: drho - apply_chi0(ctx, basis, K(drho),
                                                    tol=self.sternheimer_tol),
                     delta_F, tol=self.tol, maxiter=self.maxiter)


def _apply_fourier_factor_total(delta_F, factor):
    """A Fourier-space factor on the total density channel of delta_F
    [nspin, n1, n2, n3]; the (alpha - beta) channel passes unchanged."""
    return _with_spin(_fourier_apply(factor, torch.sum(delta_F, dim=0)), delta_F)
