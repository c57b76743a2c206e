"""SCF mixing preconditioners (reference `src/scf/mixing.jl`).

Port of `SimpleMixing`, `KerkerMixing` and `DielectricMixing` of
`dftk_tpu/scf/mixing.py`.  A mixing maps the density residual
delta_F = rho_out - rho_in to a preconditioned residual before damping and
acceleration.  The spin channel passes through unmixed, as in the
reference (mixing.jl:54-103).
"""
import dataclasses

import torch


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


def _apply_fourier_factor_total(delta_F, factor):
    """A Fourier-space factor on the total density channel of delta_F
    [nspin, n1, n2, n3]; the (alpha - beta) channel passes unchanged."""
    total = torch.sum(delta_F, dim=0)
    mixed_tot = torch.fft.ifftn(factor * torch.fft.fftn(total)).real
    if delta_F.shape[0] == 1:
        return mixed_tot[None]
    spin = delta_F[0] - delta_F[1]
    return torch.stack([(mixed_tot + spin) / 2, (mixed_tot - spin) / 2])
