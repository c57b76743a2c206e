"""SCF mixing preconditioners (reference `src/scf/mixing.jl`).

Port of `SimpleMixing` and `KerkerMixing` of `dftk_tpu/scf/mixing.py`.  A
mixing maps the density residual delta_F = rho_out - rho_in to a
preconditioned residual before damping and acceleration.  The spin channel
passes through Kerker unmixed, as in the reference (mixing.jl:54-103).
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
        factor = Gsq / (self.kTF ** 2 + Gsq)
        total = torch.sum(delta_F, dim=0)
        mixed_tot = torch.fft.ifftn(factor * torch.fft.fftn(total)).real
        if delta_F.shape[0] == 1:
            return mixed_tot[None]
        spin = delta_F[0] - delta_F[1]
        return torch.stack([(mixed_tot + spin) / 2, (mixed_tot - spin) / 2])
