"""Smearing (finite-temperature occupation) functions on torch tensors.

Port of `dftk_tpu/models/smearing.py` (reference `src/Smearing.jl:24-167`).
Occupation f(x) and entropy s(x) of x = (eps - epsF)/T:
  * NoSmearing        - step function (zero temperature)
  * FermiDirac        - 1/(1+e^x)
  * Gaussian          - erfc(x)/2
  * MarzariVanderbilt - cold smearing
  * MethfesselPaxton(order)
"""
import dataclasses
import math

import torch


class SmearingFunction:
    monotone = True     # occupation monotone in x (Fermi bisection valid)

    def occupation(self, x):
        raise NotImplementedError

    def entropy(self, x):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class NoSmearing(SmearingFunction):
    def occupation(self, x):
        return torch.where(x > 0, 0.0, 1.0).to(x.dtype)

    def entropy(self, x):
        return torch.zeros_like(x)


@dataclasses.dataclass(frozen=True)
class FermiDirac(SmearingFunction):
    def occupation(self, x):
        return torch.sigmoid(-x)

    def entropy(self, x):
        f = self.occupation(x)
        return -(torch.special.xlogy(f, f) + torch.special.xlogy(1 - f, 1 - f))


@dataclasses.dataclass(frozen=True)
class Gaussian(SmearingFunction):
    def occupation(self, x):
        return torch.special.erfc(x) / 2

    def entropy(self, x):
        return torch.exp(-x * x) / (2 * math.sqrt(math.pi))


@dataclasses.dataclass(frozen=True)
class MarzariVanderbilt(SmearingFunction):
    """Cold smearing; the Fermi level is *not* unique with this smearing."""
    monotone = False

    def occupation(self, x):
        s2 = 1 / math.sqrt(2.0)
        return (-torch.special.erf(x + s2) / 2
                + torch.exp(-((-x - s2) ** 2)) / math.sqrt(2 * math.pi) + 0.5)

    def entropy(self, x):
        s2 = 1 / math.sqrt(2.0)
        return (x + s2) * torch.exp(-((-x - s2) ** 2)) / math.sqrt(2 * math.pi)


def _hermite(x, n):
    """Physicists' Hermite polynomial H_n(x) (unrolled recursion)."""
    if n < 0:
        return torch.zeros_like(x)
    h_prev, h = torch.zeros_like(x), torch.ones_like(x)
    for k in range(n):
        h_prev, h = h, 2 * x * h - 2 * k * h_prev
    return h


@dataclasses.dataclass(frozen=True)
class MethfesselPaxton(SmearingFunction):
    order: int = 1
    monotone = False

    def _A(self, n):
        return (-1) ** n / (math.factorial(n) * 4 ** n * math.sqrt(math.pi))

    def occupation(self, x):
        corr = sum(self._A(i) * _hermite(x, 2 * i - 1)
                   for i in range(1, self.order + 1))
        return torch.special.erfc(x) / 2 + corr * torch.exp(-x * x)

    def entropy(self, x):
        s = sum(self._A(i) * (_hermite(x, 2 * i) / 2 + 2 * i * _hermite(x, 2 * i - 2))
                for i in range(0, self.order + 1))
        return s * torch.exp(-x * x)
