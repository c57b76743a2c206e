"""Smearing (finite-temperature occupation) functions on torch tensors.

Port of `dftk_tpu/models/smearing.py` (reference `src/Smearing.jl:24-167`).
Occupation f(x) and entropy s(x) of x = (eps - epsF)/T:
  * NoSmearing        - step function (zero temperature)
  * FermiDirac        - 1/(1+e^x)
  * Gaussian          - erfc(x)/2
  * MarzariVanderbilt - cold smearing
  * MethfesselPaxton(order)

`occupation_derivative` (f' by `torch.autograd`) and
`occupation_divided_difference` serve the metallic response (chi0).
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

    def occupation_derivative(self, x):
        """f'(x) elementwise, by torch.autograd."""
        with torch.enable_grad():
            t = x.detach().requires_grad_(True)
            f = self.occupation(t)
            if not f.requires_grad:          # a step function: f' = 0 off the step
                return torch.zeros_like(x)
            (d,) = torch.autograd.grad(f.sum(), t)
        return d


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


def occupation_divided_difference(smearing, x, y, epsF, temperature):
    """(f(x) - f(y)) / (x - y) with f(z) = occupation((z - epsF) / T),
    computed stably where x ~ y (reference src/Smearing.jl:34): below
    |x - y| < 1e-7 max(|x|, |y|, T) the midpoint derivative replaces the
    quotient.  At T = 0 the step quotient, 0 for degenerate pairs."""
    if temperature == 0 or isinstance(smearing, NoSmearing):
        fx = torch.where(x < epsF, 1.0, 0.0).to(x.dtype)
        fy = torch.where(y < epsF, 1.0, 0.0).to(x.dtype)
        d = x - y
        big = d.abs() > 1e-30
        return torch.where(big, (fx - fy) / torch.where(big, d, 1.0), 0.0)
    T = temperature
    d = x - y
    small = d.abs() < 1e-7 * torch.clamp(torch.maximum(x.abs(), y.abs()), min=T)
    direct = (smearing.occupation((x - epsF) / T)
              - smearing.occupation((y - epsF) / T)) / torch.where(small, 1.0, d)
    mid = smearing.occupation_derivative(((x + y) / 2 - epsF) / T) / T
    return torch.where(small, mid, direct)
