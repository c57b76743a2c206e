"""Linear combinations of pseudopotentials (the virtual crystal
approximation).

Port of `dftk_tpu/models/psp_lincomb.py` (reference
`src/pseudo/PspLinComb.jl`): an alloyed "virtual" species whose local
potential, projectors and densities are coefficient-weighted sums of its
constituents'.  The nonlocal part concatenates the radial projectors of
every constituent per angular momentum and builds the block-diagonal
coupling h[l] = blkdiag(c_i h_i[l]), as the KB energy
sum_i c_i <psi|p_i> h_i <p_i|psi> requires.

Works with any psp the terms take (PspHgh, PspUpf, or another PspLinComb),
on numpy arrays and, through the constituents' `*_sq` evaluators, on
torch tensors.
"""
import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PspLinComb:
    coefficients: Tuple[float, ...]
    psps: Tuple[object, ...]
    identifier: str = ""
    description: str = "linear combination of pseudopotentials"

    def __post_init__(self):
        if len(self.coefficients) != len(self.psps) or not self.psps:
            raise ValueError("PspLinComb needs one coefficient per psp, and a psp")
        object.__setattr__(self, "coefficients", tuple(float(c) for c in self.coefficients))
        object.__setattr__(self, "psps", tuple(self.psps))
        if not self.identifier:
            ident = "+".join(f"{c:g}*{getattr(p, 'identifier', '?')}"
                             for c, p in zip(self.coefficients, self.psps))
            object.__setattr__(self, "identifier", f"lincomb({ident})")

    def _sum(self, method, *args):
        return sum(c * getattr(p, method)(*args) for c, p in zip(self.coefficients, self.psps))

    @property
    def Zion(self):
        return sum(c * p.Zion for c, p in zip(self.coefficients, self.psps))

    # -- the local part ----------------------------------------------------------
    def local_fourier(self, p):
        return self._sum("local_fourier", p)

    def local_fourier_sq(self, psq):
        return self._sum("local_fourier_sq", psq)

    def local_real(self, r):
        return self._sum("local_real", r)

    def energy_correction(self):
        return self._sum("energy_correction")

    # -- the nonlocal part: the constituents' radial projectors in a row --------
    @property
    def lmax(self):
        return max(p.lmax for p in self.psps)

    def n_proj_radial(self, l):
        return sum(p.n_proj_radial(l) if l <= p.lmax else 0 for p in self.psps)

    def n_proj(self):
        return sum((2 * l + 1) * self.n_proj_radial(l) for l in range(self.lmax + 1))

    def _locate(self, i, l):
        """The constituent and its 1-based radial index of the combination's
        radial projector i (1-based) of channel l."""
        for psp in self.psps:
            n = psp.n_proj_radial(l) if l <= psp.lmax else 0
            if i <= n:
                return psp, i
            i -= n
        raise IndexError(f"projector index out of range (l={l})")

    def projector_fourier(self, i, l, p):
        psp, j = self._locate(i, l)
        return psp.projector_fourier(j, l, p)

    def projector_fourier_sq(self, i, l, psq):
        psp, j = self._locate(i, l)
        return psp.projector_fourier_sq(j, l, psq)

    @property
    def h(self):
        """Per l, the block-diagonal coupling blkdiag over psps of c_i h_i[l]."""
        out = []
        for l in range(self.lmax + 1):
            n = self.n_proj_radial(l)
            H = np.zeros((n, n))
            off = 0
            for c, psp in zip(self.coefficients, self.psps):
                nl = psp.n_proj_radial(l) if l <= psp.lmax else 0
                if nl:
                    H[off:off + nl, off:off + nl] = c * np.asarray(psp.h[l])
                    off += nl
            out.append(H)
        return tuple(out)

    # -- densities ---------------------------------------------------------------
    def _has(self, what):
        return [getattr(p, what, lambda: False)() for p in self.psps]

    def _sum_where(self, has, method, *args):
        return sum(c * getattr(p, method)(*args)
                   for c, p, h in zip(self.coefficients, self.psps, self._has(has)) if h)

    def has_valence_density(self):
        return all(self._has("has_valence_density"))

    def valence_density_fourier(self, p):
        return self._sum("valence_density_fourier", p)

    def has_core_density(self):
        return any(self._has("has_core_density"))

    def core_density_fourier(self, p):
        return self._sum_where("has_core_density", "core_density_fourier", p)

    def core_density_fourier_sq(self, psq):
        return self._sum_where("has_core_density", "core_density_fourier_sq", psq)

    def has_core_tau(self):
        return any(self._has("has_core_tau"))

    def core_tau_fourier(self, p):
        return self._sum_where("has_core_tau", "core_tau_fourier", p)

    def core_tau_fourier_sq(self, psq):
        return self._sum_where("has_core_tau", "core_tau_fourier_sq", psq)


def virtual_crystal_approximation(el1, el2, x, symbol=None):
    """The ElementPsp of the alloy (1 - x) el1 + x el2 (VCA); el1 and el2
    are ElementPsp of the end members, x in [0, 1]."""
    from .elements import ElementPsp
    psp = PspLinComb((1.0 - x, x), (el1.psp, el2.psp))
    return ElementPsp(symbol=symbol or f"{el1.symbol}{el2.symbol}",
                      Z=(1.0 - x) * el1.Z + x * el2.Z, psp=psp)
