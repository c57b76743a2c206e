"""Chemical elements as potential generators (host-side numpy).

Port of `dftk_tpu/models/elements.py` (reference `src/elements.jl:8-269`):
  * ElementPsp      - an atom with a norm-conserving pseudopotential (the
                      built-in HGH tables, a UPF file, or a PspLinComb)
  * ElementCoulomb  - the all-electron -Z/r potential
  * ElementGaussian - a model Gaussian attractive potential
  * ElementCohenBergstresser - the empirical Si/Ge/Sn form factors

Each implements `local_potential_fourier(p)` (numpy over Cartesian |p|)
and `local_potential_fourier_sq(p^2)`, which also takes a torch tensor (the
stresses trace it through the lattice), and gives its charges for Ewald
and the electron count.
"""
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .psp_hgh import PspHgh, load_psp_hgh

ATOMIC_SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn",
]
ATOMIC_NUMBERS = {s: i for i, s in enumerate(ATOMIC_SYMBOLS)}


def atomic_symbol(z):
    return ATOMIC_SYMBOLS[z]


def _xp(a):
    """The array module of `a`: torch for a tensor, else numpy."""
    return torch if torch.is_tensor(a) else np


class Element:
    """Base class: an atom species generating potentials."""

    def charge_nuclear(self):
        return 0

    def charge_ionic(self):
        """The charge the valence electrons see (Ewald)."""
        return self.charge_nuclear()

    def n_elec_valence(self):
        return self.charge_ionic()

    def n_elec_core(self):
        return self.charge_nuclear() - self.charge_ionic()

    def local_potential_fourier(self, p):
        raise NotImplementedError

    def local_potential_fourier_sq(self, psq):
        """The local potential in Fourier space as a function of p^2."""
        return self.local_potential_fourier(_xp(psq).sqrt(psq))

    def has_valence_density(self):
        return False

    def has_core_density(self):
        return False

    def has_core_tau(self):
        return False


@dataclasses.dataclass(frozen=True)
class ElementPsp(Element):
    symbol: str
    Z: int
    psp: PspHgh

    @classmethod
    def from_symbol(cls, symbol_or_z, psp=None, family: str = "lda"):
        symbol = (atomic_symbol(symbol_or_z) if isinstance(symbol_or_z, int)
                  else symbol_or_z)
        Z = ATOMIC_NUMBERS[symbol]
        if psp is None:
            if family.lower() == "lda":
                psp = load_psp_hgh(symbol)
            else:
                from .psp_data import DEFAULT_Q_SEMICORE
                psp = load_psp_hgh(f"{family.lower()}/{symbol.lower()}"
                                   f"-q{DEFAULT_Q_SEMICORE[symbol]}")
        elif isinstance(psp, str):
            if psp.endswith(".upf") or psp.endswith(".UPF"):
                from .psp_upf import load_psp_upf
                psp = load_psp_upf(psp)
            else:
                psp = load_psp_hgh(psp)
        return cls(symbol=symbol, Z=Z, psp=psp)

    def has_valence_density(self):
        return getattr(self.psp, "has_valence_density", lambda: False)()

    def has_core_density(self):
        return getattr(self.psp, "has_core_density", lambda: False)()

    def has_core_tau(self):
        """A core kinetic-energy density is present (meta-GGA NLCC;
        reference has_core_kinetic_energy_density,
        src/density_methods.jl:225)."""
        return getattr(self.psp, "has_core_tau", lambda: False)()

    def valence_density_fourier(self, p):
        return self.psp.valence_density_fourier(p)

    def core_density_fourier(self, p):
        return self.psp.core_density_fourier(p)

    def core_tau_fourier(self, p):
        return self.psp.core_tau_fourier(p)

    def charge_nuclear(self):
        return self.Z

    def charge_ionic(self):
        return self.psp.Zion

    def local_potential_fourier(self, p):
        return self.psp.local_fourier(p)

    def local_potential_fourier_sq(self, psq):
        """The local potential as a function of p^2 (a torch tensor in the
        stresses' graph)."""
        return self.psp.local_fourier_sq(psq)

    def local_potential_real(self, r):
        return self.psp.local_real(r)


@dataclasses.dataclass(frozen=True)
class ElementCoulomb(Element):
    Z: int
    symbol: Optional[str] = None

    def charge_nuclear(self):
        return self.Z

    def local_potential_fourier(self, p):
        """-4 pi Z / p^2, zero at p = 0 (the compensating background)."""
        return self.local_potential_fourier_sq(p * p)

    def local_potential_fourier_sq(self, psq):
        xp = _xp(psq)
        ps = xp.where(psq == 0, 1.0, psq)
        return xp.where(psq == 0, 0.0, -4 * math.pi * self.Z / ps)


@dataclasses.dataclass(frozen=True)
class ElementGaussian(Element):
    """V(r) = -alpha / (sqrt(2 pi) L) exp(-(r / L)^2 / 2): a charge-free
    model atom."""
    alpha: float
    L: float
    symbol: str = "X"

    def local_potential_fourier(self, p):
        return self.local_potential_fourier_sq(p * p)

    def local_potential_fourier_sq(self, psq):
        return -self.alpha * _xp(psq).exp(-(psq * self.L ** 2) / 2)

    def local_potential_real(self, r):
        return -self.alpha / (math.sqrt(2 * math.pi) * self.L) \
            * _xp(r).exp(-((r / self.L) ** 2) / 2)


@dataclasses.dataclass(frozen=True)
class ElementCohenBergstresser(Element):
    """The empirical local potential of Cohen and Bergstresser (PRB 141,
    789 (1966)) for Si, Ge and Sn: form factors at the |G|^2 = 3, 8, 11
    shells (in units of (2 pi / a)^2), for band structures without SCF."""
    symbol: str = "Si"

    # V3, V8, V11 symmetric form factors in Ry, and lattice constants (bohr)
    _DATA = {
        "Si": dict(a=10.26, form_factors={3: -0.21, 8: 0.04, 11: 0.08}),
        "Ge": dict(a=10.69, form_factors={3: -0.23, 8: 0.01, 11: 0.06}),
        "Sn": dict(a=12.25, form_factors={3: -0.20, 8: 0.00, 11: 0.04}),
    }

    def charge_nuclear(self):
        return ATOMIC_NUMBERS[self.symbol]

    def charge_ionic(self):
        return 4

    @property
    def lattice_constant(self):
        return self._DATA[self.symbol]["a"]

    def local_potential_fourier(self, p):
        xp = _xp(p)
        data = self._DATA[self.symbol]
        psq_unit = (p / (2 * math.pi / data["a"])) ** 2
        out = xp.zeros_like(p)
        vol_per_atom = data["a"] ** 3 / 8      # form factors per 2-atom cell
        for shell, V_ry in data["form_factors"].items():
            out = xp.where(xp.abs(psq_unit - shell) < 1e-6, V_ry / 2 * vol_per_atom, out)
        return out


# Gaussian guess-density decay lengths (ABINIT m_atomdata coefficient table,
# same data as DFTK density_methods.jl:286-323)
_DECAY_TABLES = [
    (0.5, [0.6, 0.4, 0.3, 0.25, 0.2]),
    (2.5, [1.8, 1.4, 1.0, 0.7, 0.6, 0.5, 0.4, 0.35, 0.3]),
    (10.5, [2.0, 1.6, 1.25, 1.1, 1.0, 0.9, 0.8, 0.7, 0.7, 0.7, 0.6]),
    (12.5, [1.9, 1.5, 1.15, 1.0, 0.9, 0.8, 0.7, 0.6, 0.6, 0.6, 0.5]),
    (18.5, [2.0, 1.8, 1.5, 1.2, 1.0, 0.9, 0.85, 0.8, 0.75, 0.7, 0.65, 0.65, 0.6]),
    (28.5, [1.5, 1.25, 1.15, 1.05, 1.00, 0.95, 0.95, 0.9, 0.9, 0.85, 0.85, 0.80,
            0.8, 0.75, 0.7]),
    (36.5, [2.0, 2.00, 1.60, 1.40, 1.25, 1.10, 1.00, 0.95, 0.90, 0.85, 0.80,
            0.75, 0.7]),
    (float("inf"), [2.0, 2.00, 1.55, 1.25, 1.15, 1.10, 1.05, 1.0, 0.95, 0.9,
                    0.85, 0.85, 0.8]),
]


def atom_decay_length(element):
    """Decay length of the Gaussian valence-density guess for this element."""
    n_core = element.n_elec_core()
    n_val = int(round(element.n_elec_valence()))
    if n_val == 0:
        return 0.0
    for bound, data in _DECAY_TABLES:
        if n_core < bound:
            return data[min(n_val, len(data)) - 1]
    raise AssertionError
