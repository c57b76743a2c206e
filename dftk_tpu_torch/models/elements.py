"""Chemical elements as potential generators (host-side numpy).

Port of the `ElementPsp` part of `dftk_tpu/models/elements.py` (reference
`src/elements.jl`): an atom carrying an HGH pseudopotential.  The other
element kinds (Coulomb, Gaussian, Cohen-Bergstresser) come with later slices.
"""
import dataclasses

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


@dataclasses.dataclass(frozen=True)
class ElementPsp:
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
            psp = load_psp_hgh(psp)
        return cls(symbol=symbol, Z=Z, psp=psp)

    def charge_nuclear(self):
        return self.Z

    def charge_ionic(self):
        return self.psp.Zion

    def n_elec_valence(self):
        return self.charge_ionic()

    def n_elec_core(self):
        return self.charge_nuclear() - self.charge_ionic()

    def local_potential_fourier(self, p):
        return self.psp.local_fourier(p)

    def local_potential_fourier_sq(self, psq):
        """The local potential as a function of p^2 (a torch tensor in the
        stresses' graph)."""
        return self.psp.local_fourier_sq(psq)


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
