"""The Model: physics specification of a periodic Kohn-Sham problem.

Port of `dftk_tpu/models/model.py` (reference `src/Model.jl:6-219`): lattice,
atoms + positions, electron count, spin mode, temperature + smearing and the
list of energy-term specs.  Host-side numpy; `PlaneWaveBasis` turns it
into tensors.

Symmetry is not ported yet: `symmetries` takes `False` or a list holding the
identity only.  Symmetry detection, IBZ reduction and the density
symmetrizer are the next slice (ROADMAP Queue 1, "Symmetry").
"""
import dataclasses
import math
from typing import Any, List, Optional, Sequence

import numpy as np

from ..utils import lattice as lat
from .smearing import FermiDirac, NoSmearing, SmearingFunction

_SYMMETRY_TODO = ("symmetry detection, IBZ reduction and the density "
                  "symmetrizer are not ported yet (ROADMAP Queue 1, "
                  "'Symmetry'); build the model with symmetries=False")


@dataclasses.dataclass(frozen=True)
class SymOp:
    """A crystal symmetry (W, w): r -> W r + w in reduced coordinates."""
    W: tuple
    w: tuple

    @classmethod
    def identity(cls):
        return cls(W=((1, 0, 0), (0, 1, 0), (0, 0, 1)), w=(0.0, 0.0, 0.0))


def _is_identity(op):
    """True for an identity op given as anything with W and w attributes."""
    return (np.array_equal(np.asarray(op.W), np.eye(3))
            and np.allclose(np.asarray(op.w, dtype=float), 0))


@dataclasses.dataclass
class Model:
    lattice: np.ndarray                  # 3x3, columns = lattice vectors (bohr)
    atoms: List[Any]                     # Element objects (may be empty)
    positions: List[np.ndarray]          # fractional coordinates
    n_electrons: Optional[int] = None
    temperature: float = 0.0
    smearing: Optional[SmearingFunction] = None
    spin_polarization: str = "none"      # none | collinear | spinless
    term_types: Sequence[Any] = ()
    symmetries: Any = True               # False, or a list of identity ops
    magnetic_moments: Sequence[Any] = ()
    extra_charge: float = 0.0

    # derived (filled in __post_init__)
    recip_lattice: np.ndarray = None
    inv_lattice: np.ndarray = None
    unit_cell_volume: float = None
    atom_groups: List[List[int]] = None

    def __post_init__(self):
        self.lattice = np.asarray(self.lattice, dtype=float)
        self.positions = [np.asarray(p, dtype=float) for p in self.positions]
        if self.lattice.shape != (3, 3) or len(self.atoms) != len(self.positions):
            raise ValueError("Model needs a 3x3 lattice and one position per atom")

        self.n_dim = lat.lattice_n_dim(self.lattice)
        self.inv_lattice = lat.block_inverse(self.lattice)
        self.recip_lattice = lat.compute_recip_lattice(self.lattice)
        self.unit_cell_volume = float(lat.compute_unit_cell_volume(self.lattice))

        if self.n_electrons is None:
            self.n_electrons = int(sum(at.charge_ionic() for at in self.atoms)
                                   - self.extra_charge)
        if self.smearing is None:
            self.smearing = NoSmearing() if self.temperature == 0 else FermiDirac()
        if self.spin_polarization not in ("none", "collinear", "spinless"):
            raise ValueError(f"spin_polarization {self.spin_polarization}")
        if len(self.magnetic_moments) > 0 and self.spin_polarization == "none":
            self.spin_polarization = "collinear"

        groups = {}
        for i, at in enumerate(self.atoms):
            groups.setdefault(at, []).append(i)
        self.atom_groups = list(groups.values())

        if self.symmetries is True or (self.symmetries is not False and not all(
                _is_identity(op) for op in self.symmetries)):
            raise NotImplementedError(_SYMMETRY_TODO)
        self.symmetries = [SymOp.identity()]

    @property
    def n_spin_components(self):
        return 2 if self.spin_polarization == "collinear" else 1

    @property
    def filled_occupation(self):
        """Maximal occupation of one band (2 except for collinear/spinless)."""
        if self.spin_polarization in ("collinear", "spinless"):
            return 1
        return 2

    def default_n_bands(self):
        """Default number of bands: enough to hold all electrons + buffer."""
        n_occ = int(math.ceil(self.n_electrons / self.filled_occupation))
        if self.temperature == 0:
            return n_occ
        return max(n_occ + 3, int(math.ceil(1.05 * n_occ)))
