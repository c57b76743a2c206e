"""The Model: physics specification of a periodic Kohn-Sham problem.

Port of `dftk_tpu/models/model.py` (reference `src/Model.jl:6-219`): lattice,
atoms + positions, electron count, spin mode, temperature + smearing, the
list of energy-term specs and the crystal symmetries.  Host-side numpy;
`PlaneWaveBasis` turns it into tensors.

`symmetries=True` (the default) detects the crystal's operations
(`symmetry.py`), `False` keeps the identity, and an explicit list of
operations (anything with integer W and fractional w) is taken as given.
Magnetic moments (one per atom: a number, or a vector whose last entry is
the collinear moment) switch the model to collinear spin and split the
atoms by moment in the symmetry detection.
"""
import dataclasses
import math
from typing import Any, List, Optional, Sequence

import numpy as np

from ..symmetry import SymOp, symmetry_operations
from ..utils import lattice as lat
from .smearing import FermiDirac, NoSmearing, SmearingFunction


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
    symmetries: Any = True               # True/False or explicit list of SymOp
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

        if self.symmetries is True:
            magmoms = self.magnetic_moments if len(self.magnetic_moments) else None
            self.symmetries = (symmetry_operations(self.lattice, self.atoms,
                                                   self.positions,
                                                   magnetic_moments=magmoms)
                               if len(self.atoms) else [SymOp.identity()])
        elif self.symmetries is False:
            self.symmetries = [SymOp.identity()]
        else:
            self.symmetries = [SymOp.make(op.W, op.w) for op in self.symmetries]

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
