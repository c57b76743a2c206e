"""Band-count strategies (reference `src/scf/nbands_algorithm.jl`).

Port of `dftk_tpu/scf/nbands.py`.  FixedBands: explicit counts.
AdaptiveBands: the default count, and growth between SCF iterations while
the topmost computed bands are still occupied above a threshold
(`self_consistent_field(nbandsalg=...)`).
"""
import dataclasses
import math
from typing import Optional

import numpy as np


@dataclasses.dataclass
class FixedBands:
    n_bands_converge: int
    n_bands_compute: Optional[int] = None

    def bands(self, model):
        nc = self.n_bands_converge
        return nc, (self.n_bands_compute or nc + max(3, nc // 10))

    def update(self, occupation, eigenvalues, occupation_threshold=None):
        return None   # never grows


@dataclasses.dataclass
class AdaptiveBands:
    """The default band count, grown while the top bands are occupied."""
    occupation_threshold: float = 1e-8
    gap_factor: float = 1.05
    n_bands_converge: Optional[int] = None

    def bands(self, model):
        """(bands to converge, bands to compute)."""
        n_occ = int(math.ceil(model.n_electrons / model.filled_occupation))
        if model.temperature == 0:
            nc = self.n_bands_converge or n_occ
        else:
            nc = self.n_bands_converge or max(n_occ + 3, int(math.ceil(1.05 * n_occ)))
        return nc, nc + max(3, nc // 10)

    def update(self, occupation, eigenvalues, occupation_threshold=None):
        """A larger (n_converge, n_compute) where a band within the top two
        computed ones is occupied above the threshold on some k-point, else
        None.  occupation [nk, nb] (numpy or a tensor on any device)."""
        thr = occupation_threshold or self.occupation_threshold
        occ = np.asarray(occupation.cpu() if hasattr(occupation, "cpu") else occupation)
        nb = occ.shape[1]
        occupied = np.nonzero(np.any(occ > thr, axis=0))[0]
        top = int(occupied[-1]) if len(occupied) else -1
        if top >= nb - 2:     # occupied bands reach into the safety margin
            nc = nb + max(2, nb // 5)
            return nc, nc + max(3, nc // 10)
        return None
