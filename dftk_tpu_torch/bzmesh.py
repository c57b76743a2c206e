"""Brillouin-zone sampling: Monkhorst-Pack and explicit k-grids.

Port of `dftk_tpu/bzmesh.py` (reference `src/bzmesh.jl:24-236`): the MP
coordinate convention (k = (shift + [i,j,k]) / n, components normalised to
[-0.5, 0.5)), and symmetry reduction to the irreducible wedge (no time
reversal in the reduction, matching the reference's spglib call with
is_time_reversal=false).
"""
import dataclasses
import math

import numpy as np

from .symmetry import irreducible_kcoords as _irr_kcoords


def normalize_kpoint_coordinate(k):
    """Components to [-0.5, 0.5), with 0.5 mapped to -0.5."""
    k = np.asarray(k, dtype=float)
    return k - np.floor(k + 0.5)


@dataclasses.dataclass(frozen=True)
class MonkhorstPack:
    kgrid_size: tuple
    kshift: tuple = (0.0, 0.0, 0.0)

    def __len__(self):
        return int(np.prod(self.kgrid_size))

    def reducible_kcoords(self):
        n = np.asarray(self.kgrid_size, dtype=int)
        start = -np.floor((n - 1) / 2).astype(int)
        stop = np.ceil((n - 1) / 2).astype(int)
        ks = []
        # index order (i fastest) matches the reference comprehension order
        for k in range(start[2], stop[2] + 1):
            for j in range(start[1], stop[1] + 1):
                for i in range(start[0], stop[0] + 1):
                    ks.append((np.array(self.kshift) + np.array([i, j, k])) / n)
        return normalize_kpoint_coordinate(np.array(ks))

    def irreducible_kcoords(self, symmetries):
        if all(s == 1 for s in self.kgrid_size):
            return np.array([self.kshift], dtype=float), np.array([1.0])
        full = self.reducible_kcoords()
        kcoords, weights = _irr_kcoords(full, symmetries, use_time_reversal=False)
        return normalize_kpoint_coordinate(kcoords), weights


@dataclasses.dataclass(frozen=True)
class ExplicitKpoints:
    kcoords: tuple      # [(3,)...] fractional
    kweights: tuple

    def __init__(self, kcoords, kweights=None):
        kcoords = [tuple(map(float, k)) for k in kcoords]
        if kweights is None:
            kweights = [1.0 / len(kcoords)] * len(kcoords)
        object.__setattr__(self, "kcoords", tuple(kcoords))
        object.__setattr__(self, "kweights", tuple(float(w) for w in kweights))

    def __len__(self):
        return len(self.kcoords)

    def reducible_kcoords(self):
        return np.array(self.kcoords, dtype=float)

    def irreducible_kcoords(self, symmetries):
        return np.array(self.kcoords, dtype=float), np.array(self.kweights)


def as_kgrid(kgrid):
    """Accept MonkhorstPack / ExplicitKpoints / size tuple."""
    if isinstance(kgrid, (MonkhorstPack, ExplicitKpoints)):
        return kgrid
    if isinstance(kgrid, (tuple, list, np.ndarray)):
        return MonkhorstPack(tuple(int(x) for x in kgrid))
    raise TypeError(f"Cannot interpret kgrid: {kgrid!r}")


def kgrid_from_total_number(lattice, n_kpoints):
    """MP grid with ~n_kpoints in all, each size proportional to |b_i|
    (DFTK KgridTotalNumber)."""
    from .utils.lattice import compute_recip_lattice
    B = compute_recip_lattice(np.asarray(lattice, dtype=float))
    lens = np.linalg.norm(B, axis=0)
    scale = (n_kpoints / np.prod(lens)) ** (1 / 3)
    sizes = np.maximum(1, np.round(scale * lens).astype(int))
    return MonkhorstPack(tuple(int(s) for s in sizes))


def kgrid_from_maximal_spacing(lattice, spacing):
    """MP grid with k-spacing at most `spacing` (bohr^-1), DFTK KgridSpacing."""
    from .utils.lattice import compute_recip_lattice
    B = compute_recip_lattice(np.asarray(lattice, dtype=float))
    sizes = [max(1, int(math.ceil(np.linalg.norm(B[:, i]) / spacing)))
             for i in range(3)]
    return MonkhorstPack(tuple(sizes))
