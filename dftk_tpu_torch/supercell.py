"""Supercell construction (port of `dftk_tpu/supercell.py::create_supercell`,
reference src/supercell.jl).

Not ported yet: `cell_to_supercell`, the folding of a k-grid SCF result
into the equivalent Gamma-point supercell (ROADMAP Queue 1, item 12).
"""
import numpy as np


def create_supercell(lattice, atoms, positions, supercell_size):
    """Replicate (lattice, atoms, positions) by integers [n1, n2, n3]."""
    n1, n2, n3 = (int(x) for x in supercell_size)
    lattice = np.asarray(lattice, dtype=float)
    new_lattice = lattice @ np.diag([n1, n2, n3])
    new_atoms, new_positions = [], []
    for i in range(n1):
        for j in range(n2):
            for k in range(n3):
                shift = np.array([i, j, k], dtype=float)
                for at, pos in zip(atoms, positions):
                    new_atoms.append(at)
                    new_positions.append((np.asarray(pos) + shift)
                                         / np.array([n1, n2, n3]))
    return dict(lattice=new_lattice, atoms=new_atoms, positions=new_positions,
                size=(n1, n2, n3))


def cell_to_supercell(scfres):
    raise NotImplementedError("cell_to_supercell is not ported yet (ROADMAP "
                              "Queue 1, item 12)")
