"""Supercell construction and k-grid folding (port of
`dftk_tpu/supercell.py`, reference src/supercell.jl).

create_supercell replicates a cell along the lattice directions;
cell_to_supercell folds a Monkhorst-Pack-sampled calculation into the
equivalent Gamma-point supercell (each k of the grid becomes a Gamma
G-vector of the supercell).
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
    """Fold a k-grid SCF result into the equivalent Gamma-only supercell.

    Returns (supercell dict, folded Bloch data): each Bloch wave
    psi_{nk}(G) maps to the supercell plane wave at G_sc = n .* (k + G)
    (exact when the k-grid is an unshifted MP grid); the coefficients and
    eigenvalues are numpy arrays.
    """
    basis = scfres.basis
    model = basis.model
    kcoords = basis.kcoords_spin
    # infer the MP size from the k-coordinates
    size = [len(np.unique(np.round(kcoords[:, d], 8))) for d in range(3)]
    sc = create_supercell(model.lattice, model.atoms, model.positions, size)
    psi = scfres.psi
    psi = psi.cpu().numpy() if hasattr(psi, "cpu") else np.asarray(psi)
    eigenvalues = np.asarray(scfres.eigenvalues)
    folded = []
    for ik, k in enumerate(kcoords):
        nG = int(basis.mask_np[ik].sum())
        G_sc = (basis.Gred_np[ik, :nG] + k) * np.array(size)
        G_sc_int = np.round(G_sc).astype(int)
        assert np.max(np.abs(G_sc - G_sc_int)) < 1e-6, \
            "k-grid must be a full unshifted Monkhorst-Pack grid"
        folded.append(dict(G=G_sc_int, coeffs=psi[ik, :, :nG],
                           eigenvalues=eigenvalues[ik]))
    return sc, folded
