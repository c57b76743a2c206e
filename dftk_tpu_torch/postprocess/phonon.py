"""Phonon modes at Gamma.

Port of the Gamma part of `dftk_tpu/postprocess/phonon.py` (reference:
DFTK `src/postprocess/phonon.jl`):
  * `compute_dynmat_finite_diff` and `phonon_modes_finite_diff`: the
    dynamical matrix from central finite differences of the forces of
    displaced, re-converged SCF solutions (the supercell method the
    reference's phonon tests compare DFPT against);
  * `phonon_modes_from_dynmat`: mass-weighting and diagonalisation, used by
    both that route and the DFPT one (`response/phonon_dfpt.py`).

Frequencies are in Hartree atomic units (multiply by HARTREE_TO_CM1 for
cm^-1).  The force constants of a supercell and the dynamical matrices at
q != 0 (`ForceConstants`, `compute_force_constants`, `dynmat_q`,
`phonon_modes_q`, `phonon_band_structure`) are not ported yet (ROADMAP
Queue 1, item 10c) and raise NotImplementedError.
"""
import numpy as np

HARTREE_TO_CM1 = 219474.6313632

# Atomic masses (u) for the common elements; 1 u = 1822.888486 m_e
ATOMIC_MASSES_U = {
    "H": 1.008, "He": 4.0026, "Li": 6.94, "Be": 9.0122, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998, "Ne": 20.180,
    "Na": 22.990, "Mg": 24.305, "Al": 26.982, "Si": 28.085, "P": 30.974,
    "S": 32.06, "Cl": 35.45, "Ar": 39.948, "K": 39.098, "Ca": 40.078,
    "Ti": 47.867, "V": 50.942, "Cr": 51.996, "Mn": 54.938, "Fe": 55.845,
    "Co": 58.933, "Ni": 58.693, "Cu": 63.546, "Zn": 65.38, "Ga": 69.723,
    "Ge": 72.630, "As": 74.922, "Se": 78.971, "Sr": 87.62, "Sn": 118.71,
    "Sb": 121.76, "Ba": 137.33, "Pt": 195.08,
}
AMU_TO_ME = 1822.888486209


def compute_dynmat_finite_diff(make_basis, positions0, scf_kwargs=None, delta=1e-3):
    """Cartesian force-constant matrix d^2 E / dR_cart^2 by central FD.

    make_basis(positions) -> PlaneWaveBasis with those fractional positions.
    Returns dynmat [n_atoms*3, n_atoms*3] (Cartesian, not mass-weighted),
    numpy float64."""
    from ..scf.driver import self_consistent_field
    from .forces import compute_forces_cart
    scf_kwargs = dict(scf_kwargs or {})
    scf_kwargs.setdefault("tol", 1e-10)

    basis0 = make_basis(positions0)
    inv_lat = np.linalg.inv(basis0.model.lattice)
    na = len(positions0)
    C = np.zeros((3 * na, 3 * na))
    for s in range(na):
        for alpha in range(3):
            forces = []
            for sign in (+1, -1):
                pos = [np.array(p, dtype=float) for p in positions0]
                # displace atom s along Cartesian alpha
                pos[s] = pos[s] + inv_lat @ (sign * delta * np.eye(3)[alpha])
                res = self_consistent_field(make_basis(pos), **scf_kwargs)
                forces.append(compute_forces_cart(res).cpu().numpy())
            dF = (forces[0] - forces[1]) / (2 * delta)   # [na, 3]
            C[:, 3 * s + alpha] = (-dF).reshape(-1)
    # symmetrize + acoustic sum rule
    C = (C + C.T) / 2
    for a in range(3):
        for b in range(3):
            blocks = C.reshape(na, 3, na, 3)
            diag_corr = blocks[:, a, :, b].sum(axis=1)
            for s in range(na):
                blocks[s, a, s, b] -= diag_corr[s]
    return C


def phonon_modes_from_dynmat(C, atoms):
    """Mass-weight a Cartesian force-constant matrix and diagonalize.

    Returns (frequencies [3 na] in Ha, mass-weighted eigenvectors).
    Imaginary frequencies are returned as negative numbers."""
    masses = np.array([ATOMIC_MASSES_U[at.symbol] * AMU_TO_ME for at in atoms])
    msqrt = np.repeat(np.sqrt(masses), 3)
    D = np.asarray(C) / np.outer(msqrt, msqrt)
    w2, vecs = np.linalg.eigh((D + D.T) / 2)
    return np.sign(w2) * np.sqrt(np.abs(w2)), vecs


def phonon_modes_finite_diff(make_basis, positions0, atoms, scf_kwargs=None, delta=1e-3):
    C = compute_dynmat_finite_diff(make_basis, positions0, scf_kwargs=scf_kwargs, delta=delta)
    return phonon_modes_from_dynmat(C, atoms)


def _item_10c(name):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: supercell force constants and phonons at q != 0 are not ported "
            f"yet (ROADMAP Queue 1, item 10c)")
    stub.__name__ = stub.__qualname__ = name
    stub.__doc__ = "Not ported yet (ROADMAP Queue 1, item 10c): raises NotImplementedError."
    return stub


ForceConstants = _item_10c("ForceConstants")
compute_force_constants = _item_10c("compute_force_constants")
dynmat_q = _item_10c("dynmat_q")
phonon_modes_q = _item_10c("phonon_modes_q")
phonon_band_structure = _item_10c("phonon_band_structure")
