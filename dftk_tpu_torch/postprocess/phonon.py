"""Phonon modes.

Port of `dftk_tpu/postprocess/phonon.py` (reference: DFTK
`src/postprocess/phonon.jl`):
  * `compute_dynmat_finite_diff` and `phonon_modes_finite_diff`: the
    dynamical matrix at Gamma from central finite differences of the
    forces of displaced, re-converged SCF solutions (the supercell method
    the reference's phonon tests compare DFPT against);
  * `phonon_modes_from_dynmat`: mass-weighting and diagonalisation, used by
    both that route and the DFPT one (`response/phonon_dfpt.py`);
  * the interatomic force constants of a supercell and the dynamical
    matrices at any q (`ForceConstants`, `compute_force_constants`,
    `dynmat_q`, `phonon_modes_q`, `phonon_band_structure`): the
    frozen-phonon counterpart of the DFPT phonons at q
    (`response/phonon_q.py`), exact at q commensurate with the supercell
    and Fourier-interpolated in between.

Frequencies are in Hartree atomic units (multiply by HARTREE_TO_CM1 for
cm^-1).
"""
import dataclasses

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


# ---------------------------------------------------------------------------
# Interatomic force constants + dynamical matrices at arbitrary q
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ForceConstants:
    """Real-space force constants Phi[s, a, cell, t, b] = dF/du and geometry.

    s/t: unit-cell atom indices; a/b: Cartesian; cell: supercell lattice
    offset index (offsets[cell] in units of the unit-cell vectors)."""
    Phi: np.ndarray            # [na, 3, n_cells, na, 3]
    offsets: np.ndarray        # [n_cells, 3] int
    supercell: tuple
    atoms: list
    lattice: np.ndarray        # unit-cell lattice (columns = vectors)


def _functional_names(model):
    """The names of the model's XC functionals (the port's copy of
    `dftk_tpu/io/scfres.py::_functional_names`)."""
    from ..ops.terms import Xc
    for t in model.term_types:
        if isinstance(t, Xc):
            return list(t.functionals)
    return []


def compute_force_constants(model, Ecut, supercell_size, kgrid=(1, 1, 1), scf_kwargs=None,
                            delta=1e-3, acoustic_sum_rule=True, basis_kwargs=None):
    """Supercell finite-difference interatomic force constants.

    Displaces every unit-cell atom (the R = 0 copies) along every Cartesian
    direction in an n1 x n2 x n3 supercell (a `model_DFT` of the model's
    functionals, temperature, smearing and spin) and records the force
    response of all supercell atoms (`self_consistent_field`, then
    `compute_forces_cart`).  The resulting Phi(R) gives the exact dynamical
    matrix at every q commensurate with the supercell.  basis_kwargs go to
    each PlaneWaveBasis (its device among them)."""
    from ..basis import PlaneWaveBasis
    from ..models.standard import model_DFT
    from ..scf.driver import self_consistent_field
    from ..supercell import create_supercell
    from .forces import compute_forces_cart

    scf_kwargs = dict(scf_kwargs or {})
    scf_kwargs.setdefault("tol", 1e-10)
    basis_kwargs = dict(basis_kwargs or {})
    sc = create_supercell(model.lattice, model.atoms, model.positions, supercell_size)
    n1, n2, n3 = sc["size"]
    n_cells = n1 * n2 * n3
    na = len(model.atoms)
    offsets = np.array([[i, j, k] for i in range(n1) for j in range(n2) for k in range(n3)],
                       dtype=int)
    inv_lat_sc = np.linalg.inv(sc["lattice"])

    def make_basis(positions):
        m = model_DFT(sc["lattice"], sc["atoms"], positions,
                      functionals=_functional_names(model), temperature=model.temperature,
                      smearing=model.smearing, spin_polarization=model.spin_polarization)
        return PlaneWaveBasis(m, Ecut=Ecut, kgrid=kgrid, **basis_kwargs)

    Phi = np.zeros((na, 3, n_cells, na, 3))
    for s in range(na):
        for alpha in range(3):
            forces = []
            for sign in (+1, -1):
                pos = [np.array(p, dtype=float) for p in sc["positions"]]
                # cell 0 holds atoms 0..na-1
                pos[s] = pos[s] + inv_lat_sc @ (sign * delta * np.eye(3)[alpha])
                res = self_consistent_field(make_basis(pos), **scf_kwargs)
                forces.append(compute_forces_cart(res).cpu().numpy())
            dF = (forces[0] - forces[1]) / (2 * delta)      # [n_cells*na, 3]
            Phi[s, alpha] = -dF.reshape(n_cells, na, 3)

    if acoustic_sum_rule:
        # sum_{R, t} Phi[s, a, R, t, b] = 0: correct the self term
        corr = Phi.sum(axis=(2, 3))                          # [na, 3, 3]
        for s in range(na):
            Phi[s, :, 0, s, :] -= corr[s]
    return ForceConstants(Phi=Phi, offsets=offsets, supercell=tuple(sc["size"]),
                          atoms=list(model.atoms), lattice=np.asarray(model.lattice, dtype=float))


def dynmat_q(fc, q, minimum_image=True):
    """Mass-weighted dynamical matrix D(q) [3 na, 3 na] (q reduced coords).

    Exact for q commensurate with the supercell; for interpolation at other
    q the lattice offsets are folded to their minimum-image representative."""
    na = fc.Phi.shape[0]
    size = np.array(fc.supercell)
    offsets = fc.offsets.astype(float)
    if minimum_image:
        offsets = offsets - size * np.round(offsets / size)
    phase = np.exp(2j * np.pi * (offsets @ np.asarray(q, dtype=float)))
    D = np.einsum("c,sactb->satb", phase, fc.Phi).reshape(3 * na, 3 * na)
    masses = np.array([ATOMIC_MASSES_U[at.symbol] * AMU_TO_ME for at in fc.atoms])
    msqrt = np.repeat(np.sqrt(masses), 3)
    D = D / np.outer(msqrt, msqrt)
    return (D + D.conj().T) / 2


def phonon_modes_q(fc, q, minimum_image=True):
    """Frequencies (Ha, negatives = imaginary) + eigenvectors at one q."""
    w2, vecs = np.linalg.eigh(dynmat_q(fc, q, minimum_image=minimum_image))
    return np.sign(w2) * np.sqrt(np.abs(w2)), vecs


def phonon_band_structure(fc, kline_density=20, qpath=None):
    """Phonon frequencies along a high-symmetry q-path of the unit cell
    (`postprocess/bands.py::irrfbz_path` unless qpath is given)."""
    from .bands import irrfbz_path
    if qpath is None:
        qpath = irrfbz_path(fc.lattice, kline_density=kline_density)
    freqs = np.stack([phonon_modes_q(fc, q)[0] for q in qpath.kcoords])
    return dict(qpath=qpath, frequencies=freqs)
