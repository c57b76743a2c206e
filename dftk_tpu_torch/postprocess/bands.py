"""High-symmetry q- and k-paths, and band structures.

Port of `dftk_tpu/postprocess/bands.py` (reference
`src/postprocess/band_structure.jl`, whose paths come from Brillouin.jl):
the Setyawan-Curtarolo high-symmetry points and default paths of the
common Bravais lattices (`detect_bravais`, `irrfbz_path`, `KPath`), host
numpy, as `postprocess/phonon.py::phonon_band_structure` lays out its
q-path; and `compute_bands`: a basis on the path's k-points at the SCF's
FFT size, H at the SCF density, diagonalised by LOBPCG on the basis'
device (every apply of H through the local-apply kernels on a card).
"""
import dataclasses
from typing import Dict, List

import numpy as np

from ..utils.lattice import compute_recip_lattice

# high-symmetry points in reduced coordinates (Setyawan-Curtarolo,
# Comp. Mater. Sci. 49, 299 (2010); parameter-dependent classes are
# functions of the lattice).  The reference delegates this to Brillouin.jl
# which follows the same conventions.
_KPOINTS = {
    "cubic": {"G": [0, 0, 0], "X": [0, 1 / 2, 0], "M": [1 / 2, 1 / 2, 0],
              "R": [1 / 2, 1 / 2, 1 / 2]},
    "fcc": {"G": [0, 0, 0], "X": [1 / 2, 0, 1 / 2], "L": [1 / 2, 1 / 2, 1 / 2],
            "W": [1 / 2, 1 / 4, 3 / 4], "U": [5 / 8, 1 / 4, 5 / 8],
            "K": [3 / 8, 3 / 8, 3 / 4]},
    "bcc": {"G": [0, 0, 0], "H": [1 / 2, -1 / 2, 1 / 2], "N": [0, 0, 1 / 2],
            "P": [1 / 4, 1 / 4, 1 / 4]},
    "hexagonal": {"G": [0, 0, 0], "M": [1 / 2, 0, 0], "K": [1 / 3, 1 / 3, 0],
                  "A": [0, 0, 1 / 2], "L": [1 / 2, 0, 1 / 2],
                  "H": [1 / 3, 1 / 3, 1 / 2]},
    "tet": {"G": [0, 0, 0], "A": [1 / 2, 1 / 2, 1 / 2], "M": [1 / 2, 1 / 2, 0],
            "R": [0, 1 / 2, 1 / 2], "X": [0, 1 / 2, 0], "Z": [0, 0, 1 / 2]},
    "orc": {"G": [0, 0, 0], "R": [1 / 2, 1 / 2, 1 / 2], "S": [1 / 2, 1 / 2, 0],
            "T": [0, 1 / 2, 1 / 2], "U": [1 / 2, 0, 1 / 2], "X": [1 / 2, 0, 0],
            "Y": [0, 1 / 2, 0], "Z": [0, 0, 1 / 2]},
    "tri": {"G": [0, 0, 0], "L": [1 / 2, 1 / 2, 0], "M": [0, 1 / 2, 1 / 2],
            "N": [1 / 2, 0, 1 / 2], "R": [1 / 2, 1 / 2, 1 / 2],
            "X": [1 / 2, 0, 0], "Y": [0, 1 / 2, 0], "Z": [0, 0, 1 / 2]},
}
# paths are lists of continuous segments ("|" breaks in the SC tables)
_DEFAULT_PATHS = {
    "cubic": [["G", "X", "M", "G", "R", "X"], ["M", "R"]],
    "fcc": [["G", "X", "W", "K", "G", "L", "U", "W", "L", "K"], ["U", "X"]],
    "bcc": [["G", "H", "N", "G", "P", "H"], ["P", "N"]],
    "hexagonal": [["G", "M", "K", "G", "A", "L", "H", "A"], ["L", "M"],
                  ["K", "H"]],
    "tet": [["G", "X", "M", "G", "Z", "R", "A", "Z"], ["X", "R"], ["M", "A"]],
    "bct1": [["G", "X", "M", "G", "Z", "P", "N", "Z1", "M"], ["X", "P"]],
    "bct2": [["G", "X", "Y", "S", "G", "Z", "S1", "N", "P", "Y1", "Z"],
             ["X", "P"]],
    "orc": [["G", "X", "S", "Y", "G", "Z", "U", "R", "T", "Z"], ["Y", "T"],
            ["U", "X"], ["S", "R"]],
    "rhl1": [["G", "L", "B1"], ["B", "Z", "G", "X"], ["Q", "F", "P1", "Z"],
             ["L", "P"]],
    "rhl2": [["G", "P", "Z", "Q", "G", "F", "P1", "Q1", "L", "Z"]],
    "mcl": [["G", "Y", "H", "C", "E", "M1", "A", "X", "H1"], ["M", "D", "Z"],
            ["Y", "D"]],
    "tri": [["X", "G", "Y"], ["L", "G", "Z"], ["N", "G", "M"], ["R", "G"]],
}


def _bravais_points(brav, lattice):
    """High-symmetry points; parameter-dependent for bct/rhl/mcl."""
    if brav in _KPOINTS:
        return _KPOINTS[brav]
    L = np.asarray(lattice, dtype=float)
    M = L.T @ L
    if brav in ("bct1", "bct2"):
        # primitive bct vectors: dots give  d13 = d23 = -c^2/4,
        # d12 = (c^2 - 2 a^2)/4
        c2 = -4 * M[0, 2]
        a2 = -2 * (M[0, 1] + M[0, 2])
        if brav == "bct1":                      # c < a
            eta = (1 + c2 / a2) / 4
            return {"G": [0, 0, 0], "M": [-1 / 2, 1 / 2, 1 / 2],
                    "N": [0, 1 / 2, 0], "P": [1 / 4, 1 / 4, 1 / 4],
                    "X": [0, 0, 1 / 2], "Z": [eta, eta, -eta],
                    "Z1": [-eta, 1 - eta, eta]}
        eta = (1 + a2 / c2) / 4                 # bct2: c > a
        zeta = a2 / (2 * c2)
        return {"G": [0, 0, 0], "N": [0, 1 / 2, 0],
                "P": [1 / 4, 1 / 4, 1 / 4], "S": [-eta, eta, eta],
                "S1": [eta, 1 - eta, -eta], "X": [0, 0, 1 / 2],
                "Y": [-zeta, zeta, 1 / 2], "Y1": [1 / 2, 1 / 2, -zeta],
                "Z": [1 / 2, 1 / 2, -1 / 2]}
    if brav in ("rhl1", "rhl2"):
        lengths = np.sqrt(np.diag(M))
        cosa = M[0, 1] / (lengths[0] * lengths[1])
        if brav == "rhl1":                      # alpha < 90
            eta = (1 + 4 * cosa) / (2 + 4 * cosa)
            nu = 3 / 4 - eta / 2
            return {"G": [0, 0, 0], "B": [eta, 1 / 2, 1 - eta],
                    "B1": [1 / 2, 1 - eta, eta - 1], "F": [1 / 2, 1 / 2, 0],
                    "L": [1 / 2, 0, 0], "L1": [0, 0, -1 / 2],
                    "P": [eta, nu, nu], "P1": [1 - nu, 1 - nu, 1 - eta],
                    "P2": [nu, nu, eta - 1], "Q": [1 - nu, nu, 0],
                    "X": [nu, 0, -nu], "Z": [1 / 2, 1 / 2, 1 / 2]}
        # rhl2: alpha > 90; tan^2(alpha/2) = (1 - cosa)/(1 + cosa)
        eta = (1 + cosa) / (2 * (1 - cosa))
        nu = 3 / 4 - eta / 2
        return {"G": [0, 0, 0], "F": [1 / 2, -1 / 2, 0], "L": [1 / 2, 0, 0],
                "P": [1 - nu, -nu, 1 - nu], "P1": [nu, nu - 1, nu - 1],
                "Q": [eta, eta, eta], "Q1": [1 - eta, -eta, -eta],
                "Z": [1 / 2, -1 / 2, 1 / 2]}
    if brav == "mcl":
        # SC convention: b axis along y, c axis along z, alpha = angle(b, c)
        lengths = np.sqrt(np.diag(M))
        b, c = lengths[1], lengths[2]
        cosa = M[1, 2] / (b * c)
        sina2 = 1 - cosa ** 2
        eta = (1 - b * cosa / c) / (2 * sina2)
        nu = 1 / 2 - eta * c * cosa / b
        return {"G": [0, 0, 0], "A": [1 / 2, 1 / 2, 0],
                "C": [0, 1 / 2, 1 / 2], "D": [1 / 2, 0, 1 / 2],
                "D1": [1 / 2, 0, -1 / 2], "E": [1 / 2, 1 / 2, 1 / 2],
                "H": [0, eta, 1 - nu], "H1": [0, 1 - eta, nu],
                "H2": [0, eta, -nu], "M": [1 / 2, eta, 1 - nu],
                "M1": [1 / 2, 1 - eta, nu], "M2": [1 / 2, eta, -nu],
                "X": [0, 1 / 2, 0], "Y": [0, 0, 1 / 2],
                "Y1": [0, 0, -1 / 2], "Z": [1 / 2, 0, 0]}
    raise ValueError(f"unknown Bravais class {brav}")


def detect_bravais(lattice, tol=1e-5):
    """Classify the lattice into a Setyawan-Curtarolo path class.

    Falls back to "tri" (triclinic, generic path through the zone-face
    centers) when nothing more symmetric matches.  Centered orthorhombic /
    centered monoclinic variants are not distinguished and fall back too.
    """
    L = np.asarray(lattice, dtype=float)
    lengths = np.linalg.norm(L, axis=0)
    a = lengths[0]
    M = L.T @ L
    cos = np.array([M[1, 2], M[0, 2], M[0, 1]]) / np.array(
        [lengths[1] * lengths[2], lengths[0] * lengths[2],
         lengths[0] * lengths[1]])
    if np.allclose(lengths, a, atol=tol * a):
        if np.allclose(cos, 0, atol=tol):
            return "cubic"
        if np.allclose(cos, 0.5, atol=tol):
            return "fcc"
        if np.allclose(cos, -1 / 3, atol=tol):
            return "bcc"
        if np.allclose(cos, cos[0], atol=tol):
            # equal lengths, equal angles: bct primitive or rhombohedral
            return "rhl1" if cos[0] > 0 else "rhl2"
    if (abs(lengths[0] - lengths[1]) < tol * a and abs(cos[2] + 0.5) < tol
            and np.allclose(cos[:2], 0, atol=tol)):
        return "hexagonal"
    if np.allclose(cos, 0, atol=tol):
        if abs(lengths[0] - lengths[1]) < tol * a:
            return "tet"
        return "orc"
    # body-centered tetragonal: equal lengths, d13 == d23 != d12
    if (np.allclose(lengths, a, atol=tol * a)
            and abs(M[0, 2] - M[1, 2]) < tol * a * a):
        c2 = -4 * M[0, 2]
        a2 = -2 * (M[0, 1] + M[0, 2])
        if c2 > 0 and a2 > 0:
            return "bct1" if c2 < a2 else "bct2"
    # monoclinic (SC: beta = gamma = 90, alpha != 90)
    if abs(cos[1]) < tol and abs(cos[2]) < tol and abs(cos[0]) > tol:
        return "mcl"
    return "tri"


@dataclasses.dataclass
class KPath:
    kcoords: np.ndarray          # [n, 3]
    labels: Dict[int, str]       # index -> label
    kdistances: np.ndarray       # cumulative Cartesian path length


def irrfbz_path(lattice, kline_density=20, paths=None):
    """Standard high-symmetry path for the detected Bravais class.

    `paths` may be a flat list of point names (one continuous branch) or a
    list of such lists (discontinuous branches, the "|" breaks of the SC
    tables).  Distances do not accumulate across branch breaks.
    """
    brav = detect_bravais(lattice)
    pts = _bravais_points(brav, lattice)
    segments = paths if paths is not None else _DEFAULT_PATHS[brav]
    if segments and isinstance(segments[0], str):
        segments = [list(segments)]
    B = compute_recip_lattice(np.asarray(lattice, dtype=float))

    kcoords: List[np.ndarray] = []
    labels: Dict[int, str] = {}
    dists: List[float] = []
    for names in segments:
        for i in range(len(names) - 1):
            k0 = np.array(pts[names[i]], dtype=float)
            k1 = np.array(pts[names[i + 1]], dtype=float)
            seg_cart = np.linalg.norm(B @ (k1 - k0))
            n = max(2, int(np.ceil(seg_cart * kline_density)))
            last_leg = i == len(names) - 2
            ts = np.linspace(0, 1, n + 1) if last_leg \
                else np.linspace(0, 1, n, endpoint=False)
            labels[len(kcoords)] = names[i]
            for j, t in enumerate(ts):
                k = k0 + t * (k1 - k0)
                if not kcoords:
                    dists.append(0.0)
                elif i == 0 and j == 0:
                    dists.append(dists[-1])          # branch break: no jump
                else:
                    dists.append(dists[-1]
                                 + np.linalg.norm(B @ (k - kcoords[-1])))
                kcoords.append(k)
        labels[len(kcoords) - 1] = names[-1]
    return KPath(kcoords=np.array(kcoords), labels=labels,
                 kdistances=np.array(dists))


def compute_bands(scfres, kcoords=None, n_bands=None, kline_density=20, tol=1e-8, maxiter=200,
                  paths=None):
    """Eigenvalues along a k-path at the fixed SCF density.

    `paths` selects a custom named path (forwarded to irrfbz_path), e.g.
    ["G", "M", "K", "G"] for the in-plane path of a 2D material (the
    reference's custom-kpath flow, examples/graphene.jl).  LOBPCG runs on
    n_bands + 3 bands from `scf/driver.py::random_orbitals` and gates on
    the lowest n_bands.  Returns a dict with eigenvalues [nk_path, n_bands]
    (numpy), the basis, kcoords, kpath, epsF, psi (a tensor), converged,
    and LOBPCG's iterations and largest residual norm of the gated bands
    (n_iter, residual); the basis build and the LOBPCG are timed on the port's
    timer (`utils/timer.py`) as "compute_bands basis" and
    "compute_bands lobpcg".
    """
    import torch
    from ..basis import PlaneWaveBasis
    from ..bzmesh import ExplicitKpoints
    from ..ops import hamiltonian as hamops
    from ..ops.eigen.lobpcg import lobpcg
    from ..scf.driver import random_orbitals
    from ..utils.timer import timer

    basis = scfres.basis
    model = basis.model
    kpath = None
    if kcoords is None:
        kpath = irrfbz_path(model.lattice, kline_density, paths=paths)
        kcoords = kpath.kcoords
    if n_bands is None:
        n_bands = scfres.eigenvalues.shape[1]

    with timer.section("compute_bands basis"):
        bs_basis = PlaneWaveBasis(model, Ecut=basis.Ecut,
                                  kgrid=ExplicitKpoints(list(kcoords)),
                                  fft_size=basis.fft_size, device=basis.device,
                                  dtype=basis.dtype,
                                  use_symmetries_for_kpoint_reduction=False)
    with timer.section("compute_bands lobpcg"), torch.no_grad():
        bd = bs_basis.data
        rho = torch.as_tensor(scfres.rho, device=bs_basis.device)
        tau = getattr(scfres, "tau", None) if bs_basis.terms.needs_tau else None
        V, Vtau, _ = hamops.total_potential(bs_basis.terms, rho, model.unit_cell_volume,
                                            tau=tau)
        ham = hamops.build_ham(bd, bs_basis.terms.data, V, bs_basis.pruned, Vtau=Vtau)
        X0 = random_orbitals(bs_basis, n_bands + 3)
        res = lobpcg(lambda p: hamops.apply_H(ham, p), X0, ham.kin, bd.mask, tol=tol,
                     maxiter=maxiter, n_conv=n_bands)
        eigenvalues = res.eigenvalues[:, :n_bands].cpu().numpy()
    return dict(basis=bs_basis, eigenvalues=eigenvalues,
                kcoords=np.asarray(kcoords), kpath=kpath,
                epsF=getattr(scfres, "epsF", None), psi=res.X,
                converged=bool(res.converged), n_iter=res.n_iter,
                residual=float(res.residual_norms[:, :n_bands].max()))
