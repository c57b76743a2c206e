"""The JAX package's CPU float64 values that tests/data/torch_port_post.json
records for the port's postprocess, IO and utility checks
(tests/test_torch_post_*.py).

    DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python tests/data/make_torch_port_post.py ENTRY

prints one JSON line: the entry's values, its `command` and its CPU
seconds (wall seconds of the run on the host).  Run from the repository
root.  Arrays are stored as base64 of their little-endian bytes
(`from_b64` reads them back), large ones as a fingerprint
(`table_summary`).  The cells' constructors take either package as
`dftk` (the tests pass the port with device="cpu"); the seeded orbitals
and densities are numpy only, so both packages start from the same ones.
Entry `io` also writes tests/data/torch_port_post_scfres.npz, an SCF
result saved by the JAX package's `save_scfres`, which the port loads.
This script imports the JAX package, so it lives outside both packages.
"""
import base64
import hashlib
import json
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

DATA = pathlib.Path(__file__).resolve().parent
A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
SI_POSITIONS = [np.ones(3) / 8, -np.ones(3) / 8]
SI_KPOINTS = ([[0, 0, 0], [1 / 3, 0, 0], [1 / 3, 1 / 3, 0], [-1 / 3, 1 / 3, 0]],
              [1 / 27, 8 / 27, 6 / 27, 12 / 27])          # tests/testcases.py's silicon
SI_UPF = str(DATA / "pseudos" / "gth" / "Si.pbe-hgh.upf")
SCFRES_NPZ = DATA / "torch_port_post_scfres.npz"
REFINE_DISPLACED = [np.array([0.125, 0.125, 0.125]) + [0.02, 0.015, -0.01],
                    -np.ones(3) / 8]                       # tests/test_refine_chefsi.py
GEOMETRY_START = [np.ones(3) / 8 + np.array([0.02, -0.015, 0.01]), -np.ones(3) / 8]
# L-BFGS iterations of the relaxation: the optimizer stops on its own
# ftol/gtol (1e-12), not on tol_force, so past the converged geometry it
# follows the grid's 1e-9 Ha ripple along the cell's free translation,
# where the SCF count (37 in the JAX package, 40 in the port) is set by
# last-digit noise; 5 iterations end before that (8 SCFs in both)
GEOMETRY_MAXITER = 5
BANDS = dict(n_bands=6, kline_density=6)                  # tests/test_bands_dos.py
DOS_EPS = dict(lo=-0.5, n=800, temperature=2e-3)
LDOS_EPS = [0.1, 0.2, 0.3]
REFINE_ECUT = (6.0, 10.0)
R1 = dict(Ecut=12.0, kgrid=(4, 4, 4), tol=1e-10, n_bands=8)   # examples/band_structure_dos.py
R1_KPOINTS = {"G": [0.0, 0.0, 0.0], "X": [0.5, 0.0, 0.5], "L": [0.5, 0.5, 0.5]}
POSCAR = """Si2 (primitive fcc)
1.0
0.0 2.7155 2.7155
2.7155 0.0 2.7155
2.7155 2.7155 0.0
Si
2
Direct
0.125 0.125 0.125
-0.125 -0.125 -0.125
"""
XYZ = """3
water
O 0.0 0.0 0.1173
H 0.0 0.7572 -0.4692
H 0.0 -0.7572 -0.4692
"""
XYZ_EXT = """2
Lattice="5.43 0 0 0 5.43 0 0 0 5.43" Properties=species:S:1:pos:R:3
Si 0.0 0.0 0.0
Si 1.3575 1.3575 1.3575
"""


def b64(a):
    a = np.ascontiguousarray(a)
    return dict(dtype=a.dtype.str, shape=list(a.shape),
                data=base64.b64encode(a.tobytes()).decode("ascii"))


def from_b64(d):
    return np.frombuffer(base64.b64decode(d["data"]), dtype=np.dtype(d["dtype"])).reshape(
        d["shape"])


def table_summary(a, n_sample=48):
    """A compact fingerprint of a real table a (any shape): its first
    element, its sum, its sum against seeded uniform weights, and its
    values at n_sample seeded flat indices."""
    a = np.asarray(a, dtype=float).ravel()
    rng = np.random.default_rng(a.size)
    w = rng.uniform(size=a.size)
    idx = rng.choice(a.size, size=min(n_sample, a.size), replace=False)
    return dict(size=int(a.size), first=float(a[0]), sum=float(a.sum()),
                wsum=float(w @ a), sample=a[idx].tolist())


def seeded_orbitals(mask, n_bands, seed):
    """Orthonormal complex orbitals [nk, n_bands, nG] (numpy), zero on the
    padding of mask [nk, nG], each k block orthonormalised by QR."""
    rng = np.random.default_rng(seed)
    shape = (mask.shape[0], n_bands, mask.shape[1])
    psi = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * mask[:, None, :]
    out = np.empty_like(psi)
    for k in range(psi.shape[0]):
        out[k] = np.linalg.qr(psi[k].T)[0].T
    return out


def seeded_density(fft_size, seed, n_spin=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.1, 1.0, size=(n_spin,) + tuple(fft_size))


def si2_model(dftk, positions=None, functionals=("lda_x", "lda_c_vwn"), psp="lda/si-q4", **kw):
    Si = dftk.ElementPsp.from_symbol("Si", psp=psp)
    return dftk.model_DFT(SI_LATTICE, [Si, Si], positions or SI_POSITIONS,
                          functionals=functionals, **kw)


def bands_basis(dftk, **kw):
    """tests/test_bands_dos.py's silicon: Ecut 7, the four k-points, 17^3."""
    return dftk.PlaneWaveBasis(si2_model(dftk), Ecut=7.0, kgrid=dftk.ExplicitKpoints(*SI_KPOINTS),
                               fft_size=(17, 17, 17), **kw)


def pdos_basis(dftk, **kw):
    """tests/test_bands_dos.py::test_pdos_silicon's PBE silicon from the UPF."""
    return dftk.PlaneWaveBasis(si2_model(dftk, functionals="PBE", psp=SI_UPF), Ecut=7.0,
                               kgrid=dftk.ExplicitKpoints(*SI_KPOINTS), fft_size=(17, 17, 17),
                               **kw)


def refine_basis(dftk, **kw):
    """tests/test_refine_chefsi.py's displaced Si2 without symmetry, at
    Gamma, coarse Ecut 6."""
    model = si2_model(dftk, positions=REFINE_DISPLACED, symmetries=False)
    return dftk.PlaneWaveBasis(model, Ecut=REFINE_ECUT[0], kgrid=(1, 1, 1), **kw)


def transfer_bases(dftk, **kw):
    """tests/test_transfer_consistency.py's shifted 2^3 grid at Ecut 5 and
    10, and its two density grids 16^3 and 24^3."""
    m = si2_model(dftk, functionals="LDA")
    kgrid = dftk.MonkhorstPack((2, 2, 2), kshift=(0.5, 0.5, 0.5))
    return (dftk.PlaneWaveBasis(m, Ecut=5.0, kgrid=kgrid, **kw),
            dftk.PlaneWaveBasis(m, Ecut=10.0, kgrid=kgrid, **kw),
            dftk.PlaneWaveBasis(m, Ecut=5.0, kgrid=(1, 1, 1), fft_size=(16,) * 3, **kw),
            dftk.PlaneWaveBasis(m, Ecut=5.0, kgrid=(1, 1, 1), fft_size=(24,) * 3, **kw))


def io_basis(dftk, **kw):
    """tests/test_io.py's silicon: Ecut 5, the four k-points, 15^3."""
    return dftk.PlaneWaveBasis(si2_model(dftk), Ecut=5.0, kgrid=dftk.ExplicitKpoints(*SI_KPOINTS),
                               fft_size=(15, 15, 15), **kw)


def wannier_basis(dftk, **kw):
    """tests/test_external.py's silicon: Ecut 6, the full MP 2^3, 16^3."""
    return dftk.PlaneWaveBasis(si2_model(dftk), Ecut=6.0, kgrid=dftk.MonkhorstPack((2, 2, 2)),
                               fft_size=(16,) * 3, use_symmetries_for_kpoint_reduction=False,
                               **kw)


class FakeResult:
    """The attributes of an SCF result that the writers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def wannier_numbers(prefix):
    """The numbers of PREFIX.eig, .mmn and .amn: eig [lines, 3], the mmn
    headers [pairs, 5] and values [pairs * nb^2, 2], amn [lines, 5]."""
    eig = np.loadtxt(prefix + ".eig")
    lines = open(prefix + ".mmn").read().splitlines()
    nb, nk, nnb = map(int, lines[1].split())
    heads, vals, i = [], [], 2
    while i < len(lines):
        heads.append([int(x) for x in lines[i].split()])
        vals += [[float(x) for x in ln.split()] for ln in lines[i + 1:i + 1 + nb * nb]]
        i += 1 + nb * nb
    amn = np.loadtxt(prefix + ".amn", skiprows=2)
    return dict(eig=np.asarray(eig), mmn_heads=np.asarray(heads), mmn=np.asarray(vals),
                amn=np.asarray(amn))


def write_wannier(dftk_wannier, basis, psi, eigenvalues, directory):
    res = FakeResult(basis=basis, psi=psi, eigenvalues=eigenvalues)
    prefix = os.path.join(directory, "si")
    dftk_wannier.write_wannier90_files(prefix, res, n_wann=4, bands=4)
    return wannier_numbers(prefix)


def vts_fields(basis, seed=11):
    """A seeded two-spin density and one extra field on the basis' grid."""
    rho = seeded_density(basis.fft_size, seed, n_spin=2)
    return rho, seeded_density(basis.fft_size, seed + 1)[0]


def _scf(dftk, basis, seed, n_start, tol=1e-10, **kw):
    """The SCF from seeded_orbitals(mask, n_start, seed)."""
    import jax.numpy as jnp
    psi0 = seeded_orbitals(basis.mask_np, n_start, seed)
    return dftk.self_consistent_field(basis, tol=tol, psi=jnp.asarray(psi0), **kw)


def _state(res):
    return dict(psi=b64(np.asarray(res.psi)), rho=b64(np.asarray(res.rho)),
                occupation=b64(np.asarray(res.occupation)),
                eigenvalues=b64(np.asarray(res.eigenvalues)), epsF=float(res.epsF),
                energies={k: float(v) for k, v in res.energies.items()},
                n_iter=int(res.n_iter), converged=bool(res.converged))


def entry_bands():
    """tests/test_bands_dos.py's silicon (Ecut 7, 17^3): the SCF (density tol
    1e-10, from seeded_orbitals(mask, 11, 1)), compute_bands(n_bands=6,
    kline_density=6) at its density, the DOS on 800 energies from -0.5 Ha
    to epsF at T 2e-3, and the LDOS at LDOS_EPS on the SCF's eigenvalues
    and psi."""
    import dftk_tpu as dftk
    from dftk_tpu.postprocess.dos import compute_dos, compute_ldos
    basis = bands_basis(dftk)
    res = _scf(dftk, basis, 1, 11, n_bands=8)
    bands = dftk.compute_bands(res, **BANDS)
    eps = np.linspace(DOS_EPS["lo"], res.epsF, DOS_EPS["n"])
    dos = compute_dos(eps, basis, res.eigenvalues, temperature=DOS_EPS["temperature"])
    ldos = compute_ldos(np.array(LDOS_EPS), basis, res.eigenvalues, res.psi)
    return dict(state=_state(res), bands=dict(eigenvalues=bands["eigenvalues"].tolist(),
                                              kcoords=np.asarray(bands["kcoords"]).tolist(),
                                              converged=bands["converged"]),
                dos=dos.tolist(), ldos=[table_summary(x) for x in ldos],
                ldos_dos=compute_dos(np.array(LDOS_EPS), basis, res.eigenvalues).tolist())


def entry_pdos():
    """tests/test_bands_dos.py::test_pdos_silicon: the PBE UPF silicon's SCF
    (density tol 1e-10, from seeded_orbitals(mask, 11, 2)) and
    compute_pdos at Gamma's band bottom and top."""
    import dftk_tpu as dftk
    from dftk_tpu.postprocess.dos import compute_pdos
    basis = pdos_basis(dftk)
    res = _scf(dftk, basis, 2, 11, n_bands=8)
    ev = np.asarray(res.eigenvalues)
    eps = np.array([ev[0, 0], ev[0, 3]])
    pdos = compute_pdos(eps, basis, res.eigenvalues, res.psi)
    return dict(state=_state(res), eps=eps.tolist(),
                pdos={k: np.asarray(v).tolist() for k, v in pdos.items()})


def entry_refine():
    """tests/test_refine_chefsi.py's displaced Si2 at Gamma: the SCF at Ecut
    6 (density tol 1e-10, from seeded_orbitals(mask, 7, 3)), then
    refine_scfres(Ecut_fine=10) with its energies and residual norm, and
    refine_forces and refine_forces_cart."""
    import dftk_tpu as dftk
    from dftk_tpu.postprocess.refine import refine_forces, refine_forces_cart, refine_scfres
    basis = refine_basis(dftk)
    res = _scf(dftk, basis, 3, 7, maxiter=60)
    ref = refine_scfres(res, Ecut_fine=REFINE_ECUT[1])
    fr, fc = refine_forces(ref), refine_forces_cart(ref)
    return dict(state=_state(res), fine_fft_size=list(ref.basis.fft_size),
                energies=ref.energies, total=ref.total_energy,
                residual_norm=ref.residual_norm,
                drho=table_summary(np.asarray(ref.drho)),
                forces={k: np.asarray(v).tolist() for k, v in fr.items()},
                forces_cart={k: np.asarray(v).tolist() for k, v in fc.items()})


def entry_transfer():
    """tests/test_transfer_consistency.py's bases: transfer_mapping from Ecut
    5 to 10 and back, transfer_blochwave of seeded_orbitals(mask, 4, 4),
    and transfer_density of a seeded density from 16^3 to 24^3 and back."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.transfer import transfer_blochwave, transfer_density, transfer_mapping
    b5, b10, g16, g24 = transfer_bases(dftk)
    psi = seeded_orbitals(b5.mask_np, 4, 4)
    up = np.asarray(transfer_blochwave(jnp.asarray(psi), b5, b10))
    rho = seeded_density(g16.fft_size, 5)
    rho_up = np.asarray(transfer_density(jnp.asarray(rho), g16, g24))
    rho_back = np.asarray(transfer_density(jnp.asarray(rho_up), g24, g16))
    return dict(idx_up=b64(np.asarray(transfer_mapping(b5, b10)[0]).astype(np.int32)),
                idx_down=b64(np.asarray(transfer_mapping(b10, b5)[0]).astype(np.int32)),
                up=dict(re=table_summary(up.real), im=table_summary(up.imag)),
                rho_up=table_summary(rho_up), rho_back=table_summary(rho_back))


def entry_misc():
    """cell_to_supercell of the silicon 2^3 grid (seeded orbitals, no SCF),
    standardize_atoms / find_primitive / minkowski_reduce of a Si2 2x1x1
    supercell and of a skewed lattice, kgrid_from_maximal_spacing,
    list_psp / load_psp, random_density and the structure readers."""
    import dftk_tpu as dftk
    from dftk_tpu.external import structure
    from dftk_tpu.supercell import cell_to_supercell, create_supercell
    m = si2_model(dftk)
    b = dftk.PlaneWaveBasis(m, Ecut=7.0, kgrid=(2, 2, 2), use_symmetries_for_kpoint_reduction=False)
    psi = seeded_orbitals(b.mask_np, 4, 6)
    res = FakeResult(basis=b, psi=psi, eigenvalues=np.zeros((b.n_kpoints, 4)))
    sc, folded = cell_to_supercell(res)
    sc2 = create_supercell(SI_LATTICE, ["Si", "Si"], SI_POSITIONS, (2, 1, 1))
    Si = dftk.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    std = dftk.standardize_atoms(sc2["lattice"], [Si] * 4, sc2["positions"])
    skew = SI_LATTICE @ np.array([[1, 1, 0], [0, 1, 0], [0, 0, 1]])
    psps = {}
    for key in ("hgh/lda/si-q4", "lda/c-q4", "Si", "pbe/si-q4"):
        p = dftk.load_psp(key)
        psps[key] = dict(identifier=p.identifier, Zion=p.Zion, rloc=p.rloc, cloc=list(p.cloc),
                         rp=list(p.rp), h=[np.asarray(h).tolist() for h in p.h])
    return dict(
        supercell=dict(size=list(sc["size"]), lattice=np.asarray(sc["lattice"]).tolist(),
                       n_atoms=len(sc["atoms"]),
                       G=[dict(n=int(f["G"].shape[0]), sum=f["G"].sum(0).tolist(),
                               wsum=int((f["G"] @ np.array([1, 97, 9973])).sum()))
                          for f in folded]),
        standardize=dict(lattice=np.asarray(std["lattice"]).tolist(),
                         positions=[np.asarray(p).tolist() for p in std["positions"]]),
        minkowski=np.asarray(dftk.minkowski_reduce(skew)).tolist(),
        kgrid=[list(dftk.kgrid_from_maximal_spacing(SI_LATTICE, s).kgrid_size)
               for s in (0.1, 0.22, 0.5, 1.0)],
        list_psp=dict(all=dftk.list_psp(), si=dftk.list_psp(element="Si"),
                      pbe=dftk.list_psp(family="pbe")),
        psps=psps,
        random_density=table_summary(np.asarray(dftk.random_density(b, seed=3))),
        poscar={k: np.asarray(v).tolist() for k, v in structure.read_poscar(POSCAR).items()},
        xyz={k: np.asarray(v).tolist() for k, v in structure.read_xyz(XYZ).items()},
        xyz_ext={k: np.asarray(v).tolist() for k, v in structure.read_xyz(XYZ_EXT).items()},
        surface={k: np.asarray(v).tolist()
                 for k, v in structure.build_surface_110(n_layers=3).items()})


def entry_io():
    """tests/test_io.py's silicon: the SCF (energy tol 1e-7, from
    seeded_orbitals(mask, 7, 8)) saved by save_scfres into
    tests/data/torch_port_post_scfres.npz; the .vts file of a seeded
    two-spin density with one extra field (its SHA-256); and the Wannier90
    numbers (.eig, .mmn, .amn, 4 bands, 4 functions) of
    tests/test_external.py's silicon on seeded_orbitals(mask, 4, 9) with
    seeded eigenvalues."""
    import dftk_tpu as dftk
    from dftk_tpu.external import wannier
    from dftk_tpu.io.scfres import save_scfres
    from dftk_tpu.io.vtk import save_vts
    basis = io_basis(dftk)
    res = _scf(dftk, basis, 8, 7, tol=1e-7, is_converged="energy")
    save_scfres(SCFRES_NPZ, res)
    wb = wannier_basis(dftk)
    psi = seeded_orbitals(wb.mask_np, 4, 9)
    ev = np.sort(np.random.default_rng(10).uniform(-0.2, 0.5, size=(wb.n_kpoints, 4)), axis=1)
    with tempfile.TemporaryDirectory() as d:
        rho, extra = vts_fields(basis)
        path = os.path.join(d, "si.vts")
        save_vts(path, FakeResult(basis=basis, rho=rho), extra_fields={"extra": extra})
        sha = hashlib.sha256(open(path, "rb").read()).hexdigest()
        nums = write_wannier(wannier, wb, psi, ev, d)
    return dict(total_energy=float(res.total_energy), n_iter=int(res.n_iter),
                scfres_npz=SCFRES_NPZ.name, vts_sha256=sha,
                wannier={k: b64(v) for k, v in nums.items()})


def entry_geometry():
    """tests/test_geometry.py's relaxation (Si2 lda/si-q4 LDA, no symmetry,
    Ecut 6, Gamma, tol_force 1e-3, SCF density tol 1e-8) with the first SCF
    from seeded_orbitals(mask, 7, 12), in GEOMETRY_MAXITER L-BFGS
    iterations; and
    tests/test_external.py::test_calculator_state_reuse's calculator
    (Ecut 5, Gamma, tol 1e-7, maxiter 40) with its first SCF from
    seeded_orbitals(mask, 7, 13)."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.external.calculator import DFTCalculator
    from dftk_tpu.postprocess.geometry import optimize_geometry

    def builder(positions):
        return si2_model(dftk, positions=positions, functionals="LDA", symmetries=False)

    b0 = dftk.PlaneWaveBasis(builder(GEOMETRY_START), Ecut=6.0, kgrid=(1, 1, 1))
    psi0 = jnp.asarray(seeded_orbitals(b0.mask_np, 7, 12))
    out = optimize_geometry(builder, GEOMETRY_START, Ecut=6.0, kgrid=(1, 1, 1),
                            tol_force=1e-3, maxiter=GEOMETRY_MAXITER,
                            scf_kwargs=dict(tol=1e-8, psi=psi0))

    def cbuilder(lattice, positions):
        return si2_model(dftk, positions=positions)

    cb = dftk.PlaneWaveBasis(cbuilder(SI_LATTICE, SI_POSITIONS), Ecut=5.0, kgrid=(1, 1, 1))
    calc = DFTCalculator(cbuilder, Ecut=5.0, kgrid=(1, 1, 1), scf_kwargs=dict(
        tol=1e-7, maxiter=40, psi=jnp.asarray(seeded_orbitals(cb.mask_np, 7, 13))))
    E1 = calc.potential_energy(SI_LATTICE, SI_POSITIONS)
    F1 = np.asarray(calc.forces(SI_LATTICE, SI_POSITIONS))
    E2 = calc.potential_energy(SI_LATTICE, [SI_POSITIONS[0] + 0.01, SI_POSITIONS[1]])
    return dict(positions=[np.asarray(p).tolist() for p in out["positions"]],
                energy=float(out["energy"]), n_scf=int(out["n_scf"]),
                converged=bool(out["converged"]), forces=np.asarray(out["forces"]).tolist(),
                trajectory=[list(map(float, t)) for t in out["trajectory"]],
                calculator=dict(E1=float(E1), E2=float(E2), F1=F1.tolist(),
                                n_scf_calls=calc.n_scf_calls))


def r1_basis(dftk, **kw):
    """chip_smoke.py phase r1's silicon: examples/band_structure_dos.py's
    LDA silicon (lda/si-q4) at Ecut 12 on the MP grid (4, 4, 4), with the
    model's symmetries."""
    return dftk.PlaneWaveBasis(si2_model(dftk), Ecut=R1["Ecut"], kgrid=R1["kgrid"], **kw)


def entry_r1():
    """chip_smoke.py phase r1's JAX values: the SCF of r1_basis (density
    tol 1e-10, from seeded_orbitals(mask, 11, 14)) and compute_bands at
    its density on Gamma, X and L (8 bands, LOBPCG tol 1e-8)."""
    import dftk_tpu as dftk
    basis = r1_basis(dftk)
    res = _scf(dftk, basis, 14, R1["n_bands"] + 3, tol=R1["tol"], n_bands=R1["n_bands"])
    bands = dftk.compute_bands(res, kcoords=list(R1_KPOINTS.values()), n_bands=R1["n_bands"])
    return dict(fft_size=list(basis.fft_size), n_kpoints=int(basis.n_kpoints),
                total_energy=float(res.total_energy), n_iter=int(res.n_iter),
                converged=bool(res.converged), epsF=float(res.epsF),
                eigenvalues={k: bands["eigenvalues"][i].tolist()
                             for i, k in enumerate(R1_KPOINTS)},
                bands_converged=bool(bands["converged"]))


if __name__ == "__main__":
    name = sys.argv[1]
    t0 = time.time()
    values = globals()["entry_" + name]()
    values["description"] = " ".join(globals()["entry_" + name].__doc__.split())
    values["cpu_seconds"] = time.time() - t0
    values["command"] = ("DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python "
                         f"tests/data/make_torch_port_post.py {name}")
    print(json.dumps({name: values}, default=float), flush=True)
