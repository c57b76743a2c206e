"""The JAX package's CPU float64 values that tests/data/torch_port_parallel.json
records for the port's k-point x band parallel path (tests/test_torch_parallel.py).

    PYTHONPATH=. DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python tests/data/make_torch_port_parallel.py ENTRY

prints one JSON line: the entry's values, its `command` and its CPU
seconds (wall seconds of the run on the host), all on one device: the
port's two-rank runs are held against these single-device values.  Run
from the repository root.  The cells' constructors take either package
(`dftk` is `dftk_tpu` here, the port in tests/torch_parallel_ranks.py,
which passes device="cpu"), so both sides build the same problem.  The
cells and the SCF settings are those of tests/test_parallel.py and of
`__graft_entry__.py::dryrun_multichip`.  This script imports the JAX
package, so it lives outside both packages.
"""
import json
import pathlib
import sys
import time

import numpy as np

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
SI_POSITIONS = [np.ones(3) / 8, -np.ones(3) / 8]
# atom 0 moved off its site (reduced): forces of order 1e-2 Ha/bohr
SI_DISPLACED = [np.ones(3) / 8 + np.array([0.02, -0.01, 0.005]), -np.ones(3) / 8]
C_UPF = str(pathlib.Path(__file__).resolve().parent / "pseudos" / "C_m.upf")
HUBBARD_U = 0.15
MAGNETIC_MOMENTS = [1.0, 1.0]

# tests/test_parallel.py: Si2 at Ecut 5 on a 16^3 grid
LOBPCG_SCF = dict(tol=1e-10, maxiter=30)
# __graft_entry__.py::dryrun_multichip: the split SCF in float64
SPLIT_SCF = dict(tol=1e-12, maxiter=60, n_bands=6, eigensolver_maxiter=30,
                 diagtol_min=1e-9, seed=11)
# the displaced cell's split SCF to a density tolerance: forces are first
# order in the state's error (the energy criterion leaves ~1e-7 Ha/bohr)
FORCES_SPLIT_SCF = dict(SPLIT_SCF, tol=1e-10, is_converged="density")
HF_SCF = dict(tol=1e-12, maxiter=40, n_bands=2, eigensolver_maxiter=25,
              diagtol_min=1e-9, seed=11)


def silicon_model(dftk):
    Si = dftk.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    return dftk.model_DFT(SI_LATTICE, [Si, Si], SI_POSITIONS,
                          functionals=["lda_x", "lda_c_vwn"])


def kpts_basis(dftk, **kw):
    """tests/test_parallel.py::_make_basis: the unreduced 2x2x2 grid, 8
    k-points."""
    return dftk.PlaneWaveBasis(silicon_model(dftk), Ecut=5.0, kgrid=dftk.MonkhorstPack((2, 2, 2)),
                               fft_size=(16, 16, 16), use_symmetries_for_kpoint_reduction=False,
                               **kw)


def padded_basis(dftk, **kw):
    """The 2x2x2 grid reduced by the crystal's symmetries (3 k-points)."""
    return dftk.PlaneWaveBasis(silicon_model(dftk), Ecut=5.0, kgrid=dftk.MonkhorstPack((2, 2, 2)),
                               fft_size=(16, 16, 16), **kw)


def dryrun_basis(dftk, **kw):
    """__graft_entry__.py::dryrun_multichip's cell: Ecut 3, 12^3, 8
    unreduced k-points."""
    return dftk.PlaneWaveBasis(silicon_model(dftk), Ecut=3.0, kgrid=dftk.MonkhorstPack((2, 2, 2)),
                               fft_size=(12, 12, 12), use_symmetries_for_kpoint_reduction=False,
                               **kw)


def hf_basis(dftk, **kw):
    """__graft_entry__.py::dryrun_multichip's k-grid HF helium: the
    truncated Coulomb kernel of radius 3 on MonkhorstPack((2, 1, 1))."""
    He = dftk.ElementPsp.from_symbol("He", psp="lda/he-q2")
    terms = [dftk.Kinetic(), dftk.AtomicLocal(), dftk.AtomicNonlocal(), dftk.Ewald(),
             dftk.PspCorrection(), dftk.Hartree(),
             dftk.ExactExchange(scaling_factor=1.0,
                                kernel=dftk.SphericallyTruncatedCoulomb(rc=3.0))]
    model = dftk.Model(np.diag([6.0, 6.0, 6.0]), [He], [np.array([.5, .5, .5])],
                       term_types=terms, symmetries=False)
    return dftk.PlaneWaveBasis(model, Ecut=3.0, kgrid=dftk.MonkhorstPack((2, 1, 1)),
                               fft_size=(10, 10, 10), use_symmetries_for_kpoint_reduction=False,
                               **kw)


def displaced_basis(dftk, functionals=("lda_x", "lda_c_vwn"), psp="lda/si-q4", **kw):
    """The dry run's cell (Ecut 3, 12^3, 8 unreduced k-points) with atom 0
    displaced (SI_DISPLACED), under `functionals` on `psp`."""
    Si = dftk.ElementPsp.from_symbol("Si", psp=psp)
    model = dftk.model_DFT(SI_LATTICE, [Si, Si], SI_DISPLACED, functionals=functionals)
    return dftk.PlaneWaveBasis(model, Ecut=3.0, kgrid=dftk.MonkhorstPack((2, 2, 2)),
                               fft_size=(12, 12, 12), use_symmetries_for_kpoint_reduction=False,
                               **kw)


def spin_hubbard_basis(dftk, **kw):
    """examples/hubbard.py's C2 PBE+U (U 0.15 on both p manifolds), made
    collinear (moments 1) and smeared (Gaussian, T 0.01), at Ecut 6 on a 15^3
    grid and the 2 unreduced k-points of MonkhorstPack((2, 1, 1)): 4 k rows,
    the spin-up ones on rank 0 and the spin-down ones on rank 1."""
    C = dftk.ElementPsp.from_symbol("C", psp=C_UPF)
    mfs = (dftk.HubbardManifold(atom_index=0, l=1, U=HUBBARD_U),
           dftk.HubbardManifold(atom_index=1, l=1, U=HUBBARD_U))
    model = dftk.model_DFT(SI_LATTICE, [C, C], SI_POSITIONS, functionals="PBE",
                           temperature=0.01, smearing=dftk.Smearing.Gaussian(),
                           magnetic_moments=MAGNETIC_MOMENTS,
                           extra_terms=[dftk.Hubbard(manifolds=mfs)])
    return dftk.PlaneWaveBasis(model, Ecut=6.0, kgrid=dftk.MonkhorstPack((2, 1, 1)),
                               fft_size=(15, 15, 15), use_symmetries_for_kpoint_reduction=False,
                               **kw)


def entry_lobpcg():
    """Cell (a): self_consistent_field on tests/test_parallel.py's cell (seed
    7), its energy, sorted eigenvalues and density; and cell (b): the same
    SCF on the symmetry-reduced grid (seed 3), its k-point count and
    energy."""
    import dftk_tpu as dftk
    res = dftk.self_consistent_field(kpts_basis(dftk), seed=7, **LOBPCG_SCF)
    basis_b = padded_basis(dftk)
    res_b = dftk.self_consistent_field(basis_b, seed=3, **LOBPCG_SCF)
    return dict(total_energy=float(res.total_energy), converged=bool(res.converged),
                eigenvalues_sorted=np.sort(np.asarray(res.eigenvalues), axis=None).tolist(),
                rho=np.asarray(res.rho).ravel().tolist(),
                padded=dict(n_kpoints=int(basis_b.n_kpoints),
                            kweights=np.asarray(basis_b.kweights).tolist(),
                            total_energy=float(res_b.total_energy),
                            converged=bool(res_b.converged)))


def entry_split():
    """Cell (c): self_consistent_field_split in float64 on the dry run's
    cell, its energy, and compute_forces_split on its state; and cell (d):
    the k-grid HF helium split SCF, its energy."""
    import jax
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops.engine_split import prepare_split_data, self_consistent_field_split
    from dftk_tpu.ops.forces_split import compute_forces_split
    basis = dryrun_basis(dftk)
    res = self_consistent_field_split(basis, dtype=jnp.float64, **SPLIT_SCF)
    sd = prepare_split_data(basis, dtype=jnp.float64)
    F = np.asarray(jax.device_get(compute_forces_split(basis, sd, res["U"], res["occupation"],
                                                       res["rho"])))
    res_hf = self_consistent_field_split(hf_basis(dftk), dtype=jnp.float64, **HF_SCF)
    return dict(total_energy=float(res["energies"]["total"]), converged=bool(res["converged"]),
                forces=F.tolist(),
                hf=dict(total_energy=float(res_hf["energies"]["total"]),
                        converged=bool(res_hf["converged"])))


def entry_forces():
    """The k sum of the nonlocal forces: on displaced_basis under r2SCAN
    (pbe/si-q4), self_consistent_field (seed 5) and compute_forces_cart of
    its result; on displaced_basis (LDA), self_consistent_field_split in
    float64 (FORCES_SPLIT_SCF) and compute_forces_split on its state."""
    import jax
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops.engine_split import prepare_split_data, self_consistent_field_split
    from dftk_tpu.ops.forces_split import compute_forces_split
    res = dftk.self_consistent_field(displaced_basis(dftk, "r2SCAN", "pbe/si-q4"), seed=5,
                                     **LOBPCG_SCF)
    basis = displaced_basis(dftk)
    sres = self_consistent_field_split(basis, dtype=jnp.float64, **FORCES_SPLIT_SCF)
    sd = prepare_split_data(basis, dtype=jnp.float64)
    F = compute_forces_split(basis, sd, sres["U"], sres["occupation"], sres["rho"])
    return dict(total_energy=float(res.total_energy), converged=bool(res.converged),
                forces_cart=np.asarray(dftk.compute_forces_cart(res)).tolist(),
                split=dict(total_energy=float(sres["energies"]["total"]),
                           converged=bool(sres["converged"]),
                           forces=np.asarray(jax.device_get(F)).tolist()))


def entry_spin():
    """self_consistent_field (seed 9) on spin_hubbard_basis from
    guess_density with the moments MAGNETIC_MOMENTS: its energy, Fermi
    level, magnetisation and density."""
    import dftk_tpu as dftk
    from dftk_tpu.ops.density import guess_density
    basis = spin_hubbard_basis(dftk)
    res = dftk.self_consistent_field(basis, seed=9, rho=guess_density(basis, MAGNETIC_MOMENTS),
                                     **LOBPCG_SCF)
    rho = np.asarray(res.rho)
    return dict(total_energy=float(res.total_energy), converged=bool(res.converged),
                n_iter=int(res.n_iter), epsF=float(res.epsF), energies=dict(res.energies),
                magnetisation=float((rho[0] - rho[1]).sum() * basis.dvol),
                rho=rho.ravel().tolist())


if __name__ == "__main__":
    name = sys.argv[1]
    t0 = time.time()
    values = globals()["entry_" + name]()
    values["description"] = " ".join(globals()["entry_" + name].__doc__.split())
    values["cpu_seconds"] = time.time() - t0
    values["command"] = ("PYTHONPATH=. DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python "
                         f"tests/data/make_torch_port_parallel.py {name}")
    print(json.dumps({name: values}, default=float), flush=True)
