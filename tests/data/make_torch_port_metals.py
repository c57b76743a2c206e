"""The JAX package's CPU float64 values that tests/data/torch_port_metals.json
records for the port's metals, collinear-spin and GGA checks.

    DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python tests/data/make_torch_port_metals.py ENTRY

prints one JSON line: the entry's values, its `command` and its CPU
seconds (wall seconds of the run on the host).  Run from the repository
root.  The problems are the ones `chip_smoke.py` phase k and
tests/test_torch_metals.py build in the port; `chip_smoke.py` copies the
cell builders below.  This script imports the JAX package, so it lives
outside both packages.
"""
import json
import sys
import time

import numpy as np

import dftk_tpu as dftk
from dftk_tpu.ops.density import guess_density
from dftk_tpu.ops.engine_split import self_consistent_field_split

A_FE = 5.42352                       # bcc iron, conventional cube (bohr)
FE_PRIMITIVE = 2.71176 * np.array([[-1, 1, 1], [1, -1, 1], [1, 1, -1]], dtype=float)
A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
AL_LATTICE = np.diag([4 * 7.6324708938577865, 7.6324708938577865, 7.6324708938577865])
AL_POSITIONS = [np.array([0, 0, 0]), np.array([0, 1 / 2, 1 / 2]),
                np.array([1 / 8, 0, 1 / 2]), np.array([1 / 8, 1 / 2, 0])]
AL_SMEARING_WIDTH = 0.01            # Marzari-Vanderbilt width (Ha) of the Al4 runs
FE2_DISPLACEMENT = (0.004, -0.002, 0.001)


def fe_bcc_cell(n, displacement=None):
    """The bcc iron conventional cube repeated n times along each axis:
    lattice and fractional positions (the corner atom then the body centre
    of each cube, cubes in i, j, k order); atom 1 moved by displacement."""
    pos = []
    for i in range(n):
        for j in range(n):
            for k in range(n):
                c = np.array([i, j, k], dtype=float)
                pos += [c / n, (c + 0.5) / n]
    if displacement is not None:
        pos[1] = pos[1] + np.array(displacement)
    return A_FE * n * np.eye(3), pos


def fe_model(lattice, positions, functionals):
    """Iron (HGH lda/fe-q8) with moment 4 on each atom, FermiDirac T = 0.01."""
    Fe = dftk.ElementPsp.from_symbol("Fe", psp="lda/fe-q8")
    return dftk.model_DFT(lattice, [Fe] * len(positions), positions,
                          functionals=functionals, temperature=0.01,
                          smearing=dftk.Smearing.FermiDirac(),
                          magnetic_moments=[4.0] * len(positions))


def magnetisation(basis, rho):
    rho = np.asarray(rho)
    return float((rho[0] - rho[1]).sum() * basis.dvol) if len(rho) == 2 else 0.0


def n_electrons(basis, rho):
    return float(np.asarray(rho).sum() * basis.dvol)


def iron_lda(Ecut, fft, kgrid, tol, n_bands=8):
    """tests/test_metals_spin.py::run_iron's problem."""
    model = fe_model(FE_PRIMITIVE, [np.zeros(3)], ("lda_xc_teter93",))
    basis = dftk.PlaneWaveBasis(model, Ecut=Ecut, fft_size=(fft,) * 3,
                                kgrid=dftk.MonkhorstPack(kgrid, (0.5, 0.5, 0.5)))
    rho0 = guess_density(basis, magnetic_moments=[4.0])
    res = dftk.self_consistent_field(basis, tol=tol, rho=rho0, n_bands=n_bands, maxiter=60)
    return basis, res


def scf_values(basis, res):
    return dict(total_energy=res.total_energy, energies=res.energies,
                epsF=res.epsF, converged=res.converged, n_iter=res.n_iter,
                magnetisation=magnetisation(basis, res.rho),
                n_electrons=n_electrons(basis, res.rho),
                n_kpoints=basis.n_kpoints, fft_size=list(basis.fft_size),
                n_symmetries=len(basis.symmetries),
                eigenvalues=np.asarray(res.eigenvalues).tolist())


def entry_iron_lda_golden():
    """test_iron_lda_golden: Ecut 15, fft 20, MP (4,4,4) + 1/2, teter93,
    FermiDirac T = 0.01, moment 4, density tolerance 1e-8, 8 bands."""
    return scf_values(*iron_lda(15.0, 20, (4, 4, 4), 1e-8))


def entry_iron_lda_small():
    """test_iron_lda_small's problem (Ecut 8, fft 16) on MP (2,2,2) + 1/2,
    density tolerance 1e-9."""
    return scf_values(*iron_lda(8.0, 16, (2, 2, 2), 1e-9))


def entry_iron_pbe_golden():
    """test_iron_pbe_golden: PBE on lda/fe-q8, collinear (no moments in the
    model), Ecut 20, fft 20, MP (4,4,4) + 1/2, guess with moment 4, density
    tolerance 1e-12, 10 bands."""
    Fe = dftk.ElementPsp.from_symbol("Fe", psp="lda/fe-q8")
    model = dftk.model_DFT(FE_PRIMITIVE, [Fe], [np.zeros(3)], functionals="PBE",
                           temperature=0.01, spin_polarization="collinear")
    basis = dftk.PlaneWaveBasis(model, Ecut=20.0, fft_size=(20,) * 3,
                                kgrid=dftk.MonkhorstPack((4, 4, 4), (0.5, 0.5, 0.5)))
    rho0 = guess_density(basis, magnetic_moments=[4.0])
    res = dftk.self_consistent_field(basis, tol=1e-12, rho=rho0, n_bands=10, maxiter=100)
    return scf_values(basis, res)


def entry_silicon_pbe_golden():
    """test_silicon_pbe_large: pbe/si-q4, Ecut 25, grid 33, the 4 explicit
    k-points, energy tolerance 1e-9, 8 bands."""
    Si = dftk.ElementPsp.from_symbol("Si", psp="pbe/si-q4")
    model = dftk.model_DFT(SI_LATTICE, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                           functionals="PBE")
    kgrid = dftk.ExplicitKpoints([[0, 0, 0], [1 / 3, 0, 0], [1 / 3, 1 / 3, 0],
                                  [-1 / 3, 1 / 3, 0]], [1 / 27, 8 / 27, 6 / 27, 12 / 27])
    basis = dftk.PlaneWaveBasis(model, Ecut=25.0, kgrid=kgrid, fft_size=(33,) * 3)
    res = dftk.self_consistent_field(basis, tol=1e-9, n_bands=8, is_converged="energy")
    return scf_values(basis, res)


def entry_aluminium_mv_ldos():
    """Al4 (tests/testcases.py's cell), lda_x + lda_c_pw, MarzariVanderbilt
    of width T = 0.01 (at the testcase's 9.5e-4 the SCF needs over 100
    iterations), LdosMixing, Ecut 7, MP (1,3,3), density tolerance 1e-10."""
    Al = dftk.ElementPsp.from_symbol("Al", psp="lda/al-q3")
    model = dftk.model_DFT(AL_LATTICE, [Al] * 4, AL_POSITIONS,
                           functionals=["lda_x", "lda_c_pw"], temperature=AL_SMEARING_WIDTH,
                           smearing=dftk.Smearing.MarzariVanderbilt())
    basis = dftk.PlaneWaveBasis(model, Ecut=7.0, kgrid=dftk.MonkhorstPack((1, 3, 3)))
    res = dftk.self_consistent_field(basis, tol=1e-10, mixing=dftk.LdosMixing(), maxiter=100)
    return scf_values(basis, res)


def fe2_derivatives(Ecut, kgrid, seeds):
    """Conventional bcc Fe2, atom 1 moved, PBE, moments (4, 4), FermiDirac
    0.01, default symmetries: LOBPCG SCF to a density tolerance of 1e-10 from
    each seed, then compute_forces_cart and compute_stresses_cart."""
    lattice, pos = fe_bcc_cell(1, FE2_DISPLACEMENT)
    model = fe_model(lattice, pos, "PBE")
    basis = dftk.PlaneWaveBasis(model, Ecut=Ecut, kgrid=dftk.MonkhorstPack(kgrid))
    out = dict(n_symmetries=len(basis.symmetries), n_kpoints=basis.n_kpoints,
               fft_size=list(basis.fft_size), runs=[])
    for seed in seeds:
        rho0 = guess_density(basis, magnetic_moments=[4.0, 4.0])
        t0 = time.time()
        res = dftk.self_consistent_field(basis, tol=1e-10, rho=rho0, seed=seed, maxiter=100)
        t1 = time.time()
        F = np.asarray(dftk.compute_forces_cart(res))
        S = np.asarray(dftk.compute_stresses_cart(res))
        run = scf_values(basis, res)
        run.update(seed=seed, forces_cart=F.tolist(), stresses_cart=S.tolist(),
                   scf_seconds=t1 - t0, derivative_seconds=time.time() - t1)
        out["runs"].append(run)
    r = out["runs"]
    if len(r) == 2:
        out["two_runs_agree"] = dict(
            energy=abs(r[0]["total_energy"] - r[1]["total_energy"]),
            forces=float(np.abs(np.array(r[0]["forces_cart"]) - r[1]["forces_cart"]).max()),
            stresses=float(np.abs(np.array(r[0]["stresses_cart"])
                                  - r[1]["stresses_cart"]).max()))
    out.update({k: r[0][k] for k in ("total_energy", "forces_cart", "stresses_cart",
                                     "magnetisation", "n_electrons", "epsF")})
    return out


def entry_fe2_pbe_derivatives():
    """fe2_derivatives at Ecut 15 on MP (3,3,3), two SCFs (seeds 42, 7)
    whose agreement sets chip_smoke.py phase k4's bars."""
    return fe2_derivatives(15.0, (3, 3, 3), (42, 7))


def entry_fe2_pbe_derivatives_small():
    """fe2_derivatives at Ecut 6, Gamma, one SCF (seed 42)."""
    return fe2_derivatives(6.0, (1, 1, 1), (42,))


def fe_split(n, n_bands, tol, maxiter, Ecut=15.0, symmetrize=True):
    """Ferromagnetic bcc iron cube n x n x n, PBE, moment 4 on each atom,
    FermiDirac 0.01, Gamma, default symmetries: the split CheFSI SCF in
    float64 ("mixed" filter, degree 10, 2 cycles, AdaptiveBands on)."""
    import jax.numpy as jnp
    lattice, pos = fe_bcc_cell(n)
    model = fe_model(lattice, pos, "PBE")
    basis = dftk.PlaneWaveBasis(model, Ecut=Ecut, kgrid=(1, 1, 1))
    rho0 = guess_density(basis, magnetic_moments=[4.0] * len(pos))
    its = []
    res = self_consistent_field_split(
        basis, tol=tol, maxiter=maxiter, n_bands=n_bands, eigensolver="chefsi",
        chebyshev_degree=10, chefsi_cycles=2, is_converged="density",
        filter_precision="mixed", dtype=jnp.float64, rho0=rho0, symmetrize=symmetrize,
        callback=lambda info: its.append((time.time(), dict(
            (k, v) for k, v in info.items() if isinstance(v, (int, float))))))
    rho = np.asarray(res["rho"])
    occ = np.asarray(res["occupation"])
    out = dict(total_energy=res["energies"]["total"], energies=res["energies"],
               epsF=res["epsF"], converged=bool(res["converged"]), n_iter=res["n_iter"],
               magnetisation=magnetisation(basis, rho), n_electrons=n_electrons(basis, rho),
               n_bands_final=int(occ.shape[1]),
               n_occupied_1e6=np.sum(occ > 1e-6, axis=1).tolist(),
               n_symmetries=len(basis.symmetries), fft_size=list(basis.fft_size),
               nG_max=int(basis.nG_max), history=[list(h) for h in res["history"]],
               callbacks=[info for _, info in its])
    if len(its) > 1:
        out["seconds_per_iteration"] = [b[0] - a[0] for a, b in zip(its, its[1:])]
    return out


def entry_fe16_split():
    """fe_split of Fe16 (2 x 2 x 2), 96 bands, density tolerance 1e-7."""
    return fe_split(2, 96, 1e-7, 80)


def entry_fe54_split_one_iteration():
    """Fe54 (3 x 3 x 3) as in chip_smoke.py phase k5, 340 bands, cut after 2
    iterations to time one, without the density symmetrization (the JAX
    symmetrizer stacks its 2592 operations' gathered densities, [2592, 2,
    60^3] complex, 18 GB, before it sums them)."""
    return fe_split(3, 340, 1e-7, 2, symmetrize=False)


SMEARINGS = {"FermiDirac": (), "Gaussian": (), "MarzariVanderbilt": (),
             "MethfesselPaxton0": (0,), "MethfesselPaxton1": (1,),
             "MethfesselPaxton2": (2,)}
OCCUPATION_TEMPERATURES = (0.003, 0.01, 0.1)


def entry_occupations():
    """compute_occupation (8 electrons, filled occupation 2) and
    entropy_energy of every smearing at T = 0.003, 0.01 and 0.1, on the
    eigenvalues np.sort(np.random.default_rng(21).normal(size=(4, 12)),
    axis=1) with k weights (0.1, 0.2, 0.3, 0.4): occupations, epsF and the
    entropy term under "SMEARING T"."""
    import jax.numpy as jnp
    from dftk_tpu.ops.occupation import compute_occupation, entropy_energy
    ev = jnp.asarray(np.sort(np.random.default_rng(21).normal(size=(4, 12)), axis=1))
    w = jnp.asarray([0.1, 0.2, 0.3, 0.4])
    out = {}
    for name, args in SMEARINGS.items():
        smearing = getattr(dftk.Smearing, name.rstrip("012"))(*args)
        for T in OCCUPATION_TEMPERATURES:
            occ, epsF = compute_occupation(ev, w, 8, 2.0, T, smearing)
            out[f"{name} {T}"] = dict(
                occupation=np.asarray(occ).tolist(), epsF=float(epsF),
                entropy=float(entropy_energy(ev, w, epsF, T, smearing, 2.0)))
    return out


def entry_fe2_local_potential():
    """Fe2 (the conventional bcc cube, atom 1 moved), moments (4, 2), with
    the density-dependent local terms only (Kinetic, AtomicLocal, Hartree,
    Xc gga_x_pbe + gga_c_pbe), FermiDirac 0.01, no symmetries, Ecut 3, fft
    8^3, Gamma: total_potential and the split engine's
    total_potential_split (float64) at guess_density(basis, [4, 2]): V
    [2, 8, 8, 8] of each and their AtomicLocal, Hartree and Xc energies."""
    import jax.numpy as jnp
    from dftk_tpu.ops import hamiltonian as ham
    from dftk_tpu.ops.engine_split import prepare_split_data, total_potential_split
    lattice, pos = fe_bcc_cell(1, FE2_DISPLACEMENT)
    Fe = dftk.ElementPsp.from_symbol("Fe", psp="lda/fe-q8")
    pbe = ("gga_x_pbe", "gga_c_pbe")
    model = dftk.Model(lattice, [Fe, Fe], pos, magnetic_moments=[4.0, 2.0],
                       temperature=0.01, symmetries=False,
                       term_types=[dftk.Kinetic(), dftk.AtomicLocal(), dftk.Hartree(),
                                   dftk.Xc(pbe)])
    basis = dftk.PlaneWaveBasis(model, Ecut=3.0, fft_size=(8, 8, 8))
    rho = guess_density(basis, magnetic_moments=[4.0, 2.0])
    vol = model.unit_cell_volume
    V, E = ham.total_potential(basis.terms, rho, jnp.asarray(basis.G_cube_cart), vol)
    Vs, Es = total_potential_split(basis.terms, prepare_split_data(basis, jnp.float64),
                                   rho, vol)
    keys = ("AtomicLocal", "Hartree", "Xc")
    return dict(V=np.asarray(V).tolist(), energies={k: float(E[k]) for k in keys},
                V_split=np.asarray(Vs).tolist(),
                energies_split={k: float(Es[k]) for k in keys})


def entry_split_adaptive_small():
    """A T > 0 split SCF in which AdaptiveBands grows: Al4 at Ecut 3, Gamma,
    FermiDirac at T = 0.01, 4 + 1 bands to start (6 are occupied),
    LOBPCG, density tolerance 1e-8."""
    import jax.numpy as jnp
    Al = dftk.ElementPsp.from_symbol("Al", psp="lda/al-q3")
    model = dftk.model_DFT(AL_LATTICE, [Al] * 4, AL_POSITIONS,
                           functionals=["lda_x", "lda_c_pw"], temperature=0.01)
    basis = dftk.PlaneWaveBasis(model, Ecut=3.0, kgrid=(1, 1, 1))
    growth = []
    res = self_consistent_field_split(
        basis, tol=1e-8, maxiter=80, n_bands=4, n_extra_bands=1, is_converged="density",
        dtype=jnp.float64,
        callback=lambda info: growth.append(info["adaptive_bands"])
        if "adaptive_bands" in info else None)
    rho = np.asarray(res["rho"])
    return dict(total_energy=res["energies"]["total"], energies=res["energies"],
                epsF=res["epsF"], converged=bool(res["converged"]), n_iter=res["n_iter"],
                n_electrons=n_electrons(basis, rho), growth=growth,
                n_bands_final=int(np.asarray(res["occupation"]).shape[1]),
                fft_size=list(basis.fft_size))


if __name__ == "__main__":
    name = sys.argv[1]
    t0 = time.time()
    values = globals()["entry_" + name]()
    values["cpu_seconds"] = time.time() - t0
    values["command"] = ("DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python "
                         f"tests/data/make_torch_port_metals.py {name}")
    print(json.dumps({name: values}, default=float), flush=True)
