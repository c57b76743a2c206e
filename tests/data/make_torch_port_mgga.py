"""The JAX package's CPU float64 values that tests/data/torch_port_mgga.json
records for the port's UPF, NLCC and meta-GGA checks.

    DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python tests/data/make_torch_port_mgga.py ENTRY

prints one JSON line: the entry's values, its `command` and its CPU
seconds (wall seconds of the run on the host).  Run from the repository
root.  The problems are the ones `chip_smoke.py` phase l and
tests/test_torch_upf.py / tests/test_torch_mgga.py build in the port;
`chip_smoke.py` copies the cell builders below.  This script imports the
JAX package, so it lives outside both packages.
"""
import json
import sys
import time

import numpy as np

import dftk_tpu as dftk
from dftk_tpu.ops.engine_split import self_consistent_field_split

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
SI_POSITIONS = [np.ones(3) / 8, -np.ones(3) / 8]
SI_KPOINTS = ([[0, 0, 0], [1 / 3, 0, 0], [1 / 3, 1 / 3, 0], [-1 / 3, 1 / 3, 0]],
              [1 / 27, 8 / 27, 6 / 27, 12 / 27])
C_LATTICE = 6.74 / 2 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]])
C_POSITIONS = [np.ones(3) / 8, -np.ones(3) / 8]
C_DISPLACED = [np.array([0.128, 0.124, 0.122]), -np.ones(3) / 8]
C_UPF = "tests/data/pseudos/C_m.upf"
SI_UPF = "tests/data/pseudos/gth/Si.pbe-hgh.upf"
# DFTK's test/silicon_scan.jl golden (tests/test_scan.py:12-16)
SCAN_GOLDEN = dict(total_energy=-7.856498623457256,
                   eigenvalues_k0=[-0.205978425740779, 0.25380659461563, 0.25380659461831,
                                   0.254732985691879, 0.359893487572120, 0.35989348757842,
                                   0.36073308297652, 0.393192520642558])


def silicon(psp, functionals, Ecut, fft, kgrid, symmetries=True):
    Si = dftk.ElementPsp.from_symbol("Si", psp=psp)
    model = dftk.model_DFT(SI_LATTICE, [Si, Si], SI_POSITIONS, functionals=functionals,
                           symmetries=symmetries)
    return dftk.PlaneWaveBasis(model, Ecut=Ecut, kgrid=kgrid, fft_size=(fft,) * 3)


def carbon(positions, functionals="SCAN", Ecut=10.0, fft=18):
    """Diamond C2 from the meta-GGA ONCVPSP file C_m.upf (NLCC with
    PP_TAUMOD), default symmetries, Gamma."""
    C = dftk.ElementPsp.from_symbol("C", psp=C_UPF)
    model = dftk.model_DFT(C_LATTICE, [C, C], positions, functionals=functionals)
    return dftk.PlaneWaveBasis(model, Ecut=Ecut, kgrid=(1, 1, 1), fft_size=(fft,) * 3)


def scf_values(basis, res):
    return dict(total_energy=res.total_energy, energies=res.energies,
                converged=res.converged, n_iter=res.n_iter,
                n_kpoints=basis.n_kpoints, fft_size=list(basis.fft_size),
                n_symmetries=len(basis.symmetries),
                eigenvalues=np.asarray(res.eigenvalues).tolist())


def split_values(basis, res):
    return dict(total_energy=res["energies"]["total"], energies=res["energies"],
                converged=bool(res["converged"]), n_iter=res["n_iter"],
                eigenvalues=np.asarray(res["eigenvalues"]).tolist())


def split_scf(basis, tol, n_bands=None, **kw):
    """The JAX split SCF in float64 to a density tolerance: CheFSI with the
    "mixed" filter (degree 10, 2 cycles), or as kw says."""
    import jax.numpy as jnp
    args = dict(eigensolver="chefsi", chebyshev_degree=10, chefsi_cycles=2,
                filter_precision="mixed")
    args.update(kw)
    return self_consistent_field_split(basis, tol=tol, maxiter=100, n_bands=n_bands,
                                       is_converged="density", dtype=jnp.float64, **args)


def entry_silicon_scan_golden():
    """test_silicon_scan_golden's problem: SCAN, pbe/si-q4, Ecut 15, fft 27,
    the silicon IBZ k-set, 8 bands, energy tolerance 1e-9; with the golden."""
    basis = silicon("pbe/si-q4", "SCAN", 15.0, 27, dftk.ExplicitKpoints(*SI_KPOINTS))
    res = dftk.self_consistent_field(basis, tol=1e-9, is_converged="energy", maxiter=40,
                                     n_bands=8)
    out = scf_values(basis, res)
    out["golden"] = SCAN_GOLDEN
    return out


def silicon_small(psp, functionals):
    """Silicon at Ecut 7, fft 17, the silicon k-set (tests/test_psp_upf.py's
    problem), LOBPCG to a density tolerance of 1e-10."""
    basis = silicon(psp, functionals, 7.0, 17, dftk.ExplicitKpoints(*SI_KPOINTS))
    return scf_values(basis, dftk.self_consistent_field(basis, tol=1e-10, maxiter=60))


def entry_si_upf_pbe():
    """silicon_small from the GTH UPF file gth/Si.pbe-hgh.upf, PBE."""
    return silicon_small(SI_UPF, "PBE")


def entry_si_hgh_pbe():
    """silicon_small from the built-in pbe/si-q4 table, PBE."""
    return silicon_small("pbe/si-q4", "PBE")


def entry_si_tpss():
    """silicon_small, pbe/si-q4, TPSS."""
    return silicon_small("pbe/si-q4", "TPSS")


def entry_si_r2scan():
    """silicon_small, pbe/si-q4, r2SCAN."""
    return silicon_small("pbe/si-q4", "r2SCAN")


def entry_si_tb09():
    """tests/test_tb09.py:91-108: TB09 (lda/si-q4), Ecut 8, MP (2,2,2), fft
    18, 6 bands, density tolerance 1e-9, LOBPCG and the split SCF (LOBPCG,
    its eigensolver tolerance floor at 1e-11 as the LOBPCG driver's: at the
    split default of 3e-5 the two loops' eigenvalues differ by 1e-7)."""
    basis = silicon("lda/si-q4", "TB09", 8.0, 18, (2, 2, 2))
    res = dftk.self_consistent_field(basis, tol=1e-9, maxiter=60, n_bands=6,
                                     is_converged="density")
    sres = split_scf(basis, 1e-9, n_bands=6, eigensolver="lobpcg", diagtol_min=1e-11)
    out = scf_values(basis, res)
    out["split"] = split_values(basis, sres)
    return out


def entry_si2_scan_gamma():
    """Si2 SCAN (pbe/si-q4) at Ecut 6, Gamma, fft 15, default symmetries:
    LOBPCG and the split SCF with LOBPCG (its eigensolver tolerance floor at
    1e-10) to a density tolerance of 1e-10."""
    basis = silicon("pbe/si-q4", "SCAN", 6.0, 15, (1, 1, 1))
    res = dftk.self_consistent_field(basis, tol=1e-10, maxiter=60)
    out = scf_values(basis, res)
    out["split"] = split_values(basis, split_scf(basis, 1e-10, eigensolver="lobpcg",
                                                 diagtol_min=1e-10))
    return out


def entry_c2_scan_nlcc():
    """Diamond C2 (C_m.upf, SCAN with NLCC and tau_core) at Ecut 10, fft 18,
    Gamma: LOBPCG and the split CheFSI SCF ("mixed") to a density tolerance
    of 1e-10."""
    basis = carbon(C_POSITIONS)
    res = dftk.self_consistent_field(basis, tol=1e-10, maxiter=80)
    out = scf_values(basis, res)
    out["split"] = split_values(basis, split_scf(basis, 1e-10))
    return out


def entry_c2_scan_nlcc_derivatives():
    """carbon() with atom 0 at (0.128, 0.124, 0.122): the LOBPCG SCF to a
    density tolerance of 1e-11 from seeds 42 and 7, then
    compute_forces_cart and compute_stresses_cart of each (the NLCC and
    tau_core terms included)."""
    basis = carbon(C_DISPLACED)
    out = dict(n_symmetries=len(basis.symmetries), n_kpoints=basis.n_kpoints,
               fft_size=list(basis.fft_size), runs=[])
    for seed in (42, 7):
        t0 = time.time()
        res = dftk.self_consistent_field(basis, tol=1e-11, maxiter=80, seed=seed)
        t1 = time.time()
        run = scf_values(basis, res)
        run.update(seed=seed, forces_cart=np.asarray(dftk.compute_forces_cart(res)).tolist(),
                   stresses_cart=np.asarray(dftk.compute_stresses_cart(res)).tolist(),
                   scf_seconds=t1 - t0, derivative_seconds=time.time() - t1)
        out["runs"].append(run)
    r = out["runs"]
    out["two_runs_agree"] = dict(
        energy=abs(r[0]["total_energy"] - r[1]["total_energy"]),
        forces=float(np.abs(np.array(r[0]["forces_cart"]) - r[1]["forces_cart"]).max()),
        stresses=float(np.abs(np.array(r[0]["stresses_cart"]) - r[1]["stresses_cart"]).max()))
    out.update({k: r[0][k] for k in ("total_energy", "forces_cart", "stresses_cart")})
    return out


MGGA = ("mgga_x_scan", "mgga_x_r2scan", "mgga_x_tpss", "mgga_c_tpss")


def mgga_inputs(nspin, seed):
    """rho, sigma, tau [nspin or 3, 64] with rho under 1e-14 (and 0),
    sigma = 0, tau = 0, alpha = 1 (unpolarised: tau = tau_W + tau_unif) and
    (polarised) zeta = +1 and -1 among the points."""
    rng = np.random.default_rng(seed)
    rho = rng.random((nspin, 64)) * 0.5 + 1e-3
    rho[:, :4] = 1e-16
    rho[:, 4] = 0.0
    sigma = rng.random((1 if nspin == 1 else 3, 64)) * 0.1
    sigma[:, 8:12] = 0.0
    tau = rng.random((nspin, 64)) * 0.5
    tau[:, 20:24] = 0.0
    if nspin == 1:
        r, s = rho[0, 24:28], sigma[0, 24:28]
        tau[0, 24:28] = s / (8 * r) + 0.3 * (3 * np.pi ** 2) ** (2 / 3) * r ** (5 / 3)
    else:
        rho[1, 12:16] = 0.0          # zeta = +1
        rho[0, 16:20] = 0.0          # zeta = -1
        sigma[1] = rng.normal(size=64) * 0.02
    return rho, sigma, tau


def entry_mgga_functionals():
    """SCAN, r2SCAN, TPSS-x and TPSS-c on mgga_inputs(nspin, 3 + nspin) for
    nspin 1 and 2: the inputs, each energy density and its jax.grad in rho,
    sigma and tau (the compile of these graphs takes most of a CPU test's
    budget, so the values are recorded)."""
    import jax
    import jax.numpy as jnp
    from dftk_tpu.ops.xc import functionals as xc
    out = {}
    for nspin in (1, 2):
        rho, sigma, tau = mgga_inputs(nspin, 3 + nspin)
        d = dict(rho=rho.tolist(), sigma=sigma.tolist(), tau=tau.tolist())
        for name in MGGA:
            f = xc.FUNCTIONALS[name].energy
            args = tuple(map(jnp.asarray, (rho, sigma, tau)))
            grads = jax.grad(lambda a, b, c: jnp.sum(f(a, b, c)), argnums=(0, 1, 2))(*args)
            d[name] = dict(energy=np.asarray(f(*args)).tolist(),
                           **{f"d_{k}": np.asarray(g).tolist()
                              for k, g in zip(("rho", "sigma", "tau"), grads)})
        out[str(nspin)] = d
    return out


if __name__ == "__main__":
    name = sys.argv[1]
    t0 = time.time()
    values = globals()["entry_" + name]()
    values["description"] = " ".join(globals()["entry_" + name].__doc__.split())
    values["cpu_seconds"] = time.time() - t0
    values["command"] = ("DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python "
                         f"tests/data/make_torch_port_mgga.py {name}")
    print(json.dumps({name: values}, default=float), flush=True)
