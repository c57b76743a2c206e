"""The JAX package's CPU float64 values that tests/data/torch_port_response.json
records for the port's solver and response checks.

    DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python tests/data/make_torch_port_response.py ENTRY

prints one JSON line: the entry's values, its `command` and its CPU
seconds (wall seconds of the run on the host).  Run from the repository
root.  The problems are the ones tests/test_torch_solvers.py,
tests/test_torch_response.py and `chip_smoke.py` phase m build in the port;
the cells' constructors (any package: `dftk` is `dftk_tpu` here, the port in
the tests, which pass device="cpu") and the seeded inputs
(`seeded_inputs`, `smooth_potential`, numpy only) are imported by the
tests and copied by `chip_smoke.py`.
This script imports the JAX package, so it lives outside both packages.
"""
import json
import sys
import time

import numpy as np

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
SI_POSITIONS = [np.ones(3) / 8, -np.ones(3) / 8]
A_AL = 7.65339
AL_LATTICE = A_AL / 2 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]])
HE_BOX = 10.0
N_OCC_SI2 = 4


def seeded_inputs(fft_size, mask, n_bands, seed=1):
    """The seeded perturbations of the operator checks: drho and dV [1,
    n1, n2, n3] (real), dpsi and noise [nk, n_bands, nG] (complex, zero on
    the padding of mask [nk, nG]; noise of norm ~1 a band)."""
    rng = np.random.default_rng(seed)
    grid = (1,) + tuple(int(n) for n in fft_size)
    drho = 1e-2 * rng.normal(size=grid)
    dV = 0.1 * rng.normal(size=grid)
    shape = (mask.shape[0], n_bands, mask.shape[1])
    dpsi, noise = ((rng.normal(size=shape) + 1j * rng.normal(size=shape)) * mask[:, None, :]
                   for _ in range(2))
    noise = noise / np.sqrt(2 * mask.sum(axis=-1))[:, None, None]
    return dict(drho=drho, dV=dV, dpsi=dpsi, noise=noise)


def orthonormal(psi):
    """The rows of each k block of psi [nk, nb, nG] orthonormalised (QR)."""
    out = np.empty_like(psi)
    for k in range(psi.shape[0]):
        out[k] = np.linalg.qr(psi[k].T)[0].T
    return out


def smooth_potential(fft_size):
    """The smooth zero-mean dV [1, n1, n2, n3] of tests/test_chi0_metal.py."""
    axes = [np.arange(n) / n for n in fft_size]
    r = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return 0.1 * (np.cos(2 * np.pi * r[..., 0]) + np.sin(2 * np.pi * r[..., 1])
                  + 0.5 * np.cos(2 * np.pi * (r[..., 1] + r[..., 2])))[None]


def as_complex(d):
    return np.array(d["re"]) + 1j * np.array(d["im"])


def _c(a):
    a = np.asarray(a)
    return dict(re=a.real.tolist(), im=a.imag.tolist())


def _state(res, n_bands=None):
    sl = slice(None) if n_bands is None else slice(0, n_bands)
    return dict(psi=_c(np.asarray(res.psi)[:, sl]),
                occupation=np.asarray(res.occupation)[:, sl].tolist(),
                eigenvalues=np.asarray(res.eigenvalues)[:, sl].tolist(),
                epsF=float(res.epsF), total_energy=res.total_energy,
                n_iter=res.n_iter, converged=bool(res.converged))


def si2_basis(dftk, model_fn=None, **kw):
    """tests/test_solvers.py::test_exact_chi0_mixing_converges's silicon:
    LDA (lda/si-q4), Ecut 5, Gamma, the default symmetries and FFT size."""
    Si = dftk.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model_fn = model_fn or (lambda *a: dftk.model_DFT(*a, functionals=["lda_x", "lda_c_vwn"]))
    return dftk.PlaneWaveBasis(model_fn(SI_LATTICE, [Si, Si], SI_POSITIONS), Ecut=5.0,
                               kgrid=(1, 1, 1), **kw)


def al_basis(dftk, Ecut, kgrid, symmetries, **kw):
    """tests/test_chi0_metal.py's aluminium (lda/al-q3, LDA, T = 0.01)."""
    Al = dftk.ElementPsp.from_symbol("Al", psp="lda/al-q3")
    model = dftk.model_DFT(AL_LATTICE, [Al], [np.zeros(3)], functionals=["lda_x", "lda_c_vwn"],
                           temperature=1e-2, symmetries=symmetries)
    return dftk.PlaneWaveBasis(model, Ecut=Ecut, kgrid=kgrid, **kw)


def helium_basis(dftk, **kw):
    """tests/test_response.py::_helium: He (lda/he-q2) in a 10 bohr box,
    LDA, Ecut 8, Gamma, no symmetry."""
    He = dftk.ElementPsp.from_symbol("He", psp="lda/he-q2")
    model = dftk.model_DFT(np.eye(3) * HE_BOX, [He], [np.array([0.5, 0.5, 0.5])],
                           functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    return dftk.PlaneWaveBasis(model, Ecut=8.0, kgrid=(1, 1, 1), **kw)


def entry_si2_gamma():
    """Gamma Si2 (the Chi0Mixing test's system): the density-mixing SCF to
    1e-11 (its state: psi, occupations, eigenvalues, epsF); on that state,
    with seeded_inputs(fft_size, mask, 4): apply_kernel at the SCF density
    along drho, apply_chi0 of dV at Sternheimer tol 1e-12, the full-cube
    product dV psi of apply_chi0, make_omega_plus_k's OmegaK(dpsi) on the
    4 occupied bands and solve_omega_plus_k with dpsi as the right-hand
    side (CG to 1e-10), and energy_from_orbitals (with the symmetrizer, as
    direct_minimization) and its jax.grad at psi_p = orthonormal(psi_occ +
    0.1 noise); newton (tol 1e-10) and direct_minimization (tol 1e-11) from
    psi_0 = orthonormal(psi_occ + 0.05 noise); scf_potential_mixing to 1e-9
    and the Chi0Mixing SCF to 1e-9 (maxiter 40) from their own starts."""
    import jax
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops import fft as fftops
    from dftk_tpu.ops.density import make_symmetrizer
    from dftk_tpu.response.chi0 import apply_chi0, make_chi0_context
    from dftk_tpu.response.hessian import apply_kernel, make_omega_plus_k, solve_omega_plus_k
    from dftk_tpu.scf.direct import direct_minimization, energy_from_orbitals
    from dftk_tpu.scf.newton import newton
    from dftk_tpu.scf.potential_mixing import scf_potential_mixing
    basis = si2_basis(dftk)
    res = dftk.self_consistent_field(basis, tol=1e-11, maxiter=60)
    out = dict(fft_size=list(basis.fft_size), state=_state(res))
    bd = basis.data
    inp = seeded_inputs(basis.fft_size, np.asarray(bd.mask), N_OCC_SI2)
    out["apply_kernel"] = np.asarray(
        apply_kernel(basis, res.rho, jnp.asarray(inp["drho"]))).tolist()
    ctx = make_chi0_context(res)
    out["chi0"] = np.asarray(apply_chi0(ctx, basis, jnp.asarray(inp["dV"]), tol=1e-12)).tolist()
    cube = jax.vmap(lambda c, i, m: fftops.scatter_to_cube(c, i, m, basis.fft_size))(
        ctx.psi, bd.Gidx, bd.mask)
    psir = jnp.fft.ifftn(cube, axes=(-3, -2, -1))
    out["dV_psi"] = _c(jax.vmap(fftops.gather_from_cube)(
        jnp.fft.fftn(jnp.asarray(inp["dV"])[bd.kspin][:, None] * psir, axes=(-3, -2, -1)),
        bd.Gidx, bd.mask))
    psi = np.asarray(res.psi)[:, :N_OCC_SI2]
    occ = np.asarray(res.occupation)[:, :N_OCC_SI2]
    OmegaK, _, _ = make_omega_plus_k(basis, psi, occ)
    out["omega_plus_k"] = _c(OmegaK(jnp.asarray(inp["dpsi"])))
    out["solve_omega_plus_k"] = _c(solve_omega_plus_k(basis, psi, occ, jnp.asarray(inp["dpsi"]),
                                                      cg_tol=1e-10))
    psi_p = orthonormal(psi + 0.1 * inp["noise"])
    sym = make_symmetrizer(basis)
    E, g = jax.value_and_grad(lambda p: energy_from_orbitals(basis, p, jnp.asarray(occ), sym)[0])(
        jnp.asarray(psi_p))
    out["energy_from_orbitals"] = dict(energy=float(E), jax_grad=_c(g))
    psi_0 = orthonormal(psi + 0.05 * inp["noise"])
    for name, run in (("newton", lambda: newton(basis, tol=1e-10, psi=jnp.asarray(psi_0))),
                      ("direct_minimization", lambda: direct_minimization(
                          basis, tol=1e-11, psi=jnp.asarray(psi_0))),
                      ("potential_mixing", lambda: scf_potential_mixing(basis, tol=1e-9)),
                      ("chi0_mixing", lambda: dftk.self_consistent_field(
                          basis, tol=1e-9, maxiter=40, mixing=dftk.Chi0Mixing()))):
        r = run()
        out[name] = dict(total_energy=r.total_energy, n_iter=r.n_iter,
                         converged=bool(r.converged))
    return out


def entry_al_small():
    """A small metal: aluminium at Ecut 5 on MonkhorstPack (2, 2, 2) with
    the default symmetries (its irreducible k-points), T = 0.01: the SCF
    to 1e-11 with 6 + 2 bands (its state), and apply_chi0 of
    smooth_potential at Sternheimer tol 1e-12 (the Schur complement on);
    the same with the balanced band tolerances of density_tol 1e-7; and
    apply_chi0_generic of its dV psi (the full-cube product of apply_chi0)
    at tol 1e-12 with_detail: dpsi, df and depsF."""
    import jax
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops import fft as fftops
    from dftk_tpu.response.chi0 import apply_chi0, apply_chi0_generic, make_chi0_context
    basis = al_basis(dftk, 5.0, dftk.MonkhorstPack((2, 2, 2)), True)
    res = dftk.self_consistent_field(basis, tol=1e-11, maxiter=60, n_bands=6, n_extra_bands=2)
    ctx = make_chi0_context(res)
    dV = jnp.asarray(smooth_potential(basis.fft_size))
    drho = apply_chi0(ctx, basis, dV, tol=1e-12)
    drho_balanced = apply_chi0(ctx, basis, dV, tol=1e-12, density_tol=1e-7)
    bd = basis.data
    cube = jax.vmap(lambda c, i, m: fftops.scatter_to_cube(c, i, m, basis.fft_size))(
        ctx.psi, bd.Gidx, bd.mask)
    dVpsi = jax.vmap(fftops.gather_from_cube)(
        jnp.fft.fftn(dV[bd.kspin][:, None] * jnp.fft.ifftn(cube, axes=(-3, -2, -1)),
                     axes=(-3, -2, -1)), bd.Gidx, bd.mask)
    _, dpsi, df, depsF = apply_chi0_generic(ctx, basis, dVpsi, tol=1e-12, with_detail=True)
    return dict(fft_size=list(basis.fft_size), n_kpoints=basis.n_kpoints, state=_state(res),
                chi0=np.asarray(drho).tolist(), chi0_balanced=np.asarray(drho_balanced).tolist(),
                detail=dict(dpsi=_c(dpsi), df=np.asarray(df).tolist(), depsF=float(depsF)))


def entry_al_chi0():
    """tests/test_chi0_metal.py's aluminium (Ecut 6, kgrid 3^3, no
    symmetry, T = 0.01, 8 + 4 bands, the SCF to 1e-11): apply_chi0 of
    smooth_potential at Sternheimer tol 1e-11, with and without the Schur
    complement."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.response.chi0 import apply_chi0, make_chi0_context
    basis = al_basis(dftk, 6.0, (3, 3, 3), False)
    res = dftk.self_consistent_field(basis, tol=1e-11, maxiter=60, n_bands=8, n_extra_bands=4)
    ctx = make_chi0_context(res, basis)
    dV = jnp.asarray(smooth_potential(basis.fft_size))
    return dict(fft_size=list(basis.fft_size), total_energy=res.total_energy,
                **{f"chi0_{k}": np.asarray(apply_chi0(ctx, basis, dV, tol=1e-11,
                                                      use_schur=s)).tolist()
                   for k, s in (("schur", True), ("plain", False))})


def entry_helium():
    """tests/test_response.py::_helium: the SCF to 1e-11 and
    compute_polarizability along z at a Dyson tolerance of 1e-9."""
    import dftk_tpu as dftk
    from dftk_tpu.response.hessian import compute_polarizability
    basis = helium_basis(dftk)
    res = dftk.self_consistent_field(basis, tol=1e-11, maxiter=60)
    return dict(fft_size=list(basis.fft_size), total_energy=res.total_energy,
                polarizability=compute_polarizability(res, direction=2, tol=1e-9))


def entry_si2_atomic():
    """tests/test_jacobian_eigen.py's atomic Si2 (model_atomic, Ecut 5,
    Gamma; the SCF to 1e-8 with 6 bands): the HOMO-LUMO gap and the three
    lowest eigenvalues of the bare Omega (eigen_omega_plus_k, include_K
    False, tol 1e-8) on the 4 occupied bands."""
    import dftk_tpu as dftk
    from dftk_tpu.response.hessian import eigen_omega_plus_k
    basis = si2_basis(dftk, model_fn=dftk.model_atomic)
    res = dftk.self_consistent_field(basis, tol=1e-8, n_bands=6)
    lam, _ = eigen_omega_plus_k(basis, np.asarray(res.psi)[:, :4],
                                np.asarray(res.occupation)[:, :4], n_eigs=3, include_K=False,
                                tol=1e-8)
    return dict(fft_size=list(basis.fft_size), total_energy=res.total_energy,
                gap=float(res.eigenvalues[0, 4] - res.eigenvalues[0, 3]),
                omega_eigenvalues=np.asarray(lam).tolist())


def entry_si8_potential_mixing():
    """Si8 (the conventional cubic cell, Gamma, Ecut 10, LDA, no symmetry;
    dftk_tpu_torch/tools/solver_floor.py runs the port on it): the
    density-mixing SCF to 1e-10 and scf_potential_mixing (tol 1e-9, 80
    iterations) with its residual history."""
    import dftk_tpu as dftk
    from dftk_tpu.scf.potential_mixing import scf_potential_mixing
    Si = dftk.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    base = [np.zeros(3), np.array([0, 0.5, 0.5]), np.array([0.5, 0, 0.5]),
            np.array([0.5, 0.5, 0])]
    model = dftk.model_DFT(np.eye(3) * 2 * A_SI, [Si] * 8, base + [b + 0.25 for b in base],
                           functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    basis = dftk.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1))
    ref = dftk.self_consistent_field(basis, tol=1e-10)
    history = []
    res = scf_potential_mixing(basis, tol=1e-9, maxiter=80,
                               callback=lambda i: history.append(i["dV"]))
    return dict(fft_size=list(basis.fft_size), scf_total_energy=ref.total_energy,
                total_energy=res.total_energy, converged=bool(res.converged),
                n_iter=res.n_iter, residuals=history)


def entry_si54_potential_mixing():
    """Si54 (dftk_tpu_torch/tools/run_si_big.py::build_bench_basis: 3^3 fcc
    primitive cells, Gamma, Ecut 10, LDA, no symmetry): the JAX package's
    scf_potential_mixing (tol 1e-9, 80 iterations) from the port's start,
    the orbitals dftk_tpu_torch.scf.driver.random_orbitals draws on the CPU
    from seed 42 (118 bands), which `python -m
    dftk_tpu_torch.tools.solver_floor --cell si54 --device cpu --only
    potential --iters 80 --seeds 42` starts from; its energy and residual
    history.  Each iteration is printed to stderr as it ends."""
    import jax.numpy as jnp
    import torch
    import dftk_tpu as dftk
    import dftk_tpu.scf.potential_mixing as pm
    from dftk_tpu_torch.scf.driver import random_orbitals
    from dftk_tpu_torch.tools.run_si_big import build_bench_basis
    torch.set_num_threads(1)
    port_basis = build_bench_basis(3, 10.0, "cpu")
    pm_ = port_basis.model
    Si = dftk.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dftk.model_DFT(pm_.lattice, [Si] * len(pm_.positions), list(pm_.positions),
                           functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    basis = dftk.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1))
    assert tuple(basis.fft_size) == tuple(port_basis.fft_size)
    assert np.array_equal(np.asarray(basis.data.Gidx), port_basis.Gidx_np)
    n_bands = model.default_n_bands()
    psi0 = random_orbitals(port_basis, n_bands + max(3, n_bands // 10), seed=42).numpy()
    pm.random_orbitals = lambda b, n, seed=42: jnp.asarray(psi0[:, :n])
    history, energies = [], []
    t0 = time.time()

    def callback(info):
        history.append(info["dV"])
        energies.append(info["E"])
        print(f"it={info['n_iter']:3d} E={info['E']:.12f} dV={info['dV']:.3e} "
              f"alpha={info['alpha']:.3f} t={time.time() - t0:.1f}s", file=sys.stderr,
              flush=True)

    res = pm.scf_potential_mixing(basis, tol=1e-9, maxiter=80, callback=callback)
    return dict(fft_size=list(basis.fft_size), n_bands=int(psi0.shape[1]),
                total_energy=res.total_energy, converged=bool(res.converged),
                n_iter=res.n_iter, energies=energies, residuals=history)


if __name__ == "__main__":
    name = sys.argv[1]
    t0 = time.time()
    values = globals()["entry_" + name]()
    values["description"] = " ".join(globals()["entry_" + name].__doc__.split())
    values["cpu_seconds"] = time.time() - t0
    values["command"] = ("DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python "
                         f"tests/data/make_torch_port_response.py {name}")
    print(json.dumps({name: values}, default=float), flush=True)
