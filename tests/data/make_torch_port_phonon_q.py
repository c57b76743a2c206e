"""The JAX package's CPU float64 values that tests/data/torch_port_phonon_q.json
records for the port's checks of phonons at q, the supercell force
constants, the q-path tables and the split-engine response adapters.

    PYTHONPATH=. DFTK_TPU_X64=1 JAX_PLATFORMS=cpu \
        python tests/data/make_torch_port_phonon_q.py ENTRY

prints one JSON line: the entry's values, its `command` and its CPU
seconds (wall seconds of the run on the host).  Run from the repository
root.  Arrays are stored as base64 of their little-endian bytes
(`from_b64` reads them back).  The cells are the ones of
tests/test_phonon_q.py, tests/test_chi0_split.py and
tests/test_phonon_split.py, built by the constructors of
tests/data/make_torch_port_phonon.py (any package: `dftk` is `dftk_tpu`
here, the port in the tests, which pass device="cpu"); `chip_smoke.py`
phase o copies them.  This script imports the JAX package, so it lives
outside both packages.
"""
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "make_phonon", pathlib.Path(__file__).parent / "make_torch_port_phonon.py")
make_phonon = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make_phonon)
b64, from_b64, si2_model = make_phonon.b64, make_phonon.from_b64, make_phonon.si2_model
SI_LATTICE, SI_POSITIONS = make_phonon.SI_LATTICE, make_phonon.SI_POSITIONS
AL_LATTICE = make_phonon.AL_LATTICE

Q_X = [0.5, 0.0, 0.0]
# tests/test_phonon_q.py's DFPT tolerances, and looser ones for the CPU
# tests (the packages are compared on one state, not the converged response)
DFPT_TOLS = dict(tol=1e-8, sternheimer_tol=1e-11)
CPU_Q_TOLS = dict(tol=1e-1, sternheimer_tol=1e-2)
# the k+q Sternheimer solve's tolerance; the smeared cell's partially
# occupied bands stall above 1e-6 until maxiter (200 CG steps) in both
# packages, so its CPU check stops at 1e-4
STERNHEIMER_Q_TOL = 1e-9
SMEARED_STERNHEIMER_Q_TOL = 1e-4
# the unfolded k rows whose q-operator values are recorded (X: row 0 has
# G0 = (1, 0, 0), row 3 none); the bare dH_q psi only on row 0
Q_ROWS = [0, 3]
# tests/test_phonon_q.py's si_fc fixture
SI_FC = dict(Ecut=4.0, supercell_size=(2, 1, 1), scf_kwargs=dict(tol=1e-9), delta=3e-2)
FC_QS = [[0, 0, 0], [0.5, 0, 0], [0.3, 0.1, 0.2], [-0.3, -0.1, -0.2]]
BAND_KLINE_DENSITY = 5
# the Bravais classes whose default q-path irrfbz_path lays out
BRAVAIS_LATTICES = {
    "fcc": SI_LATTICE,
    "hexagonal": make_phonon.MG_LATTICE,
    "cubic": 5.0 * np.eye(3),
    "bcc": 2.7 * np.array([[-1.0, 1, 1], [1, -1, 1], [1, 1, -1]]),
    "tet": np.diag([4.0, 4.0, 6.0]),
    "orc": np.diag([4.0, 5.0, 6.0]),
    "tri": np.array([[4.0, 0.3, 0.2], [0.1, 5.0, 0.4], [0.5, 0.2, 6.0]]),
}


def si2_q_basis(dftk, temperature=0.0, **kw):
    """tests/test_phonon_q.py's `_si_scf(Ecut=4.0)`: silicon (lda/si-q4,
    LDA) at Ecut 4 on kgrid 2^3 with the default symmetries and FFT size;
    T = 0.01 is the smeared (metallic) case."""
    return dftk.PlaneWaveBasis(si2_model(dftk, temperature=temperature), Ecut=4.0,
                               kgrid=(2, 2, 2), **kw)


def si2_split_basis(dftk, **kw):
    """tests/test_chi0_split.py's silicon: Ecut 6, kgrid 2^3, fft 16, the
    default symmetries."""
    return dftk.PlaneWaveBasis(si2_model(dftk), Ecut=6.0, kgrid=(2, 2, 2),
                               fft_size=(16, 16, 16), **kw)


def si2_split_dfpt_basis(dftk, **kw):
    """tests/test_phonon_split.py's silicon: Ecut 5, kgrid 2^3, the default
    symmetries and FFT size."""
    return dftk.PlaneWaveBasis(si2_model(dftk), Ecut=5.0, kgrid=(2, 2, 2), **kw)


def al_small_basis(dftk, **kw):
    """tests/data/make_torch_port_response.py's small metal: fcc aluminium
    (lda/al-q3, LDA, T = 0.01) at Ecut 5 on MonkhorstPack (2, 2, 2) with the
    default symmetries (its irreducible k-points); SCF with 6 + 2 bands."""
    Al = dftk.ElementPsp.from_symbol("Al", psp="lda/al-q3")
    model = dftk.model_DFT(AL_LATTICE, [Al], [np.zeros(3)], functionals=["lda_x", "lda_c_vwn"],
                           temperature=1e-2)
    return dftk.PlaneWaveBasis(model, Ecut=5.0, kgrid=dftk.MonkhorstPack((2, 2, 2)), **kw)


def split_dV(fft_size, amplitude=0.1):
    """tests/test_chi0_split.py's dV [1, n1, n2, n3]."""
    axes = [np.arange(n) / n for n in fft_size]
    r = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    return amplitude * (np.cos(2 * np.pi * r[..., 0])
                        + np.sin(2 * np.pi * (r[..., 1] + r[..., 2])))[None]


def seeded_q_inputs(fft_size, mask_q, n_bands, seed=3):
    """The seeded inputs of the q-operator checks: drho_q and dv_q [1, n1,
    n2, n3] complex, and dpsi [nk, n_bands, nG] complex on the k+q spheres
    (zero on the padding of mask_q [nk, nG], the mask of each row's k+q
    partner)."""
    rng = np.random.default_rng(seed)
    grid = (1,) + tuple(int(n) for n in fft_size)
    drho = 1e-2 * (rng.normal(size=grid) + 1j * rng.normal(size=grid))
    dv = 0.1 * (rng.normal(size=grid) + 1j * rng.normal(size=grid))
    shape = (mask_q.shape[0], n_bands, mask_q.shape[1])
    dpsi = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * mask_q[:, None, :]
    return dict(drho=drho, dv=dv, dpsi=dpsi)


def _state(res):
    return dict(psi=b64(np.asarray(res.psi)), occupation=b64(np.asarray(res.occupation)),
                eigenvalues=b64(np.asarray(res.eigenvalues)), epsF=float(res.epsF),
                rho=b64(np.asarray(res.rho)), total_energy=res.total_energy,
                n_iter=res.n_iter, converged=bool(res.converged))


def _q_operators(res, q, sternheimer_tol=STERNHEIMER_Q_TOL):
    """On the unfolded result: kpq_maps, and with seeded_q_inputs the
    kernel at q, dV_q psi (rows Q_ROWS), drho_q of dpsi, the bare dH_q psi
    of the six displacements (row 0) and one k+q Sternheimer solve of the
    first of them at sternheimer_tol (rows Q_ROWS)."""
    import jax.numpy as jnp
    from dftk_tpu.postprocess.unfold import unfold_bz
    from dftk_tpu.response import phonon_q as pq
    from dftk_tpu.response.chi0 import make_chi0_context
    u = unfold_bz(res)
    bu = u.basis
    qctx = pq.QContext(bu, q)
    ctx = make_chi0_context(u, bu)
    mask = np.asarray(bu.data.mask)
    inp = seeded_q_inputs(bu.fft_size, mask[qctx.perm], ctx.psi.shape[1])
    rhs = pq._bare_rhs_q(bu, ctx, qctx, pq._dvloc_q_grids(bu, q))
    return dict(
        perm=qctx.perm.tolist(), G0=qctx.G0.tolist(), is_gamma=bool(qctx.is_gamma),
        kernel_q=b64(np.asarray(pq.apply_kernel_q(bu, jnp.asarray(u.rho),
                                                  jnp.asarray(inp["drho"]), q))),
        dv_times_psi_q=b64(np.asarray(pq.dv_times_psi_q(ctx, bu, qctx,
                                                        jnp.asarray(inp["dv"])))[Q_ROWS]),
        drho_q=b64(np.asarray(pq.drho_q_from_dpsi(ctx, bu, qctx, jnp.asarray(inp["dpsi"])))),
        bare_rhs_q=b64(np.stack([np.asarray(r)[0] for r in rhs])),
        sternheimer_tol=sternheimer_tol,
        sternheimer_q=b64(np.asarray(pq.sternheimer_q(ctx, bu, qctx, rhs[0],
                                                      tol=sternheimer_tol))[Q_ROWS]))


def entry_si2_q():
    """tests/test_phonon_q.py's silicon (si2_q_basis, T = 0): the SCF to
    1e-12 (its IBZ state); on its unfolding at X (_q_operators); and
    dynmat_dfpt_q at X and at 0 (CPU_Q_TOLS)."""
    import dftk_tpu as dftk
    from dftk_tpu.response.phonon_q import dynmat_dfpt_q
    basis = si2_q_basis(dftk)
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=60)
    out = dict(fft_size=list(basis.fft_size), state=_state(res), **_q_operators(res, Q_X))
    out["dynmat_X"] = b64(dynmat_dfpt_q(res, Q_X, **CPU_Q_TOLS))
    out["dynmat_0"] = b64(dynmat_dfpt_q(res, [0, 0, 0], **CPU_Q_TOLS))
    return out


def entry_si2_q_smeared():
    """The smeared silicon (si2_q_basis at T = 0.01, the metallic branch of
    sternheimer_q): the SCF to 1e-12 (its IBZ state) and, on its unfolding
    at X, the k+q Sternheimer solve of _q_operators (rows Q_ROWS) at
    SMEARED_STERNHEIMER_Q_TOL."""
    import dftk_tpu as dftk
    basis = si2_q_basis(dftk, temperature=0.01)
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=60)
    ops = _q_operators(res, Q_X, SMEARED_STERNHEIMER_Q_TOL)
    return dict(fft_size=list(basis.fft_size), state=_state(res), perm=ops["perm"],
                **{k: ops[k] for k in ("sternheimer_tol", "sternheimer_q")})


def entry_si2_q_converged():
    """chip_smoke.py phase o3's reference: si2_q_basis (T = 0), the SCF to
    1e-12, dynmat_dfpt_q at X at tests/test_phonon_q.py's tolerances
    (DFPT_TOLS) and its frequencies (phonon_modes_dfpt_q's
    mass-weighting)."""
    import dftk_tpu as dftk
    from dftk_tpu.response.phonon_q import dynmat_dfpt_q
    basis = si2_q_basis(dftk)
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=60)
    t0 = time.time()
    D = dynmat_dfpt_q(res, Q_X, **DFPT_TOLS)
    return dict(fft_size=list(basis.fft_size), total_energy=res.total_energy,
                dynmat_X=b64(D), dfpt_seconds=time.time() - t0)


def entry_ewald_q():
    """dynmat_ewald_q (host numpy in both packages) of tests/test_phonon_q.py's
    Ewald supercell-fold cell (a 5.13, Z 4) and of SI_LATTICE's silicon at X
    and at (0.25, 0.1, -0.3), and the fold itself (jax.hessian of the
    supercell's energy_ewald, Cartesian, the e^{iqR} sum at X)."""
    import jax
    import jax.numpy as jnp
    from dftk_tpu.ops.ewald import energy_ewald
    from dftk_tpu.response.phonon_q import dynmat_ewald_q
    a = 5.13
    L = np.array([[0, a, a], [a, 0, a], [a, a, 0]], dtype=float)
    pos = np.array([[0.125, 0.125, 0.125], [-0.125, -0.125, -0.125]])
    Z = np.array([4.0, 4.0])
    S = np.diag([2, 1, 1]).astype(float)
    Ls = L @ S
    pos_s = np.array([np.linalg.solve(S, p + np.array([c, 0, 0])) for c in range(2) for p in pos])
    H = np.asarray(jax.hessian(lambda p: energy_ewald(Ls, np.array([4.0] * 4), p))(
        jnp.asarray(pos_s)))
    Linv_s = np.linalg.inv(Ls)
    Hc = np.einsum("aA,satb,bB->sAtB", Linv_s, H, Linv_s)
    out = dict(fold_X=b64(Hc[:2, :, :2, :] - Hc[:2, :, 2:, :]))
    for name, (lat, p) in dict(fold_cell=(L, pos),
                               silicon=(SI_LATTICE, np.stack(SI_POSITIONS))).items():
        for qname, q in dict(X=Q_X, generic=[0.25, 0.1, -0.3]).items():
            out[f"{name}_{qname}"] = b64(dynmat_ewald_q(lat, Z, p, q))
    return out


def entry_si_fc():
    """tests/test_phonon_q.py's si_fc fixture (SI_FC: silicon, Ecut 4, the
    (2, 1, 1) supercell on Gamma, SCFs to 1e-9, delta 3e-2): Phi and its
    geometry; dynmat_q and phonon_modes_q at FC_QS; phonon_band_structure
    (kline_density BAND_KLINE_DENSITY): its q-path and frequencies."""
    import dftk_tpu as dftk
    from dftk_tpu.postprocess.phonon import (compute_force_constants, dynmat_q,
                                             phonon_band_structure, phonon_modes_q)
    fc = compute_force_constants(si2_model(dftk), **SI_FC)
    bs = phonon_band_structure(fc, kline_density=BAND_KLINE_DENSITY)
    return dict(Phi=b64(fc.Phi), offsets=fc.offsets.tolist(), supercell=list(fc.supercell),
                dynmat_q=[b64(dynmat_q(fc, q)) for q in FC_QS],
                frequencies_q=[phonon_modes_q(fc, q)[0].tolist() for q in FC_QS],
                band_qpath=b64(bs["qpath"].kcoords),
                band_labels={str(k): v for k, v in bs["qpath"].labels.items()},
                band_kdistances=b64(bs["qpath"].kdistances),
                band_frequencies=b64(bs["frequencies"]))


def entry_bravais():
    """detect_bravais and irrfbz_path (kline_density 10) of BRAVAIS_LATTICES."""
    from dftk_tpu.postprocess.bands import detect_bravais, irrfbz_path
    out = {}
    for name, lat in BRAVAIS_LATTICES.items():
        p = irrfbz_path(lat, kline_density=10)
        out[name] = dict(lattice=np.asarray(lat).tolist(), bravais=detect_bravais(lat),
                         kcoords=b64(p.kcoords), kdistances=b64(p.kdistances),
                         labels={str(k): v for k, v in p.labels.items()})
    return out


def _split_res(res):
    """tests/test_chi0_split.py's _split_res in float64: the csplit rows
    [x; y] of the SCF's orbitals with its occupations, eigenvalues, rho and
    epsF."""
    psi = np.asarray(res.psi)
    return dict(U=np.concatenate([psi.real, psi.imag], axis=-1),
                occupation=np.asarray(res.occupation),
                eigenvalues=np.asarray(res.eigenvalues), rho=np.asarray(res.rho),
                epsF=float(res.epsF))


def entry_chi0_split():
    """tests/test_chi0_split.py's silicon (si2_split_basis, the SCF to
    1e-12) in float64: its state; with split_dV, apply_chi0_split_ctx (tol
    1e-11), solve_dyson_split (tol 1e-9, Sternheimer 1e-11) and
    apply_kernel_split along 1e-2 * split_dV."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops.engine_split import prepare_split_data
    from dftk_tpu.response.chi0_split import (apply_chi0_split_ctx, apply_kernel_split,
                                              make_chi0_split_context, solve_dyson_split)
    basis = si2_split_basis(dftk)
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=60)
    dV = jnp.asarray(split_dV(basis.fft_size))
    sd = prepare_split_data(basis, dtype=jnp.float64)
    ctx = make_chi0_split_context(basis, sd, _split_res(res))
    drho_dyson, dV_tot = solve_dyson_split(basis, ctx, dV, res.rho, tol=1e-9,
                                           sternheimer_tol=1e-11)
    return dict(fft_size=list(basis.fft_size), state=_state(res),
                chi0=b64(np.asarray(apply_chi0_split_ctx(basis, ctx, dV, tol=1e-11))),
                dyson_drho=b64(np.asarray(drho_dyson)), dyson_dV=b64(np.asarray(dV_tot)),
                kernel=b64(np.asarray(apply_kernel_split(basis, sd, jnp.asarray(res.rho),
                                                         1e-2 * dV))))


def entry_chi0_split_metal():
    """The metallic branch of apply_chi0_split_ctx (tests/test_chi0_split.py
    runs it on a larger aluminium): al_small_basis, the SCF to 1e-11
    (maxiter 60, 6 + 2 bands) in float64, its state; with
    split_dV(amplitude 0.05), apply_chi0_split_ctx (tol 1e-11,
    with_detail: drho, df, depsF)."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops.engine_split import prepare_split_data
    from dftk_tpu.response.chi0_split import apply_chi0_split_ctx, make_chi0_split_context
    basis = al_small_basis(dftk)
    res = dftk.self_consistent_field(basis, tol=1e-11, maxiter=60, n_bands=6, n_extra_bands=2)
    dV = jnp.asarray(split_dV(basis.fft_size, 0.05))
    sd = prepare_split_data(basis, dtype=jnp.float64)
    ctx = make_chi0_split_context(basis, sd, _split_res(res))
    drho, _, df, depsF = apply_chi0_split_ctx(basis, ctx, dV, tol=1e-11, with_detail=True)
    return dict(fft_size=list(basis.fft_size), state=_state(res), chi0=b64(np.asarray(drho)),
                df=b64(np.asarray(df)), depsF=float(depsF))


def entry_phonon_split():
    """tests/test_phonon_split.py's silicon (si2_split_dfpt_basis, the SCF
    to 1e-12): its IBZ state, and dynmat_dfpt_gamma_split on its unfolding
    (tol 1e-8, Sternheimer 1e-11)."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops.engine_split import prepare_split_data
    from dftk_tpu.postprocess.unfold import unfold_bz
    from dftk_tpu.response.phonon_split import dynmat_dfpt_gamma_split
    basis = si2_split_dfpt_basis(dftk)
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=60)
    u = unfold_bz(res)
    sd = prepare_split_data(u.basis, dtype=jnp.float64)
    C = dynmat_dfpt_gamma_split(u.basis, sd, _split_res(u), tol=1e-8, sternheimer_tol=1e-11)
    return dict(fft_size=list(basis.fft_size), state=_state(res), dynmat=b64(C))


def entry_force_data():
    """prepare_force_data in float64 of make_phonon's Gamma silicon
    (si2_gamma_basis) and UPF diamond (c2_upf_basis: NLCC core form
    factors): every field (the integer G arrays as int8)."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops.forces_split import prepare_force_data
    out = {}
    for name, basis in (("si2", make_phonon.si2_gamma_basis(dftk)),
                        ("c2_upf", make_phonon.c2_upf_basis(dftk))):
        fd = prepare_force_data(basis, dtype=jnp.float64)
        out[name] = {k: ([b64(np.asarray(a)) for a in v] if k.startswith(("ff_", "D_"))
                         else [list(g) for g in v] if k.endswith("_groups")
                         else b64(np.asarray(v).astype(np.int8)) if k.startswith("G")
                         else b64(np.asarray(v)))
                     for k, v in fd._asdict().items()}
    return out


if __name__ == "__main__":
    name = sys.argv[1]
    t0 = time.time()
    values = globals()["entry_" + name]()
    values["description"] = " ".join(globals()["entry_" + name].__doc__.split())
    values["cpu_seconds"] = time.time() - t0
    values["command"] = ("PYTHONPATH=. DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python "
                         f"tests/data/make_torch_port_phonon_q.py {name}")
    print(json.dumps({name: values}, default=float), flush=True)
