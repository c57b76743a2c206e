"""The JAX package's CPU float64 values that tests/data/torch_port_phonon.json
records for the port's Gamma phonon, elastic-response and unfolding checks.

    PYTHONPATH=. DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python tests/data/make_torch_port_phonon.py ENTRY

prints one JSON line: the entry's values, its `command` and its CPU
seconds (wall seconds of the run on the host).  Run from the repository
root.  Arrays are stored as base64 of their little-endian bytes
(`from_b64` reads them back).  The problems are the ones
tests/test_torch_phonon.py, tests/test_torch_elastic.py and
`chip_smoke.py` phase n build in the port; the cells' constructors (any
package: `dftk` is `dftk_tpu` here, the port in the tests, which pass
device="cpu") are imported by the tests and copied by `chip_smoke.py`.
This script imports the JAX package, so it lives outside both packages.
"""
import base64
import json
import pathlib
import sys
import time

import numpy as np

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
SI_POSITIONS = [np.ones(3) / 8, -np.ones(3) / 8]
MG_LATTICE = np.array([[-3.0179389206, -3.0179389206, 0.0],
                       [-5.2272235447, 5.2272235447, 0.0],
                       [0.0, 0.0, -9.7736219469]]).T
MG_POSITIONS = [np.array([2 / 3, 1 / 3, 1 / 4]), np.array([1 / 3, 2 / 3, 3 / 4])]
AL_LATTICE = 7.65339 / 2 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]])
C_LATTICE = 6.74 / 2 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]])
C_UPF = str(pathlib.Path(__file__).parent / "pseudos" / "C_m.upf")
N_OCC_SI2 = 4
R_A_ROWS = [0, 3, 7]        # the unfolded k rows whose strained jvps are recorded
# the Gamma Si2's DFPT tolerances (the reference test's are 1e-7 and
# 1e-10) and the smeared Si2's elastic ones: the packages are compared, not
# the converged response, and looser solves keep the CPU tests in budget
GAMMA_DFPT_TOLS = dict(tol=1e-5, sternheimer_tol=1e-7)
SMEARED_ELASTIC_TOLS = dict(dyson_tol=1e-5, sternheimer_tol=1e-7)


def b64(a):
    a = np.ascontiguousarray(a)
    return dict(dtype=a.dtype.str, shape=list(a.shape),
                data=base64.b64encode(a.tobytes()).decode("ascii"))


def from_b64(d):
    return np.frombuffer(base64.b64decode(d["data"]), dtype=np.dtype(d["dtype"])).reshape(
        d["shape"])


def si2_model(dftk, positions=None, **kw):
    """Silicon (lda/si-q4, LDA) at the fcc lattice of tests/testcases.py."""
    Si = dftk.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    return dftk.model_DFT(SI_LATTICE, [Si, Si], positions or SI_POSITIONS,
                          functionals=["lda_x", "lda_c_vwn"], **kw)


def si2_gamma_basis(dftk, temperature=0.0, **kw):
    """tests/test_dfpt_phonon.py's Gamma silicon at Ecut 4 (the reference's
    5, cut for the CPU tests' budget), Gamma, the default symmetries and
    FFT size; T = 0.01 is the smeared (metallic) case."""
    return dftk.PlaneWaveBasis(si2_model(dftk, temperature=temperature), Ecut=4.0,
                               kgrid=(1, 1, 1), **kw)


def si2_kgrid_basis(dftk, Ecut=6.0, kgrid=(2, 2, 2), fft_size=(16, 16, 16), positions=None,
                    lattice=None, **kw):
    """tests/test_elastic_resp.py's silicon: Ecut 6, kgrid 2^3, fft 16, the
    default symmetries (an IBZ of 3 k-points); fft_size None takes the
    default size (tests/test_dfpt_phonon.py's FD check)."""
    model = si2_model(dftk, positions)
    if lattice is not None:
        model = dftk.model_DFT(lattice, model.atoms, model.positions,
                               functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    return dftk.PlaneWaveBasis(model, Ecut=Ecut, kgrid=kgrid, fft_size=fft_size, **kw)


def mg_basis(dftk, positions=None, **kw):
    """tests/test_dfpt_phonon.py's metallic check: hcp magnesium (lda/mg-q2,
    LDA, T = 0.01), Ecut 5, kgrid 2^3; SCF with 6 + 4 bands."""
    Mg = dftk.ElementPsp.from_symbol("Mg", psp="lda/mg-q2")
    model = dftk.model_DFT(MG_LATTICE, [Mg, Mg], positions or MG_POSITIONS,
                           functionals=["lda_x", "lda_c_vwn"], temperature=0.01)
    return dftk.PlaneWaveBasis(model, Ecut=5.0, kgrid=(2, 2, 2), **kw)


def al_basis(dftk, lattice=AL_LATTICE, **kw):
    """tests/test_elastic_resp.py's metallic check: fcc aluminium (lda/al-q3,
    LDA, T = 0.01, no symmetry), Ecut 6, kgrid 3^3, fft 15; SCF with 6 + 4
    bands."""
    Al = dftk.ElementPsp.from_symbol("Al", psp="lda/al-q3")
    model = dftk.model_DFT(lattice, [Al], [np.zeros(3)], functionals=["lda_x", "lda_c_vwn"],
                           temperature=1e-2, symmetries=False)
    return dftk.PlaneWaveBasis(model, Ecut=6.0, kgrid=(3, 3, 3), fft_size=(15, 15, 15), **kw)


def c2_upf_basis(dftk, **kw):
    """Diamond C2 from the ONCVPSP file C_m.upf (numerical form factors,
    NLCC) under LDA, at tests/torch_port_cells.py's lattice, Ecut 7 (its
    10, cut for the CPU tests' budget), Gamma, the default symmetries and
    FFT size."""
    C = dftk.ElementPsp.from_symbol("C", psp=C_UPF)
    model = dftk.model_DFT(C_LATTICE, [C, C], SI_POSITIONS, functionals=["lda_x", "lda_c_vwn"])
    return dftk.PlaneWaveBasis(model, Ecut=7.0, kgrid=(1, 1, 1), **kw)


def _state(res):
    return dict(psi=b64(np.asarray(res.psi)), occupation=np.asarray(res.occupation).tolist(),
                eigenvalues=np.asarray(res.eigenvalues).tolist(), epsF=float(res.epsF),
                total_energy=res.total_energy, n_iter=res.n_iter, converged=bool(res.converged))


def _dfpt_parts(res):
    """JAX's _bare_rhs and clamped-ion Hessian of dynmat_dfpt_gamma on the
    unfolded result."""
    import jax
    import jax.numpy as jnp
    from dftk_tpu.postprocess.forces import _positions_energy
    from dftk_tpu.postprocess.unfold import unfold_bz
    from dftk_tpu.response.chi0 import make_chi0_context
    from dftk_tpu.response.phonon_dfpt import _bare_rhs, _dVloc_grids
    res = unfold_bz(res)
    basis = res.basis
    rhs = _bare_rhs(basis, make_chi0_context(res, basis), _dVloc_grids(basis))
    H = jax.hessian(lambda pos: _positions_energy(
        basis, res.psi, res.occupation, res.rho, pos))(jnp.asarray(np.stack(
            basis.model.positions)))
    return dict(bare_rhs=b64(np.stack([np.asarray(r) for r in rhs])),
                clamped_ion_hessian=np.asarray(H).tolist())


def entry_si2_gamma():
    """Gamma Si2 (si2_gamma_basis, T = 0): the SCF to 1e-12 (its state);
    on it _bare_rhs (JAX's full-cube version), the clamped-ion Hessian
    (jax.hessian of _positions_energy), dynmat_dfpt_gamma
    (GAMMA_DFPT_TOLS) and its modes
    (phonon_modes_from_dynmat), and elastic_tensor_response (its
    defaults, the insulating branch)."""
    import dftk_tpu as dftk
    from dftk_tpu.postprocess.elastic_response import elastic_tensor_response
    from dftk_tpu.postprocess.phonon import phonon_modes_from_dynmat
    from dftk_tpu.response.phonon_dfpt import dynmat_dfpt_gamma
    basis = si2_gamma_basis(dftk)
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=60)
    C = dynmat_dfpt_gamma(res, **GAMMA_DFPT_TOLS)
    f, vecs = phonon_modes_from_dynmat(C, basis.model.atoms)
    return dict(fft_size=list(basis.fft_size), state=_state(res), **_dfpt_parts(res),
                dynmat=C.tolist(), frequencies=f.tolist(), modes=vecs.tolist(),
                elastic=elastic_tensor_response(res).tolist())


def entry_si2_smeared():
    """Smeared Gamma Si2 (si2_gamma_basis at T = 0.01, the metallic
    branches): the SCF to 1e-12 (its state), dynmat_dfpt_gamma
    (GAMMA_DFPT_TOLS) and elastic_tensor_response
    (SMEARED_ELASTIC_TOLS)."""
    import dftk_tpu as dftk
    from dftk_tpu.postprocess.elastic_response import elastic_tensor_response
    from dftk_tpu.response.phonon_dfpt import dynmat_dfpt_gamma
    basis = si2_gamma_basis(dftk, temperature=0.01)
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=60)
    C = dynmat_dfpt_gamma(res, **GAMMA_DFPT_TOLS)
    return dict(fft_size=list(basis.fft_size), state=_state(res), dynmat=C.tolist(),
                elastic=elastic_tensor_response(res, **SMEARED_ELASTIC_TOLS).tolist())


def entry_si2_kgrid():
    """Si2 on kgrid 2^3 (si2_kgrid_basis: Ecut 6, fft 16, an IBZ of 3
    k-points): the SCF to 1e-12 (its state); unfold_bz of it (psi,
    eigenvalues, occupations, k-points and weights); on the unfolded
    orbitals the strained jvp r_a = d_a(H psi) of _strained_H_psi for the
    six Voigt strains (the rows R_A_ROWS of the 4 occupied bands) and the
    clamped-orbital part (jax.hessian and jax.grad of F)."""
    import jax
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.postprocess import elastic_response as er
    from dftk_tpu.postprocess.stresses import energy_at_lattice
    from dftk_tpu.postprocess.unfold import unfold_bz
    basis = si2_kgrid_basis(dftk)
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=60)
    u = unfold_bz(res)
    bu = u.basis
    psi = jnp.asarray(np.asarray(u.psi)[:, :N_OCC_SI2])
    occ = jnp.full(psi.shape[:2], 2.0)
    r_a = []
    for a in range(6):
        Ea = er._strain_mat(a)
        _, r = jax.jvp(lambda e: er._strained_H_psi(bu, psi, occ, e * Ea, psi),
                       (jnp.asarray(0.0),), (jnp.asarray(1.0),))
        r_a.append(np.asarray(r * bu.data.mask[:, None, :])[R_A_ROWS])
    L0 = jnp.asarray(bu.model.lattice)

    def F(e6):
        eps = sum(e6[a] * er._strain_mat(a) for a in range(6))
        return energy_at_lattice(bu, psi, occ, (jnp.eye(3) + eps) @ L0)

    z6 = jnp.zeros(6)
    return dict(fft_size=list(basis.fft_size), n_kpoints_irr=basis.n_kpoints,
                state=_state(res),
                unfolded=dict(psi=b64(np.asarray(u.psi)), eigenvalues=b64(u.eigenvalues),
                              occupation=b64(u.occupation), kcoords=b64(bu.kcoords),
                              kweights=b64(np.asarray(bu.kweights))),
                strained_jvp=b64(np.stack(r_a)),
                energy_hessian=np.asarray(jax.hessian(F)(z6)).tolist(),
                energy_gradient=np.asarray(jax.grad(F)(z6)).tolist())


def entry_c2_upf():
    """Diamond C2 from C_m.upf under LDA (c2_upf_basis): the SCF to 1e-12
    (its state) and elastic_tensor_response (its defaults, the insulating
    branch, through the traced UPF form factors)."""
    import dftk_tpu as dftk
    from dftk_tpu.postprocess.elastic_response import elastic_tensor_response
    basis = c2_upf_basis(dftk)
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=60)
    return dict(fft_size=list(basis.fft_size), state=_state(res),
                elastic=elastic_tensor_response(res).tolist())


def entry_si2_reference_dynmat():
    """tests/test_dfpt_phonon.py::test_dfpt_matches_finite_differences's
    DFPT side: Si2 at Ecut 6, kgrid 2^3, the default FFT size and
    symmetries, the SCF to 1e-12, dynmat_dfpt_gamma (tol 1e-8,
    sternheimer_tol 1e-11)."""
    import dftk_tpu as dftk
    from dftk_tpu.response.phonon_dfpt import dynmat_dfpt_gamma
    basis = si2_kgrid_basis(dftk, fft_size=None)
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=60)
    return dict(fft_size=list(basis.fft_size), total_energy=res.total_energy,
                dynmat=dynmat_dfpt_gamma(res, tol=1e-8, sternheimer_tol=1e-11).tolist())


def entry_mg_dfpt():
    """tests/test_dfpt_phonon.py's metallic check, DFPT side: magnesium
    (mg_basis), the SCF to 1e-12 (maxiter 80, 6 + 4 bands),
    dynmat_dfpt_gamma (tol 1e-8, sternheimer_tol 1e-11)."""
    import dftk_tpu as dftk
    from dftk_tpu.response.phonon_dfpt import dynmat_dfpt_gamma
    basis = mg_basis(dftk)
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=80, n_bands=6, n_extra_bands=4)
    return dict(fft_size=list(basis.fft_size), total_energy=res.total_energy,
                dynmat=dynmat_dfpt_gamma(res, tol=1e-8, sternheimer_tol=1e-11).tolist())


def entry_al_elastic():
    """tests/test_elastic_resp.py's metallic check, response side:
    aluminium (al_basis), the SCF to 1e-12 (maxiter 80, 6 + 4 bands),
    elastic_tensor_response (its defaults)."""
    import dftk_tpu as dftk
    from dftk_tpu.postprocess.elastic_response import elastic_tensor_response
    basis = al_basis(dftk)
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=80, n_bands=6, n_extra_bands=4)
    return dict(fft_size=list(basis.fft_size), total_energy=res.total_energy,
                elastic=elastic_tensor_response(res).tolist())


def entry_si2_full_width():
    """chip_smoke.py phase n1's problem: Si2 at Ecut 15, kgrid 4^3 with the
    default symmetries and FFT size, the SCF to 1e-12, dynmat_dfpt_gamma
    (tol 1e-8, sternheimer_tol 1e-11) and elastic_tensor_response (its
    defaults), each timed (one perturbation: si2_full_width_timing)."""
    import dftk_tpu as dftk
    from dftk_tpu.postprocess.elastic_response import elastic_tensor_response
    from dftk_tpu.response.phonon_dfpt import dynmat_dfpt_gamma
    basis = si2_kgrid_basis(dftk, Ecut=15.0, kgrid=(4, 4, 4), fft_size=None)
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=60)
    t0 = time.time()
    C = dynmat_dfpt_gamma(res, tol=1e-8, sternheimer_tol=1e-11)
    t_dfpt = time.time() - t0
    t0 = time.time()
    C_el = elastic_tensor_response(res)
    return dict(fft_size=list(basis.fft_size), total_energy=res.total_energy,
                dynmat=C.tolist(), elastic=C_el.tolist(), dfpt_seconds=t_dfpt,
                elastic_seconds=time.time() - t0)


def entry_si2_full_width_timing():
    """The full width of chip_smoke.py phase n1: Si2 at Ecut 15, kgrid 4^3
    with the default symmetries, the SCF to 1e-12; then the first of
    dynmat_dfpt_gamma's six perturbations (tol 1e-8, sternheimer_tol
    1e-11: its bare chi0 apply, Dyson GMRES and detailed chi0 apply) on
    the unfolded result, timed."""
    import jax
    import dftk_tpu as dftk
    from dftk_tpu.postprocess.unfold import unfold_bz
    from dftk_tpu.response.chi0 import apply_chi0, apply_chi0_generic, make_chi0_context
    from dftk_tpu.response.hessian import apply_kernel, gmres
    from dftk_tpu.response.phonon_dfpt import _bare_rhs, _dVloc_grids
    basis = si2_kgrid_basis(dftk, Ecut=15.0, kgrid=(4, 4, 4), fft_size=None)
    t0 = time.time()
    res = dftk.self_consistent_field(basis, tol=1e-12, maxiter=60)
    t_scf = time.time() - t0
    t0 = time.time()
    u = unfold_bz(res)
    bu = u.basis
    ctx = make_chi0_context(u, bu)
    rhs = _bare_rhs(bu, ctx, _dVloc_grids(bu))[0]
    chi0 = jax.jit(lambda dv: apply_chi0(ctx, bu, dv, tol=1e-11))
    kernel = jax.jit(lambda dr: apply_kernel(bu, u.rho, dr))
    drho = gmres(lambda d: d - chi0(kernel(d)), apply_chi0_generic(ctx, bu, rhs, tol=1e-11),
                 tol=1e-8)
    apply_chi0_generic(ctx, bu, rhs, tol=1e-11, with_detail=True)[1].block_until_ready()
    del drho
    return dict(fft_size=list(basis.fft_size), n_kpoints_irr=basis.n_kpoints,
                n_kpoints=bu.n_kpoints, nG_max=bu.nG_max, total_energy=res.total_energy,
                scf_seconds=t_scf, one_perturbation_seconds=time.time() - t0)


if __name__ == "__main__":
    name = sys.argv[1]
    t0 = time.time()
    values = globals()["entry_" + name]()
    values["description"] = " ".join(globals()["entry_" + name].__doc__.split())
    values["cpu_seconds"] = time.time() - t0
    values["command"] = ("PYTHONPATH=. DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python "
                         f"tests/data/make_torch_port_phonon.py {name}")
    print(json.dumps({name: values}, default=float), flush=True)
