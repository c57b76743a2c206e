"""dftk_tpu_torch's split SCF (CheFSI, compact filter, mixing, refine)
against the JAX package.

Si2 Gamma at Ecut 6 (tests/testcases.py::make_silicon_model, no symmetry),
float64, from the same realified orbitals U0 and the JAX package's guess
density rho0, the inputs of tests/data/make_torch_port_scf.py::entry_split,
whose JAX values tests/data/torch_port_scf.json records (the entry's
`command` reruns it; the two packages draw different random numbers):
  * the split SCF, CheFSI (degree 8, 2 cycles, filter 'highest'), LOBPCG
    and the Penn-model dielectric mixing: total energy within 1e-9 Ha and
    occupied eigenvalues within 1e-6, the bars of tests/test_engine_split.py::
    test_split_scf_matches_complex_f64;
  * the compact-cube-resident filter apply leave(apply_c(enter(U))) and the
    split adapters (realify, apply_H, density, potential, energies): 1e-12;
  * one chefsi_step from the same X0, H and ub: eigenvalues within 1e-10;
  * refine_split_energy against the JAX package's evaluate_total_energy on
    the same state (the port's CheFSI SCF result, which the entry computes
    as this file does): 1e-10 Ha;
  * the mixing pieces (Kerker, dielectric, the Anderson step against the
    reference's ring buffer): 1e-12.
Port-only checks, with the bars of tests/test_engine_split.py:130-210: the
"mixed" filter (bf16 cycles, exact finish) against "highest" (1e-7 Ha), the
stall exit in complex64, the warm restart, and the refusals.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.kernels import local_apply as la
from dftk_tpu_torch.ops import engine_split as tes
from dftk_tpu_torch.ops import hamiltonian as ham_ops
from dftk_tpu_torch.ops.eigen.chefsi import chefsi_step, estimate_upper_bound

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_scf", DATA / "make_torch_port_scf.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
N_BANDS, N_EXTRA = make.SPLIT_N_BANDS, make.SPLIT_N_EXTRA
CHEFSI = make.CHEFSI


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


def _port_model(**kw):
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    return dt.model_DFT(make.SI_LATTICE, [Si, Si], make.SI_POSITIONS,
                        functionals=["lda_x", "lda_c_vwn"], symmetries=False, **kw)


@pytest.fixture(scope="module")
def si():
    """(the JAX entry, port basis, X0, U0, rho0)."""
    with open(DATA / "torch_port_scf.json") as f:
        ref = json.load(f)["split"]
    tb = make.si2_gamma_basis(dt, device="cpu")
    X0, U0 = make.split_start(tb.mask_np)
    return ref, tb, X0, U0, np.array(ref["rho0"])


@pytest.fixture(scope="module")
def port_chefsi_highest(si):
    _, tb, _, U0, rho0 = si
    return dt.self_consistent_field_split(
        tb, tol=1e-10, maxiter=60, n_bands=N_BANDS, n_extra_bands=N_EXTRA,
        U0=U0, rho0=rho0, filter_precision="highest", **CHEFSI)


def _port_ham(tb, rho):
    V, _, _ = ham_ops.total_potential(tb.terms, torch.as_tensor(rho), tb.model.unit_cell_volume)
    return ham_ops.build_ham(tb.data, tb.terms.data, V, tb.pruned)


@pytest.mark.parametrize("case", ["chefsi", "lobpcg", "auto_eps"])
def test_split_scf_matches_jax(si, port_chefsi_highest, case):
    ref, tb, _, U0, rho0 = si
    kw = dict(tol=1e-10, maxiter=60, n_bands=N_BANDS, n_extra_bands=N_EXTRA)
    kw.update({"chefsi": dict(filter_precision="highest", **CHEFSI), "lobpcg": {},
               "auto_eps": dict(mixing_eps_r="auto")}[case])
    res_j = ref["scf"][case]
    res_t = (port_chefsi_highest if case == "chefsi" else
             dt.self_consistent_field_split(tb, U0=U0, rho0=rho0, **kw))
    assert res_j["converged"] and res_t["converged"]
    dE = abs(res_t["energies"]["total"] - res_j["total"])
    ev_t, ev_j = res_t["eigenvalues"][:, :N_BANDS], np.array(res_j["eigenvalues"])[:, :N_BANDS]
    dev = np.max(np.abs(ev_t - ev_j))
    print(f"split SCF {case}: |dE| = {dE:.1e} Ha, max |d eig| = {dev:.1e}, "
          f"iterations {res_t['n_iter']} (port) / {res_j['n_iter']} (JAX)")
    assert dE < 1e-9 and dev < 1e-6
    assert res_t["U"].shape == (1, N_BANDS + N_EXTRA, 2 * tb.nG_max)
    assert res_t["rho"].shape == (1,) + tb.fft_size


def test_compact_filter_matches_jax(si):
    ref, tb, X0, U0, rho0 = si
    volume = tb.model.unit_cell_volume
    want = np.array(ref["compact_filter"])
    enter, leave, apply_c = tes.compact_filter_ops(_port_ham(tb, rho0), volume,
                                                   precision="highest")
    out = leave(apply_c(enter(torch.as_tensor(X0))))
    out = torch.cat([out.real, out.imag], dim=-1).numpy()
    err = np.max(np.abs(out - want))
    print(f"compact filter apply: max abs err {err:.1e}, max|ref| {np.max(np.abs(want)):.1e}")
    assert err < 1e-12 * max(1.0, np.max(np.abs(want)))
    # the placement does not depend on V: one built at another potential
    placement = tes.place_compact(_port_ham(tb, 2 * rho0), ("highest",))
    _, _, apply_p = tes.compact_filter_ops(_port_ham(tb, rho0), volume,
                                           placement=placement)
    xc = enter(torch.as_tensor(X0))
    assert torch.equal(apply_p(xc), apply_c(xc))


def test_chefsi_step_matches_jax(si):
    ref, tb, X0, _, rho0 = si
    ham_t = _port_ham(tb, rho0)
    apply_t = lambda p: ham_ops.apply_H(ham_t, p)
    ub = round(estimate_upper_bound(apply_t, torch.as_tensor(X0), tb.data.mask), 3)
    assert ub == ref["chefsi_step"]["ub"]       # the JAX step ran at this bound
    kw = dict(degree=8, ub=ub, n_conv=N_BANDS, cycles=2)
    res_t = chefsi_step(apply_t, torch.as_tensor(X0), tb.data.mask, **kw)
    assert res_t.upper_bound == ub
    err = np.max(np.abs(res_t.eigenvalues.numpy() - np.array(ref["chefsi_step"]["eigenvalues"])))
    print(f"chefsi_step: max |d eig| {err:.1e}")
    assert err < 1e-10


def test_refine_matches_jax_evaluate_total_energy(si, port_chefsi_highest):
    ref, tb, _, _, _ = si
    res = port_chefsi_highest
    E_t = dt.refine_split_energy(tb, res)
    E_j = ref["refine"]["energies"]
    assert set(E_t) == set(E_j)
    # the JAX package evaluated the port's result, which this run reproduces
    assert abs(res["energies"]["total"] - ref["refine"]["port_total"]) < 1e-12
    print(f"refine: |dE| vs JAX {abs(E_t['total'] - E_j['total']):.1e} Ha")
    assert abs(E_t["total"] - E_j["total"]) < 1e-10
    assert abs(E_t["total"] - res["energies"]["total"]) < 1e-9


@pytest.mark.parametrize("what", ["realify", "apply_H", "density", "potential",
                                  "psi_energies"])
def test_split_adapters_match_jax(si, what):
    ref, tb, X0, U0, rho0 = si
    volume = tb.model.unit_cell_volume
    sd_t = tes.prepare_split_data(tb)
    occ = np.tile([2.0] * N_BANDS + [0.0] * N_EXTRA, (1, 1))
    U = torch.as_tensor(U0)
    want = ref["adapters"][what]
    if what == "realify":
        out = tes.realify_orbitals(torch.as_tensor(X0)).numpy()
    elif what == "apply_H":
        V_t, _, _ = ham_ops.total_potential(tb.terms, torch.as_tensor(rho0), volume)
        out = tes.apply_H_split(tes.make_split_ham(sd_t, V_t), U, tb.fft_size, volume,
                                band_chunk=3).numpy()
    elif what == "density":
        out = tes.compute_density_split(sd_t, U, torch.as_tensor(occ), tb.fft_size, volume,
                                        1, band_chunk=3).numpy()
    elif what == "potential":
        out = tes.total_potential_split(tb.terms, sd_t, torch.as_tensor(rho0), volume)[0].numpy()
    else:
        E_t = tes.psi_energies_split(sd_t, U, torch.as_tensor(occ))
        assert set(E_t) == set(want)
        out = np.array([float(E_t[k]) for k in sorted(E_t)])
        want = [want[k] for k in sorted(want)]
    ref_arr = np.array(want)
    assert out.shape == ref_arr.shape
    assert np.max(np.abs(out - ref_arr)) < 1e-12 * max(1.0, np.max(np.abs(ref_arr)))


@pytest.mark.parametrize("what", ["kerker", "dielectric", "anderson"])
def test_mixing_matches_jax(si, what):
    ref, tb, _, _, rho0 = si
    rng = np.random.default_rng(5)
    Gsq = tb.terms.data.Gsq_cart
    if what == "kerker":
        dF = rng.normal(size=rho0.shape)
        out = tes.kerker_mix_split(torch.as_tensor(dF), Gsq).numpy()
        want = np.array(ref["mixing"]["kerker"])
    elif what == "dielectric":
        dF = rng.normal(size=rho0.shape)
        out = tes.dielectric_mix(torch.as_tensor(dF), 12.0, Gsq).numpy()
        factor = (0.64 + Gsq.numpy()) / (12.0 * 0.64 + Gsq.numpy())
        want = np.fft.ifftn(factor * np.fft.fftn(dF[0])).real[None]
    else:
        m = 3
        step_t = tes.make_mix_step(None, m)
        rho_t = torch.as_tensor(rho0)
        for drho_j in ref["mixing"]["anderson_drho"]:  # fills the window and slides it
            noise = 0.01 * rng.normal(size=rho0.shape)
            rho_t, drho_t = step_t(rho_t, rho_t + torch.as_tensor(noise), 0.8, 0.0)
            assert abs(float(drho_t) - drho_j) < 1e-12
        out, want = rho_t.numpy(), np.array(ref["mixing"]["anderson_rho"])
    assert np.max(np.abs(out - want)) < 1e-12


def test_mixed_filter_matches_highest(si, port_chefsi_highest):
    _, tb, _, U0, rho0 = si
    la.counts.reset()
    res = dt.self_consistent_field_split(tb, tol=1e-10, maxiter=60, n_bands=N_BANDS,
                                         n_extra_bands=N_EXTRA, U0=U0, rho0=rho0,
                                         **CHEFSI)          # filter_precision="mixed"
    assert res["converged"] and port_chefsi_highest["converged"]
    dE = abs(res["energies"]["total"] - port_chefsi_highest["energies"]["total"])
    print(f"mixed vs highest filter: |dE| {dE:.1e} Ha")
    assert dE < 1e-7
    assert la.counts.plain["local_plane[bf16]"] > 0
    assert la.counts.plain["pruned_axis_dft[bf16]"] > 0
    assert set(la.counts.launches.values()) == {0}


def test_split_scf_stall_exit_returns_best_iterate(si):
    _, tb, _, _, _ = si
    kw = dict(maxiter=80, dtype=torch.complex64, is_converged="density", **CHEFSI)
    r_ref = dt.self_consistent_field_split(tb, tol=1e-6, **kw)
    assert r_ref["converged"] and not r_ref["stalled"]
    r = dt.self_consistent_field_split(tb, tol=1e-12, stall_patience=4, **kw)
    assert r["stalled"] and not r["converged"]
    assert r["n_iter"] < kw["maxiter"]
    assert abs(r["energies"]["total"] - r_ref["energies"]["total"]) < 1e-5
    assert r["U"].dtype == torch.float32


def test_split_scf_warm_restart(si):
    _, tb, _, _, _ = si
    r1 = dt.self_consistent_field_split(tb, tol=1e-9, maxiter=50)
    assert r1["converged"]
    r2 = dt.self_consistent_field_split(tb, tol=1e-9, maxiter=8, rho0=r1["rho"],
                                        U0=r1["U"])
    assert r2["converged"]
    assert r2["n_iter"] <= 4
    assert abs(r2["energies"]["total"] - r1["energies"]["total"]) < 1e-8


@pytest.mark.parametrize("what", ["temperature", "symmetric", "paired", "mesh",
                                  "bf16_filter"])
def test_split_scf_refusals(si, what):
    """What the split SCF refuses: the realified band representation, and
    on a k-point mesh (item 13, which the split SCF itself now runs,
    tests/test_torch_parallel.py) the split engine's entry points without
    k-point reductions (item 13b), here on a basis sharded over a stand-in
    (1, 2) ("kpts", "bands") mesh that runs no collective.  Finite
    temperature and symmetric runs with magnetic moments, refused before
    item 8a, and the all-bf16 filter, refused before item 8b, now run;
    those cases check one iteration of each (the all-bf16 one filters with
    the bf16 plain versions only)."""
    tb = si[1]
    if what == "bf16_filter":
        from dftk_tpu_torch.kernels import local_apply as la
        la.counts.reset()
        res = dt.self_consistent_field_split(tb, maxiter=1, filter_precision="default",
                                             **CHEFSI)
        assert np.isfinite(res["energies"]["total"])
        assert la.counts.plain["local_plane[bf16]"] > 0
        return
    if what in ("temperature", "symmetric"):
        Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
        kw = (dict(symmetries=False, temperature=0.01) if what == "temperature"
              else dict(symmetries=True, magnetic_moments=[1.0, 1.0]))
        model = dt.model_DFT(make.SI_LATTICE, [Si, Si], make.SI_POSITIONS,
                             functionals=["lda_x"], **kw)
        res = dt.self_consistent_field_split(
            dt.PlaneWaveBasis(model, Ecut=6.0, device="cpu"), maxiter=1)
        assert np.isfinite(res["energies"]["total"])
        assert ("Entropy" in res["energies"]) == (what == "temperature")
        assert res["rho"].shape[0] == (2 if what == "symmetric" else 1)
        return
    if what == "mesh":
        from dftk_tpu_torch.parallel.mesh import shard_basis
        from dftk_tpu_torch.response.chi0_split import make_chi0_split_context
        from dftk_tpu_torch.scf.energy_eval import refine_split_energy

        class TwoBandRanks:
            """Rank 0's view of a (1, 2) ("kpts", "bands") mesh."""
            mesh_dim_names = ("kpts", "bands")

            def size(self, i):
                return (1, 2)[i]

            def get_coordinate(self):
                return (0, 0)

            def get_group(self, name):
                return None

        b = shard_basis(make.si2_gamma_basis(dt, device="cpu"), TwoBandRanks())
        state = dict(U=np.zeros((1, 4, 2 * b.nG_max)), occupation=np.zeros((1, 4)))
        for call in (lambda: make_chi0_split_context(b, None, state),
                     lambda: refine_split_energy(b, state)):
            with pytest.raises(NotImplementedError, match="item 13b"):
                call()
        return
    with pytest.raises(NotImplementedError):
        dt.self_consistent_field_split(tb, maxiter=1, band_repr="paired")


def test_basis_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.PlaneWaveBasis(_port_model(), Ecut=6.0)


def test_create_supercell_matches_jax(si):
    sc_j = si[0]["supercell"]
    sc_t = dt.create_supercell(make.SI_LATTICE, ["a", "b"], make.SI_POSITIONS, (2, 1, 3))
    np.testing.assert_array_equal(sc_t["lattice"], sc_j["lattice"])
    np.testing.assert_array_equal(sc_t["positions"], sc_j["positions"])
    assert sc_t["atoms"] == sc_j["atoms"] and tuple(sc_t["size"]) == tuple(sc_j["size"])


def test_run_si_big_options_and_basis():
    from dftk_tpu_torch.tools import run_si_big
    assert run_si_big.scf_options({}) == dict(
        filter_precision="mixed", chebyshev_degree=10, chefsi_cycles=2, maxiter=40,
        tol=2e-6, stall_patience=8)
    assert run_si_big.scf_options({"DFTK_STALL_PATIENCE": "0"})["stall_patience"] is None
    with pytest.raises(ValueError, match="DFTK_STALL_PATIENCE"):
        run_si_big.scf_options({"DFTK_STALL_PATIENCE": "-1"})
    assert run_si_big.n_bands_of(256) == (512, 576)        # Si256: 576 bands
    basis = run_si_big.build_basis((1, 1, 1), 4.0, device="cpu")
    assert len(basis.model.atoms) == 8
    np.testing.assert_allclose(basis.model.lattice, np.eye(3) * run_si_big.A_CONV)
