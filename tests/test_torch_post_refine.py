"""dftk_tpu_torch's two-grid refinement, transfers and cell utilities
against the JAX package.

Torch at one thread, float64, against tests/data/torch_port_post.json
(recorded by tests/data/make_torch_port_post.py):
  * `refine_scfres` (Ecut 6 -> 10) of tests/test_refine_chefsi.py's
    displaced Si2 at Gamma from the JAX package's injected coarse state:
    every energy within 1e-9 Ha; `refine_forces` F, dF and F_refined, and
    `refine_forces_cart`, within 1e-8 Ha/bohr;
  * `transfer_blochwave` exactly (the index maps equal, and the round trip
    the identity; `interpolate_kpoint` gives the same orbitals),
    `transfer_density` within 1e-13;
  * `cell_to_supercell`, `standardize_atoms`, `minkowski_reduce`,
    `kgrid_from_maximal_spacing`, `list_psp`/`load_psp` and
    `random_density` exactly.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_post", DATA / "make_torch_port_post.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
with open(DATA / "torch_port_post.json") as _f:
    REF = json.load(_f)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


def summary_equal(got, want, bar):
    g = make.table_summary(got)
    scale = max(1.0, max(abs(v) for v in want["sample"]))
    assert g["size"] == want["size"]
    for key in ("first", "sum", "wsum"):
        assert abs(g[key] - want[key]) <= bar * max(scale, abs(want[key])), key
    assert np.abs(np.array(g["sample"]) - want["sample"]).max() <= bar * scale


@pytest.fixture(scope="module")
def refinement():
    want = REF["refine"]
    f = make.from_b64
    st = want["state"]
    basis = make.refine_basis(dt, device="cpu")
    res = dt.SCFResult(basis=basis, energies=st["energies"],
                       eigenvalues=f(st["eigenvalues"]).copy(),
                       occupation=f(st["occupation"]).copy(),
                       psi=torch.as_tensor(f(st["psi"]).copy()),
                       rho=torch.as_tensor(f(st["rho"]).copy()), epsF=st["epsF"],
                       converged=True, n_iter=st["n_iter"], n_bands_converge=4,
                       history_Etot=[], history_Drho=[], n_matvec=0, runtime_s=0.0)
    return dt.refine_scfres(res, Ecut_fine=make.REFINE_ECUT[1])


def test_refine_scfres_against_jax(refinement):
    want = REF["refine"]
    assert list(refinement.basis.fft_size) == want["fine_fft_size"]
    diffs = {k: abs(refinement.energies[k] - v) for k, v in want["energies"].items()}
    print(f"refine_scfres: energies' max diff from JAX {max(diffs.values()):.2e} Ha")
    assert set(refinement.energies) == set(want["energies"])
    assert max(diffs.values()) < 1e-9 and abs(refinement.total_energy - want["total"]) < 1e-9
    assert abs(refinement.residual_norm - want["residual_norm"]) < 1e-9
    summary_equal(refinement.drho.numpy(), want["drho"], 1e-9)


def test_refine_forces_against_jax(refinement):
    want = REF["refine"]
    fr, fc = dt.refine_forces(refinement), dt.refine_forces_cart(refinement)
    for got, ref in ((fr, want["forces"]), (fc, want["forces_cart"])):
        for key in ("F", "dF", "F_refined"):
            diff = np.abs(got[key] - np.array(ref[key])).max()
            print(f"refine_forces {key}: max diff from JAX {diff:.2e} Ha/bohr")
            assert got[key].shape == (2, 3) and diff < 1e-8, key
    assert np.abs(fr["dF"]).max() > 1e-4                 # a genuine correction


def test_transfer_against_jax():
    want = REF["transfer"]
    b5, b10, g16, g24 = make.transfer_bases(dt, device="cpu")
    from dftk_tpu_torch.transfer import transfer_mapping
    for (bi, bo), key in (((b5, b10), "idx_up"), ((b10, b5), "idx_down")):
        np.testing.assert_array_equal(transfer_mapping(bi, bo)[0], make.from_b64(want[key]))
    psi = torch.as_tensor(make.seeded_orbitals(b5.mask_np, 4, 4))
    up = dt.transfer_blochwave(psi, b5, b10)
    summary_equal(up.real.numpy(), want["up"]["re"], 0.0)
    summary_equal(up.imag.numpy(), want["up"]["im"], 0.0)
    assert torch.equal(dt.transfer_blochwave(up, b10, b5), psi)
    from dftk_tpu_torch.transfer import interpolate_kpoint
    assert torch.equal(interpolate_kpoint(psi[1], b5, 1, b10, 1), up[1])
    rho = make.seeded_density(g16.fft_size, 5)
    rho_up = dt.transfer_density(torch.as_tensor(rho), g16, g24)
    rho_back = dt.transfer_density(rho_up, g24, g16)
    summary_equal(rho_up.numpy(), want["rho_up"], 1e-13)
    summary_equal(rho_back.numpy(), want["rho_back"], 1e-13)
    assert abs(float(rho_up.sum()) * g24.dvol - rho.sum() * g16.dvol) < 1e-12


def test_cells_and_loaders_against_jax():
    want = REF["misc"]
    m = make.si2_model(dt)
    b = dt.PlaneWaveBasis(m, Ecut=7.0, kgrid=(2, 2, 2), device="cpu",
                          use_symmetries_for_kpoint_reduction=False)
    psi = torch.as_tensor(make.seeded_orbitals(b.mask_np, 4, 6))
    res = make.FakeResult(basis=b, psi=psi, eigenvalues=np.zeros((b.n_kpoints, 4)))
    sc, folded = dt.cell_to_supercell(res)
    w = want["supercell"]
    assert list(sc["size"]) == w["size"] and len(sc["atoms"]) == w["n_atoms"]
    np.testing.assert_array_equal(sc["lattice"], np.array(w["lattice"]))
    for ik, (f, g) in enumerate(zip(folded, w["G"], strict=True)):
        assert f["G"].shape[0] == g["n"] and f["G"].sum(0).tolist() == g["sum"]
        assert int((f["G"] @ np.array([1, 97, 9973])).sum()) == g["wsum"]
        np.testing.assert_array_equal(f["coeffs"], psi[ik, :, :g["n"]].numpy())
    sc2 = dt.create_supercell(make.SI_LATTICE, ["Si", "Si"], make.SI_POSITIONS, (2, 1, 1))
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    std = dt.standardize_atoms(sc2["lattice"], [Si] * 4, sc2["positions"])
    np.testing.assert_array_equal(std["lattice"], np.array(want["standardize"]["lattice"]))
    np.testing.assert_array_equal(np.array(std["positions"]),
                                  np.array(want["standardize"]["positions"]))
    skew = make.SI_LATTICE @ np.array([[1, 1, 0], [0, 1, 0], [0, 0, 1]])
    np.testing.assert_array_equal(dt.minkowski_reduce(skew), np.array(want["minkowski"]))
    assert [list(dt.kgrid_from_maximal_spacing(make.SI_LATTICE, s).kgrid_size)
            for s in (0.1, 0.22, 0.5, 1.0)] == want["kgrid"]
    assert want["list_psp"] == dict(all=dt.list_psp(), si=dt.list_psp(element="Si"),
                                    pbe=dt.list_psp(family="pbe"))
    for key, p in want["psps"].items():
        q = dt.load_psp(key)
        assert (q.identifier, q.Zion, q.rloc, list(q.cloc), list(q.rp)) == (
            p["identifier"], p["Zion"], p["rloc"], p["cloc"], p["rp"])
        assert [np.asarray(h).tolist() for h in q.h] == p["h"]
    summary_equal(dt.random_density(b, seed=3).numpy(), want["random_density"], 0.0)
