"""dftk_tpu_torch's band structure and densities of states against the JAX
package.

Torch at one thread, float64, on tests/test_bands_dos.py's silicon (LDA,
lda/si-q4, Ecut 7, its four k-points, 17^3) and its PBE silicon from
Si.pbe-hgh.upf, with the JAX package's SCF state injected from
tests/data/torch_port_post.json (entries `bands` and `pdos`, recorded by
tests/data/make_torch_port_post.py): `compute_bands` along the fcc path
(kline_density 6, 6 bands) at the JAX density, eigenvalues within 1e-9
Ha of the JAX package's (the two start LOBPCG from different random
blocks, so only the eigenvalues compare); `compute_dos`, `compute_ldos`
and `compute_pdos` on the JAX eigenvalues and orbitals within 1e-12
(relative to the largest value for the LDOS), and the reference test's
claims on the port's numbers.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.postprocess.dos import compute_ldos, compute_pdos

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_post", DATA / "make_torch_port_post.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
with open(DATA / "torch_port_post.json") as _f:
    REF = json.load(_f)
BAR = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


def injected(basis, state):
    """An SCF result of the port holding the JAX state."""
    f = make.from_b64
    return dt.SCFResult(basis=basis, energies=state["energies"],
                        eigenvalues=f(state["eigenvalues"]).copy(),
                        occupation=f(state["occupation"]).copy(),
                        psi=torch.as_tensor(f(state["psi"]).copy()),
                        rho=torch.as_tensor(f(state["rho"]).copy()), epsF=state["epsF"],
                        converged=state["converged"], n_iter=state["n_iter"],
                        n_bands_converge=8, history_Etot=[], history_Drho=[], n_matvec=0,
                        runtime_s=0.0)


@pytest.fixture(scope="module")
def si():
    return injected(make.bands_basis(dt, device="cpu"), REF["bands"]["state"])


def test_compute_bands_against_jax(si):
    want = REF["bands"]["bands"]
    bands = dt.compute_bands(si, **make.BANDS)
    ev = bands["eigenvalues"]
    diff = np.abs(ev - np.array(want["eigenvalues"])).max()
    print(f"compute_bands: {ev.shape[0]} k-points, max diff from JAX {diff:.2e} Ha")
    assert bands["converged"] and want["converged"]
    np.testing.assert_array_equal(bands["kcoords"], np.array(want["kcoords"]))
    assert ev.shape == (len(want["kcoords"]), 6) and diff < 1e-9
    # tests/test_bands_dos.py's claims: the gap, and Gamma's degenerate top
    assert np.all(ev[:, 3] < si.epsF + 0.05) and np.all(ev[:, 4] > si.epsF - 0.05)
    ig = [i for i, lab in bands["kpath"].labels.items() if lab == "G"][0]
    assert np.ptp(ev[ig, 1:4]) < 1e-4


def test_dos_against_jax(si):
    e = make.DOS_EPS
    eps = np.linspace(e["lo"], si.epsF, e["n"])
    dos = dt.compute_dos(eps, si.basis, si.eigenvalues, temperature=e["temperature"])
    diff = np.abs(dos - np.array(REF["bands"]["dos"])).max()
    print(f"compute_dos: max diff from JAX {diff:.2e}")
    assert diff < BAR
    assert abs(np.trapezoid(dos, eps) - 8.0) < 0.1


def test_ldos_against_jax(si):
    eps = np.array(make.LDOS_EPS)
    ldos = compute_ldos(eps, si.basis, si.eigenvalues, si.psi)
    assert ldos.shape == (3, 17, 17, 17)
    for x, want in zip(ldos, REF["bands"]["ldos"]):
        got = make.table_summary(x)
        scale = max(abs(v) for v in want["sample"])
        for key in ("first", "sum", "wsum"):
            assert abs(got[key] - want[key]) < BAR * max(scale, abs(want[key])), key
        assert np.abs(np.array(got["sample"]) - want["sample"]).max() < BAR * scale
    # the LDOS integrates over the cell to the DOS
    dos = dt.compute_dos(eps, si.basis, si.eigenvalues)
    np.testing.assert_allclose(ldos.sum(axis=(1, 2, 3)) * si.basis.dvol, dos, rtol=1e-10)
    np.testing.assert_allclose(dos, REF["bands"]["ldos_dos"], rtol=0, atol=BAR)


def test_pdos_against_jax():
    want = REF["pdos"]
    res = injected(make.pdos_basis(dt, device="cpu"), want["state"])
    pdos = compute_pdos(np.array(want["eps"]), res.basis, res.eigenvalues, res.psi)
    assert sorted(pdos) == sorted(want["pdos"]) and len(pdos) == 4
    diff = max(np.abs(pdos[k] - np.array(v)).max() for k, v in want["pdos"].items())
    print(f"compute_pdos: max diff from JAX {diff:.2e}")
    assert diff < BAR
    s = [sum(pdos[k][i] for k in pdos if "_l0_" in k) for i in (0, 1)]
    p = [sum(pdos[k][i] for k in pdos if "_l1_" in k) for i in (0, 1)]
    assert s[0] > p[0] and p[1] > s[1]


def test_compute_bands_explicit_kpoints_and_paths(si):
    """kcoords given explicitly, and a custom named path through `paths`."""
    want = np.array(REF["bands"]["bands"]["eigenvalues"])
    kcoords = np.array(REF["bands"]["bands"]["kcoords"])[[0, -1]]
    bands = dt.compute_bands(si, kcoords=kcoords, n_bands=6)
    assert bands["kpath"] is None and bands["converged"]
    assert np.abs(bands["eigenvalues"] - want[[0, -1]]).max() < 1e-9
    path = dt.irrfbz_path(si.basis.model.lattice, 2, paths=["G", "X"])
    assert [path.labels[i] for i in sorted(path.labels)] == ["G", "X"]
