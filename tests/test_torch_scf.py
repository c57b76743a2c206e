"""dftk_tpu_torch's eigensolver and SCF against the JAX package.

Si2 at Ecut 7, fft_size (18,18,18), MonkhorstPack((2,2,2)), no symmetry,
from seeded orthonormal orbitals and the JAX package's guess density, the
inputs of tests/data/make_torch_port_scf.py::entry_scf, whose JAX values
tests/data/torch_port_scf.json records (the entry's `command` reruns it):
  * LOBPCG from the same X0 on the same H: eigenvalues agree to 1e-10;
  * the SCF converges; its total energy agrees to 1e-9 Ha and its occupied
    eigenvalues to 1e-6, the bars of tests/test_engine_split.py::
    test_split_scf_matches_complex_f64.
"""
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.interop import state_from_numpy
from dftk_tpu_torch.kernels import local_apply as la
from dftk_tpu_torch.ops import hamiltonian as ham_ops
from dftk_tpu_torch.ops.eigen.lobpcg import lobpcg

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_scf", DATA / "make_torch_port_scf.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
N_BANDS = make.SCF_N_BANDS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def setup():
    """(port basis, the JAX entry, X0, rho0)."""
    with open(DATA / "torch_port_scf.json") as f:
        ref = json.load(f)["scf"]
    tb = make.si2_kgrid_basis(dt, device="cpu")
    psi0 = make.orthonormal_rows(tb.mask_np, N_BANDS + 3, 3)
    return tb, ref, psi0, np.array(ref["rho0"])


def test_lobpcg_matches(setup):
    tb, ref, psi0, rho0 = setup
    psi_t, rho_t = state_from_numpy(psi=psi0, rho=rho0, device="cpu")
    V_t, _, _ = ham_ops.total_potential(tb.terms, rho_t, tb.model.unit_cell_volume)
    ham_t = ham_ops.build_ham(tb.data, tb.terms.data, V_t, tb.pruned)
    res_t = lobpcg(lambda p: ham_ops.apply_H(ham_t, p), psi_t, ham_t.kin,
                   tb.data.mask, tol=1e-7, n_conv=N_BANDS)
    assert res_t.converged and ref["lobpcg"]["converged"]
    ev_j = np.array(ref["lobpcg"]["eigenvalues"])[:, :N_BANDS]
    assert np.max(np.abs(res_t.eigenvalues[:, :N_BANDS].numpy() - ev_j)) < 1e-10


def test_scf_matches(setup):
    tb, ref, psi0, rho0 = setup
    kw = dict(tol=1e-8, is_converged="energy", n_bands=N_BANDS)
    psi_t, rho_t = state_from_numpy(psi=psi0, rho=rho0, device="cpu")
    la.counts.reset()
    res_t = dt.self_consistent_field(tb, psi=psi_t, rho=rho_t, **kw)
    ref = ref["scf"]
    assert res_t.converged and ref["converged"]
    assert abs(res_t.total_energy - ref["total_energy"]) < 1e-9
    ev_j = np.array(ref["eigenvalues"])
    assert np.max(np.abs(res_t.eigenvalues[:, :4] - ev_j[:, :4])) < 1e-6
    assert res_t.rho.shape == (1, 18, 18, 18)
    # on CPU tensors the local apply ran its plain version
    assert la.counts.plain["local_plane"] > 0
    assert set(la.counts.launches.values()) == {0}


def test_random_orbitals_are_orthonormal(setup):
    from dftk_tpu_torch.scf.driver import random_orbitals
    tb = setup[0]
    X = random_orbitals(tb, 6, generator=torch.Generator().manual_seed(3))
    gram = X.conj() @ X.transpose(-1, -2)
    torch.testing.assert_close(gram, torch.eye(6, dtype=X.dtype).expand_as(gram),
                               rtol=0, atol=1e-12)
    assert float((X * (1 - tb.data.mask[:, None, :])).abs().max()) == 0.0


def test_import_leaves_jax_out():
    code = ("import sys, dftk_tpu_torch, dftk_tpu_torch.interop, "
            "dftk_tpu_torch.ops.engine_split, dftk_tpu_torch.ops.eigen.chefsi, "
            "dftk_tpu_torch.scf.energy_eval, dftk_tpu_torch.supercell, "
            "dftk_tpu_torch.tools.run_si_big, dftk_tpu_torch.postprocess.forces, "
            "dftk_tpu_torch.postprocess.stresses, dftk_tpu_torch.ops.forces_split, "
            "dftk_tpu_torch.ops.stresses_split, dftk_tpu_torch.ops.coulomb, "
            "dftk_tpu_torch.ops.exx_ace, dftk_tpu_torch.ops.exx_split, "
            "dftk_tpu_torch.ops.hubbard; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'dftk_tpu' or m.startswith('dftk_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
