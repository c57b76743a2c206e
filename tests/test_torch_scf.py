"""dftk_tpu_torch's eigensolver and SCF against the JAX package.

Si2 at Ecut 7, fft_size (18,18,18), MonkhorstPack((2,2,2)), no symmetry,
from the JAX package's random orbitals and guess density (carried over with
`dftk_tpu_torch.interop`):
  * LOBPCG from the same X0 on the same H: eigenvalues agree to 1e-10;
  * the SCF converges; its total energy agrees to 1e-9 Ha and its occupied
    eigenvalues to 1e-6, the bars of tests/test_engine_split.py::
    test_split_scf_matches_complex_f64.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dftk_tpu as dftk
from dftk_tpu.ops import hamiltonian as jax_ham
from dftk_tpu.ops.density import guess_density as jax_guess_density
from dftk_tpu.ops.eigen.lobpcg import lobpcg as jax_lobpcg
from dftk_tpu.scf.driver import random_orbitals as jax_random_orbitals

import dftk_tpu_torch as dt
from dftk_tpu_torch.interop import state_from_numpy
from dftk_tpu_torch.kernels import local_apply as la
from dftk_tpu_torch.ops import hamiltonian as ham_ops
from dftk_tpu_torch.ops.eigen.lobpcg import lobpcg

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
N_BANDS = 8


def _si2(pkg, **kw):
    Si = pkg.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = pkg.model_DFT(SI_LATTICE, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                          functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    return pkg.PlaneWaveBasis(model, Ecut=7.0, kgrid=pkg.MonkhorstPack((2, 2, 2)),
                              fft_size=(18, 18, 18), **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def setup():
    jb, tb = _si2(dftk), _si2(dt, device="cpu")
    psi0 = jax_random_orbitals(jb, N_BANDS + 3)
    rho0 = jax_guess_density(jb)
    return jb, tb, psi0, rho0


def test_lobpcg_matches(setup):
    jb, tb, psi0, rho0 = setup
    volume = jb.model.unit_cell_volume
    V_j, _ = jax_ham.total_potential(jb.terms, rho0, jnp.asarray(jb.G_cube_cart), volume)
    ham_j = jax_ham.build_ham(jb.data, jb.terms.data, V_j)
    res_j = jax_lobpcg(lambda p: jax_ham.apply_H(ham_j, p, jb.fft_size, volume),
                       psi0, ham_j.kin, jb.data.mask, tol=1e-7, n_conv=N_BANDS)

    psi_t, rho_t = state_from_numpy(psi=np.asarray(psi0), rho=np.asarray(rho0),
                                    device="cpu")
    V_t, _, _ = ham_ops.total_potential(tb.terms, rho_t, volume)
    ham_t = ham_ops.build_ham(tb.data, tb.terms.data, V_t, tb.pruned)
    res_t = lobpcg(lambda p: ham_ops.apply_H(ham_t, p), psi_t, ham_t.kin,
                   tb.data.mask, tol=1e-7, n_conv=N_BANDS)
    assert res_t.converged and bool(res_j.converged)
    ev_j = np.asarray(res_j.eigenvalues)[:, :N_BANDS]
    assert np.max(np.abs(res_t.eigenvalues[:, :N_BANDS].numpy() - ev_j)) < 1e-10


def test_scf_matches(setup):
    jb, tb, psi0, rho0 = setup
    kw = dict(tol=1e-8, is_converged="energy", n_bands=N_BANDS)
    res_j = dftk.self_consistent_field(jb, psi=psi0, rho=rho0, **kw)
    psi_t, rho_t = state_from_numpy(psi=np.asarray(psi0), rho=np.asarray(rho0),
                                    device="cpu")
    la.counts.reset()
    res_t = dt.self_consistent_field(tb, psi=psi_t, rho=rho_t, **kw)
    assert res_t.converged and res_j.converged
    assert abs(res_t.total_energy - res_j.total_energy) < 1e-9
    assert np.max(np.abs(res_t.eigenvalues[:, :4] - res_j.eigenvalues[:, :4])) < 1e-6
    assert res_t.rho.shape == (1, 18, 18, 18)
    # on CPU tensors the local apply ran its plain version
    assert la.counts.plain["local_plane"] > 0
    assert set(la.counts.launches.values()) == {0}


def test_random_orbitals_are_orthonormal(setup):
    from dftk_tpu_torch.scf.driver import random_orbitals
    _, tb, _, _ = setup
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
            "dftk_tpu_torch.ops.stresses_split; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'dftk_tpu' or m.startswith('dftk_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
