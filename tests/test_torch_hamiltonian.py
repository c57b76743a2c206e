"""dftk_tpu_torch's local potential and H apply against the JAX package.

Si2 at Ecut 7, fft_size (18,18,18), MonkhorstPack((2,2,2)), no symmetry,
from the JAX package's guess density and random orbitals (carried over with
`dftk_tpu_torch.interop`): V, the energy pieces and H psi agree to 1e-12.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dftk_tpu as dftk
from dftk_tpu.ops import hamiltonian as jax_ham
from dftk_tpu.ops.density import guess_density as jax_guess_density
from dftk_tpu.scf.driver import random_orbitals as jax_random_orbitals

import dftk_tpu_torch as dt
from dftk_tpu_torch.interop import state_from_numpy
from dftk_tpu_torch.ops import hamiltonian as ham_ops

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])


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
    volume = jb.model.unit_cell_volume
    rho_j = jax_guess_density(jb)
    V_j, E_j = jax_ham.total_potential(jb.terms, rho_j, jnp.asarray(jb.G_cube_cart),
                                       volume)
    _, rho_t = state_from_numpy(rho=np.asarray(rho_j), device="cpu")
    V_t, _, E_t = ham_ops.total_potential(tb.terms, rho_t, volume)
    return jb, tb, V_j, E_j, V_t, E_t


def test_total_potential_matches(setup):
    _, _, V_j, E_j, V_t, E_t = setup
    assert np.max(np.abs(V_t.numpy() - np.asarray(V_j))) < 1e-12
    assert set(E_t) == set(E_j) == {"AtomicLocal", "Hartree", "Xc"}
    for name in E_j:
        assert abs(float(E_t[name]) - float(E_j[name])) < 1e-12, name


def test_apply_H_matches(setup):
    jb, tb, V_j, _, V_t, _ = setup
    psi_j = jax_random_orbitals(jb, 5)
    H_j = jax_ham.apply_H(jax_ham.build_ham(jb.data, jb.terms.data, V_j), psi_j,
                          jb.fft_size, jb.model.unit_cell_volume)
    psi_t, _ = state_from_numpy(psi=np.asarray(psi_j), device="cpu")
    H_t = ham_ops.apply_H(ham_ops.build_ham(tb.data, tb.terms.data, V_t, tb.pruned),
                          psi_t)
    assert np.max(np.abs(H_t.numpy() - np.asarray(H_j))) < 1e-12


def test_psi_energies_match(setup):
    jb, tb, V_j, _, V_t, _ = setup
    psi_j = jax_random_orbitals(jb, 4)
    occ = np.tile([2.0, 2.0, 2.0, 2.0], (jb.n_kpoints, 1))
    E_j = jax_ham.psi_energies(jax_ham.build_ham(jb.data, jb.terms.data, V_j),
                               jb.terms, psi_j, jnp.asarray(occ), jb.data.kweights)
    psi_t, _ = state_from_numpy(psi=np.asarray(psi_j), device="cpu")
    E_t = ham_ops.psi_energies(ham_ops.build_ham(tb.data, tb.terms.data, V_t, tb.pruned),
                               psi_t, torch.as_tensor(occ), tb.data.kweights)
    assert set(E_t) == set(E_j)
    for name in E_j:
        assert abs(float(E_t[name]) - float(E_j[name])) < 1e-12, name
