"""dftk_tpu_torch's local potential and H apply against the JAX package.

Si2 at Ecut 7, fft_size (18,18,18), MonkhorstPack((2,2,2)), no symmetry,
at the JAX package's guess density: V, the energy pieces, H psi and the
orbital energies of seeded orthonormal orbitals agree to 1e-12 with the
JAX values recorded in tests/data/torch_port_scf.json (entries "scf" for
the density and "hamiltonian"; each entry's `command` reruns
tests/data/make_torch_port_scf.py, whose constructors and seeded inputs
this file imports).
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.interop import state_from_numpy
from dftk_tpu_torch.ops import hamiltonian as ham_ops

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_scf", DATA / "make_torch_port_scf.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
with open(DATA / "torch_port_scf.json") as _f:
    _REF = json.load(_f)
REF = _REF["hamiltonian"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def setup():
    tb = make.si2_kgrid_basis(dt, device="cpu")
    _, rho_t = state_from_numpy(rho=np.array(_REF["scf"]["rho0"]), device="cpu")
    V_t, _, E_t = ham_ops.total_potential(tb.terms, rho_t, tb.model.unit_cell_volume)
    return tb, V_t, E_t


def test_total_potential_matches(setup):
    _, V_t, E_t = setup
    assert np.max(np.abs(V_t.numpy() - np.array(REF["V"]))) < 1e-12
    assert set(E_t) == set(REF["energies"]) == {"AtomicLocal", "Hartree", "Xc"}
    for name, want in REF["energies"].items():
        assert abs(float(E_t[name]) - want) < 1e-12, name


def test_apply_H_matches(setup):
    tb, V_t, _ = setup
    psi_t, _ = state_from_numpy(psi=make.orthonormal_rows(tb.mask_np, make.HAM_BANDS,
                                                          make.HAM_SEED), device="cpu")
    H_t = ham_ops.apply_H(ham_ops.build_ham(tb.data, tb.terms.data, V_t, tb.pruned), psi_t)
    assert np.max(np.abs(H_t.numpy() - make.as_complex(REF["Hpsi"]))) < 1e-12


def test_psi_energies_match(setup):
    tb, V_t, _ = setup
    psi_t, _ = state_from_numpy(psi=make.orthonormal_rows(tb.mask_np, make.ENERGY_BANDS,
                                                          make.ENERGY_SEED), device="cpu")
    occ = torch.full((tb.n_kpoints, make.ENERGY_BANDS), 2.0, dtype=torch.float64)
    E_t = ham_ops.psi_energies(ham_ops.build_ham(tb.data, tb.terms.data, V_t, tb.pruned),
                               psi_t, occ, tb.data.kweights)
    assert set(E_t) == set(REF["psi_energies"])
    for name, want in REF["psi_energies"].items():
        assert abs(float(E_t[name]) - want) < 1e-12, name
