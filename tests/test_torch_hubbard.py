"""dftk_tpu_torch's DFT+U (`ops/hubbard.py`) against the JAX package.

Torch at one thread, float64, on examples/hubbard.py's C2 PBE+U cell
(C_m.upf, U 0.15 Ha on the p manifolds of both atoms, Ecut 10, kgrid 2^3,
the default symmetries, so the occupation matrix is symmetrized over the
crystal's operations), on the seeded orbitals of
tests/data/make_torch_port_exx.py::entry_c2_hubbard, against the JAX
package's values in tests/data/torch_port_exx.json (entry `c2_hubbard`):
the projectors, the occupation matrix before and after the
symmetrization, the +U energy, its potential matrix and the apply V_U psi,
each within 1e-12; the split-engine adapters against the complex path
within 1e-10; the slice as a whole: the +U SCF in both loops (LOBPCG,
and the split SCF with CheFSI, whose filter then applies the exact H plus
V_U on the sphere) from the entry's seeded orbitals to a density residual
of 1e-8 (JAX's: 1e-10), total and Hubbard energies within 1e-8 Ha of the
JAX SCF's; and
the refusal of a manifold set that the crystal's operations do not close.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.ops import hubbard as hub

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_exx", DATA / "make_torch_port_exx.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
with open(DATA / "torch_port_exx.json") as _f:
    REF = json.load(_f)["c2_hubbard"]
BAR = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def c2():
    """(basis, Phi, slices, plan, psi, occ, n, n_sym) of the port."""
    basis = make.c2_hubbard_basis(dt, device="cpu")
    assert list(basis.fft_size) == REF["fft_size"] and basis.n_kpoints == REF["n_kpoints"]
    assert len(basis.symmetries) == REF["n_symmetries"] > 1
    mfs = basis.terms.hubbard_manifolds
    Phi, slices = hub.build_hubbard_projectors(basis, mfs)
    plan = hub.build_occupation_symmetrization(basis, mfs, slices)
    psi = torch.as_tensor(make.seeded_orbitals(basis.mask_np, 8, 7))
    occ = torch.as_tensor(make.aufbau(basis.n_kpoints, 8, 4))
    occ[:, 4] = 0.4
    bd = basis.data
    n = hub.occupation_matrix(Phi, psi, occ, bd.kweights, bd.kspin,
                              basis.model.n_spin_components)
    return basis, Phi, slices, plan, psi, occ, n, hub.symmetrize_occupation_matrix(n, slices,
                                                                                    plan)


def _close(out, ref, bar=BAR):
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = make.as_complex(ref) if isinstance(ref, dict) else np.asarray(ref)
    err = float(np.max(np.abs(out - ref)))
    print(f"max abs err {err:.1e} (max |ref| {np.max(np.abs(ref)):.1e})")
    assert err < bar * max(1.0, float(np.max(np.abs(ref))))


@pytest.mark.parametrize("what", ["projectors", "occupation", "symmetrized", "energy",
                                  "potential", "apply"])
def test_hubbard_matches_jax(c2, what):
    basis, Phi, slices, plan, psi, occ, n, n_sym = c2
    mfs = basis.terms.hubbard_manifolds
    filled = basis.model.filled_occupation
    if what == "projectors":
        assert [list(s) for s in slices] == REF["slices"]
        _close(Phi, REF["Phi"])
    elif what == "occupation":
        _close(n, REF["n"])
    elif what == "symmetrized":
        _close(n_sym, REF["n_sym"])
        # the average over the operations changed n: the rotations are live
        assert float((n_sym - n).abs().max()) > 1e-6
    elif what == "energy":
        E = hub.hubbard_energy(n_sym, mfs, slices, filled)
        assert abs(float(E) - REF["E"]) < BAR
    elif what == "potential":
        _close(hub.hubbard_potential_matrix(n_sym, mfs, slices, filled), REF["V"])
    else:
        V = hub.hubbard_potential_matrix(n_sym, mfs, slices, filled)
        _close(hub.apply_hubbard(Phi, V, basis.data.kspin, psi), REF["VUpsi"])


def _rows(X):
    return torch.cat([X.real, X.imag], -1)


@pytest.mark.parametrize("what", ["occupation", "symmetrize", "energy", "potential", "apply"])
def test_hubbard_split_adapters(c2, what):
    basis, Phi, slices, plan, psi, occ, n, n_sym = c2
    mfs = basis.terms.hubbard_manifolds
    filled = basis.model.filled_occupation
    bd = basis.data
    Phi_r = hub.realify_projectors(Phi)
    assert Phi_r.shape == (basis.n_kpoints, 6, 2 * basis.nG_max)
    if what == "occupation":
        nr, ni = hub.occupation_matrix_split(Phi_r, _rows(psi), occ, bd.kweights, bd.kspin, 1)
        out, ref = torch.complex(nr, ni), n
    elif what == "symmetrize":
        out = torch.complex(*hub.symmetrize_occupation_matrix_split(n.real, n.imag, slices,
                                                                     plan))
        ref = n_sym
    elif what == "energy":
        out = hub.hubbard_energy_split(n_sym.real, n_sym.imag, mfs, slices, filled)
        ref = hub.hubbard_energy(n_sym, mfs, slices, filled)
    elif what == "potential":
        out = torch.complex(*hub.hubbard_potential_matrix_split(n_sym.real, n_sym.imag, mfs,
                                                                 slices, filled))
        ref = hub.hubbard_potential_matrix(n_sym, mfs, slices, filled)
    else:
        V = hub.hubbard_potential_matrix(n_sym, mfs, slices, filled)
        out = hub.apply_hubbard_split(Phi_r, V.real, V.imag, bd.kspin, _rows(psi))
        ref = _rows(hub.apply_hubbard(Phi, V, bd.kspin, psi))
    _close(out, ref.numpy(), 1e-10)


@pytest.mark.parametrize("loop", ["lobpcg", "split"])
def test_hubbard_scf_matches_jax(c2, loop):
    basis = c2[0]
    n_occ = basis.model.default_n_bands()
    psi0 = make.seeded_orbitals(basis.mask_np, n_occ + 3, 8)
    kw = dict(tol=1e-8, maxiter=60)
    if loop == "lobpcg":
        res = dt.self_consistent_field(basis, psi=torch.as_tensor(psi0), **kw)
        E, conv = res.energies, res.converged
    else:
        res = dt.self_consistent_field_split(basis, U0=np.concatenate([psi0.real, psi0.imag], -1),
                                             eigensolver="chefsi", is_converged="density", **kw)
        E, conv = res["energies"], res["converged"]
    want = REF["scf"]["energies"]
    print(f"C2 PBE+U {loop}: total {abs(E['total'] - want['total']):.1e}, "
          f"Hubbard {abs(E['Hubbard'] - want['Hubbard']):.1e} Ha from JAX")
    assert conv and REF["scf"]["converged"]
    assert abs(E["total"] - want["total"]) < 1e-8
    assert abs(E["Hubbard"] - want["Hubbard"]) < 1e-8


def test_manifolds_not_closed_under_symmetry_raise():
    C = dt.ElementPsp.from_symbol("C", psp=make.C_UPF)
    model = dt.model_DFT(make.SI_LATTICE, [C, C], make.SI_POSITIONS, functionals="PBE",
                         extra_terms=[dt.Hubbard(manifolds=(dt.HubbardManifold(0, 1, 0.15),))])
    basis = dt.PlaneWaveBasis(model, Ecut=5.0, kgrid=(1, 1, 1), device="cpu")
    mfs = basis.terms.hubbard_manifolds
    _, slices = hub.build_hubbard_projectors(basis, mfs)
    with pytest.raises(ValueError, match="not closed"):
        hub.build_occupation_symmetrization(basis, mfs, slices)
