"""dftk_tpu_torch's forces and stresses against the JAX package.

Si2 with atom 0 displaced, Ecut 7, fft_size (18,18,18), no symmetry, torch
at one thread.  The state is seeded random orbitals (4 occupied bands, 2
empty) and the JAX package's guess density, carried over with
`dftk_tpu_torch.interop`, on MonkhorstPack((2,2,2)): the inputs of
tests/data/make_torch_port_scf.py::entry_forces, whose JAX values
tests/data/torch_port_scf.json records (the entry's `command` reruns it;
the JAX package's gradients run there under jax.jit):
  * the Ewald energy and its position and lattice gradients, and the numpy
    twins, against the JAX package's: 1e-12;
  * compute_forces, compute_forces_cart and compute_forces_split against
    the JAX package's compute_forces and compute_forces_split (f64): 1e-12,
    the bar of tests/test_forces_split.py:41-46;
  * energy_at_lattice, compute_stresses_cart and compute_stresses_split
    against the JAX package's complex path: 1e-12; against its split path
    (whose Ewald and PspCorrection part is a finite difference) within the
    difference the JAX package shows between its own two paths.
The slice as a whole: the port's LOBPCG SCF and the JAX SCF on Gamma-only
Si2 to a density residual of 1e-10 agree on the energy (1e-9 Ha), the
forces (1e-7 Ha/bohr) and the stresses (1e-8 Ha/bohr^3), and
energy_at_lattice at the SCF lattice gives the port's SCF energy to 1e-10
(tests/test_forces_stresses.py:52-58); the JAX SCF's values are recorded
in tests/data/torch_port_si2_derivatives.json with the command that made
them.  Unported cases raise; NLCC derivatives equal central differences
of their energy; the derivatives symmetrized over the
displaced cell's four operations equal the JAX package's (1e-12).
"""
import copy
import dataclasses
import importlib.util
import json
import pathlib
import types

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.interop import state_from_numpy
from dftk_tpu_torch.symmetry import symmetry_operations
from dftk_tpu_torch.ops import ewald
from dftk_tpu_torch.ops.engine_split import prepare_split_data
from dftk_tpu_torch.ops.forces_split import compute_forces_split
from dftk_tpu_torch.ops.stresses_split import compute_stresses_split
from dftk_tpu_torch.postprocess import forces, stresses

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_scf", DATA / "make_torch_port_scf.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
SI_LATTICE = make.SI_LATTICE
POSITIONS = make.DISPLACED
OCC = make.FORCES_OCC
BAR = 1e-12


def _si2(pkg, kgrid, **kw):
    return make.si2_kgrid_basis(pkg, POSITIONS, kgrid, **kw)


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def ref():
    with open(DATA / "torch_port_scf.json") as f:
        return json.load(f)["forces"]


@pytest.fixture(scope="module")
def state(ref):
    """The injected state of the port: (the JAX entry, port basis, port
    state).  The orbitals are seeded numpy normals, orthonormalised on each
    k-point's sphere."""
    tb = _si2(dt, dt.MonkhorstPack((2, 2, 2)), device="cpu")
    psi = make.forces_state(tb.mask_np)
    occ = np.tile(OCC, (tb.n_kpoints, 1))
    psi_t, rho_t = state_from_numpy(psi=psi, rho=np.array(ref["rho"]), device="cpu")
    ts = types.SimpleNamespace(basis=tb, psi=psi_t, occupation=torch.as_tensor(occ),
                               rho=rho_t)
    return ref, tb, ts


@pytest.fixture(scope="module")
def jax_derivatives(ref):
    return dict(forces=np.array(ref["forces"]), forces_cart=np.array(ref["forces_cart"]),
                stresses=np.array(ref["stresses"]))


@pytest.fixture(scope="module")
def jax_ewald_values(ref):
    """The JAX package's Ewald energy and its position and lattice gradients
    for Si2's charges and positions."""
    e = ref["ewald"]
    return e["E"], np.array(e["g_pos"]), np.array(e["g_L"])


@pytest.mark.parametrize("what", ["energy", "forces", "lattice_gradient",
                                  "numpy_gradient", "numpy_energy"])
def test_ewald_matches(jax_ewald_values, what):
    q = np.array([4.0, 4.0])
    pos = np.stack(POSITIONS)
    E_ref, g_ref, gL_ref = jax_ewald_values
    if what == "energy":
        E = ewald.energy_ewald(SI_LATTICE, q, pos, device="cpu")
        assert E.dtype == torch.float64 and E.shape == ()
        assert abs(float(E) - E_ref) < BAR
    elif what == "forces":
        E, F = ewald.energy_forces_ewald(SI_LATTICE, q, pos, device="cpu")
        assert abs(float(E) - E_ref) < BAR and _max_diff(F, -g_ref) < BAR
    elif what == "lattice_gradient":
        L = torch.tensor(SI_LATTICE, requires_grad=True)
        (gL,) = torch.autograd.grad(ewald.energy_ewald(L, q, pos, device="cpu"), L)
        assert bool(torch.isfinite(gL).all()) and _max_diff(gL, gL_ref) < BAR
    elif what == "numpy_gradient":
        assert _max_diff(ewald.ewald_position_gradient_np(SI_LATTICE, q, pos), g_ref) < BAR
    else:
        assert abs(ewald.energy_ewald_np(SI_LATTICE, q, pos) - E_ref) < BAR


def test_forces_match(state, jax_derivatives):
    _, tb, ts = state
    F = dt.compute_forces(ts)
    Fc = dt.compute_forces_cart(ts)
    assert F.dtype == torch.float64 and F.shape == (2, 3)
    d = _max_diff(F, jax_derivatives["forces"])
    dc = _max_diff(Fc, jax_derivatives["forces_cart"])
    print(f"forces vs JAX: reduced {d:.2e}, Cartesian {dc:.2e}")
    assert d < BAR and dc < BAR


def test_forces_split_matches(state, jax_derivatives):
    """From the port's realified U (rows [x; y]) and occupation [nk, nb]."""
    ref, tb, ts = state
    U = torch.cat([ts.psi.real, ts.psi.imag], -1)
    F = compute_forces_split(tb, prepare_split_data(tb), U, ts.occupation, ts.rho)
    F_split = np.array(ref["forces_split"])
    d, ds = _max_diff(F, jax_derivatives["forces"]), _max_diff(F, F_split)
    print(f"split forces vs JAX: complex path {d:.2e}, split path {ds:.2e}")
    assert d < BAR and ds < BAR


def test_energy_at_lattice_matches(state):
    ref, tb, ts = state
    for L, E_ref in zip((SI_LATTICE, make.STRAIN @ SI_LATTICE), ref["energy_at_lattice"]):
        E = stresses.energy_at_lattice(tb, ts.psi, ts.occupation, torch.as_tensor(L))
        assert abs(float(E) - E_ref) < BAR


def test_stresses_match(state, jax_derivatives):
    ts = state[2]
    S = dt.compute_stresses_cart(ts)
    d = _max_diff(S, jax_derivatives["stresses"])
    print(f"stresses vs JAX: {d:.2e}")
    assert S.shape == (3, 3) and d < BAR


def test_stresses_split_matches(state, jax_derivatives):
    """The JAX split path takes its Ewald and PspCorrection part by central
    finite differences: the port is held to it within the difference the
    JAX package shows between its own two paths."""
    ref, tb, ts = state
    U = torch.cat([ts.psi.real, ts.psi.imag], -1)
    S = compute_stresses_split(tb, prepare_split_data(tb), U, ts.occupation)
    S_split = np.array(ref["stresses_split"])
    d = _max_diff(S, jax_derivatives["stresses"])
    ds = _max_diff(S, S_split)
    d_jax = _max_diff(S_split, jax_derivatives["stresses"])
    print(f"split stresses vs JAX: complex path {d:.2e}, split path {ds:.2e}; "
          f"JAX split vs JAX complex {d_jax:.2e}")
    assert d < BAR and ds < d_jax + BAR


def test_scf_derivatives_match():
    """The slice as a whole: the port's SCF on Gamma-only Si2 against the
    JAX SCF's energy, forces and stresses, recorded with the command in
    tests/data/torch_port_si2_derivatives.json."""
    with open(DATA / "torch_port_si2_derivatives.json") as f:
        ref = json.load(f)
    tb = _si2(dt, (1, 1, 1), device="cpu")
    res = dt.self_consistent_field(tb, tol=1e-10)
    assert res.converged and ref["converged"]
    dE = abs(res.total_energy - ref["total_energy"])
    dF = _max_diff(dt.compute_forces_cart(res), ref["forces_cart"])
    dS = _max_diff(dt.compute_stresses_cart(res), ref["stresses_cart"])
    E_lat = float(stresses.energy_at_lattice(tb, res.psi, res.occupation,
                                             torch.as_tensor(SI_LATTICE)))
    print(f"SCF vs JAX: energy {dE:.2e}, forces {dF:.2e}, stresses {dS:.2e}; "
          f"energy_at_lattice vs SCF energy {abs(E_lat - res.total_energy):.2e}")
    assert dE < 1e-9 and dF < 1e-7 and dS < 1e-8
    assert abs(E_lat - res.total_energy) < 1e-10


class _CorePsp(dt.models.psp_hgh.PspHgh):
    """lda/si-q4 with a Gaussian NLCC core density 0.3 e^{-p^2 / 2}."""

    def has_core_density(self):
        return True

    def core_density_fourier(self, p):
        return self.core_density_fourier_sq(np.asarray(p) ** 2)

    def core_density_fourier_sq(self, psq):
        return 0.3 * (torch.exp(-psq / 2) if torch.is_tensor(psq) else np.exp(-psq / 2))


def _nlcc_derivatives_match_differences(tb, ts, derivative):
    """The NLCC case: Si2 with a Gaussian core density on the injected
    state.  Its forces (or stresses) are -dE/dR (or dE/d strain / Omega) of
    the energy they differentiate: within 1e-8 of central differences of
    `_positions_energy` (or `energy_at_lattice`) at fixed orbitals, and the
    core term changes them."""
    psp = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4").psp
    Si = dt.ElementPsp(symbol="Si", Z=14, psp=_CorePsp(**{
        f.name: getattr(psp, f.name) for f in dataclasses.fields(psp)}))
    model = dt.model_DFT(SI_LATTICE, [Si, Si], POSITIONS, functionals=["lda_x", "lda_c_vwn"],
                         symmetries=False)
    basis = dt.PlaneWaveBasis(model, Ecut=7.0, kgrid=dt.MonkhorstPack((2, 2, 2)),
                              fft_size=(18, 18, 18), device="cpu")
    assert basis.terms.rho_core_np is not None
    h = 1e-5
    if derivative == "forces":
        F = forces.compute_forces(ts, basis)
        E = [float(forces._positions_energy(basis, ts.psi, ts.occupation, ts.rho,
                                            torch.as_tensor(np.stack(POSITIONS)
                                                            + s * h * np.eye(2 * 3)[0].reshape(2, 3))))
             for s in (1, -1)]
        fd, got, plain = -(E[0] - E[1]) / (2 * h), float(F[0, 0]), float(
            forces.compute_forces(ts, tb)[0, 0])
    else:
        S = stresses.compute_stresses_cart(ts, basis)
        L0 = torch.as_tensor(SI_LATTICE)
        eps = torch.zeros(3, 3, dtype=torch.float64)
        eps[0, 0] = h
        E = [float(stresses.energy_at_lattice(basis, ts.psi, ts.occupation,
                                              (torch.eye(3, dtype=torch.float64) + s * eps) @ L0))
             for s in (1, -1)]
        fd = (E[0] - E[1]) / (2 * h) / model.unit_cell_volume
        got, plain = float(S[0, 0]), float(stresses.compute_stresses_cart(ts, tb)[0, 0])
    print(f"NLCC {derivative}: autograd {got:.10e}, central difference {fd:.10e}, "
          f"without the core {plain:.10e}")
    assert abs(got - fd) < 1e-8 and abs(got - plain) > 1e-6


@pytest.mark.parametrize("derivative", ["forces", "stresses"])
@pytest.mark.parametrize("what", ["nlcc", "pairwise", "tau", "symmetry"])
def test_unported_raise(state, what, derivative):
    """What was refused before and now runs.  "pairwise" (item 11b): the
    forces add the PairwisePotential's forces (injected here), and the
    stresses raise NotImplementedError for a model with the term, as the
    JAX package's leave it out (ROADMAP Queue 3).  "symmetry" (item 5a) holds the derivatives symmetrized over the
    four operations of the displaced Si2 (detected by the port) against the
    JAX package's on the same basis, within 1e-12; "nlcc" (item 8b) holds
    the NLCC derivatives of a Gaussian core density to central differences
    of their energy (tests/test_torch_upf.py holds the NLCC and meta-GGA
    derivatives against the JAX package's); "tau" (item 8b): a tau on an LDA
    result does not enter its derivatives."""
    ref, tb, ts = state
    basis, res = copy.copy(tb), copy.copy(ts)
    fn = dt.compute_forces_cart if derivative == "forces" else dt.compute_stresses_cart
    if what == "nlcc":
        _nlcc_derivatives_match_differences(tb, ts, derivative)
        return
    elif what == "pairwise":
        basis.terms = copy.copy(tb.terms)
        basis.terms.pairwise_forces = np.random.default_rng(5).normal(size=(2, 3))
        if derivative == "forces":
            diff = dt.compute_forces(res, basis) - dt.compute_forces(ts, tb)
            assert _max_diff(diff, basis.terms.pairwise_forces) < 1e-15
            return
        from dftk_tpu_torch.ops.pairwise import lennard_jones
        basis.model = copy.copy(tb.model)
        basis.model.term_types = list(tb.model.term_types) + [
            dt.PairwisePotential(V=lennard_jones, params={})]
    elif what == "tau":
        res.tau = res.rho
        assert _max_diff(fn(res, basis), fn(ts, tb)) == 0.0
        return
    else:
        Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
        basis.symmetries = symmetry_operations(SI_LATTICE, [Si, Si], POSITIONS)
        assert len(basis.symmetries) == 4
        if derivative == "forces":
            out = dt.compute_forces_cart(res, basis).numpy()
            want = np.array(ref["symmetrized"]["forces_cart"])
        else:
            out = dt.compute_stresses_cart(res, basis).numpy()
            want = np.array(ref["symmetrized"]["stresses"])
        print(f"symmetrized {derivative} vs JAX: {_max_diff(out, want):.2e}")
        assert _max_diff(out, want) < BAR
        return
    with pytest.raises(NotImplementedError, match="PairwisePotential.*energy_at_lattice"):
        fn(res, basis)
