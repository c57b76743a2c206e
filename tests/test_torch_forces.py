"""dftk_tpu_torch's forces and stresses against the JAX package.

Si2 with atom 0 displaced, Ecut 7, fft_size (18,18,18), no symmetry, torch
at one thread.  The state is seeded random orbitals (4 occupied bands, 2
empty) and the JAX package's guess density, carried over with
`dftk_tpu_torch.interop`, on MonkhorstPack((2,2,2)):
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

The JAX package's Ewald, compute_forces, energy_at_lattice and
compute_stresses_cart gradients run here under jax.jit: called eagerly
they spend most of the file's time compiling op by op.
"""
import copy
import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dftk_tpu as dftk
from dftk_tpu import symmetry as jax_symmetry
from dftk_tpu.ops import ewald as jax_ewald
from dftk_tpu.ops.density import guess_density as jax_guess_density
from dftk_tpu.ops.engine_split import prepare_split_data as jax_prepare_split_data
from dftk_tpu.ops.forces_split import compute_forces_split as jax_forces_split
from dftk_tpu.ops.stresses_split import compute_stresses_split as jax_stresses_split
from dftk_tpu.postprocess import forces as jax_forces
from dftk_tpu.postprocess import stresses as jax_stresses

import dftk_tpu_torch as dt
from dftk_tpu_torch.interop import state_from_numpy
from dftk_tpu_torch.symmetry import symmetry_operations
from dftk_tpu_torch.ops import ewald
from dftk_tpu_torch.ops.engine_split import prepare_split_data
from dftk_tpu_torch.ops.forces_split import compute_forces_split
from dftk_tpu_torch.ops.stresses_split import compute_stresses_split
from dftk_tpu_torch.postprocess import forces, stresses

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
POSITIONS = [np.array([0.127, 0.125, 0.123]), -np.ones(3) / 8]
OCC = [2.0, 2.0, 2.0, 2.0, 0.0, 0.0]
BAR = 1e-12
DATA = pathlib.Path(__file__).parent / "data"


def _si2(pkg, kgrid, **kw):
    Si = pkg.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = pkg.model_DFT(SI_LATTICE, [Si, Si], POSITIONS,
                          functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    return pkg.PlaneWaveBasis(model, Ecut=7.0, kgrid=kgrid, fft_size=(18, 18, 18), **kw)


def _max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def state():
    """The same injected state in both packages: (JAX basis, JAX state,
    port basis, port state).  The orbitals are seeded numpy normals,
    orthonormalised on each k-point's sphere."""
    jb = _si2(dftk, dftk.MonkhorstPack((2, 2, 2)))
    tb = _si2(dt, dt.MonkhorstPack((2, 2, 2)), device="cpu")
    rng = np.random.default_rng(1)
    shape = (jb.n_kpoints, jb.nG_max, len(OCC))
    X = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * tb.mask_np[:, :, None]
    psi = np.linalg.qr(X)[0].transpose(0, 2, 1).copy()
    rho = np.asarray(jax_guess_density(jb))
    occ = np.tile(OCC, (jb.n_kpoints, 1))
    js = types.SimpleNamespace(basis=jb, psi=jnp.asarray(psi), occupation=jnp.asarray(occ),
                               rho=jnp.asarray(rho))
    psi_t, rho_t = state_from_numpy(psi=psi, rho=rho, device="cpu")
    ts = types.SimpleNamespace(basis=tb, psi=psi_t, occupation=torch.as_tensor(occ),
                               rho=rho_t)
    return jb, js, tb, ts


def _jax_energy_at_lattice(basis, psi, occupation):
    """The JAX package's energy_at_lattice of a fixed state, jitted."""
    return jax.jit(lambda L: jax_stresses.energy_at_lattice(basis, psi, occupation, L))


def _jax_stresses(basis, psi, occupation):
    """The JAX package's compute_stresses_cart, its gradient jitted."""
    L0 = jnp.asarray(basis.model.lattice)
    energy = _jax_energy_at_lattice(basis, psi, occupation)
    grad = jax.jit(jax.grad(lambda eps: energy((jnp.eye(3) + (eps + eps.T) / 2) @ L0)))
    g = np.asarray(grad(jnp.zeros((3, 3)))) / basis.model.unit_cell_volume
    return jax_stresses.symmetrize_stresses(basis, (g + g.T) / 2)


def _jax_forces(basis, res):
    """The JAX package's compute_forces, its gradient jitted (the constants
    its energy turns into numpy evaluated while tracing)."""
    def energy(pos):
        with jax.ensure_compile_time_eval():
            return jax_forces._positions_energy(basis, res.psi, res.occupation, res.rho, pos)
    return -np.asarray(jax.jit(jax.grad(energy))(jnp.asarray(np.stack(basis.model.positions))))


@pytest.fixture(scope="module")
def jax_derivatives(state):
    jb, js, _, _ = state
    F = _jax_forces(jb, js)
    # compute_forces_cart's conversion
    Fc = jax_forces.symmetrize_forces(jb, F) @ np.linalg.inv(jb.model.lattice)
    return dict(forces=F, forces_cart=Fc, stresses=_jax_stresses(jb, js.psi, js.occupation))


@pytest.fixture(scope="module")
def jax_ewald_values():
    """The JAX package's Ewald energy and its position and lattice gradients
    for Si2's charges and positions."""
    q = jnp.array([4.0, 4.0])
    pos = jnp.asarray(np.stack(POSITIONS))
    eta = jax_ewald.default_eta(SI_LATTICE)
    boxes = dict(zip(("Gbox", "Rbox"), jax_ewald.ewald_sum_bounds(SI_LATTICE, pos, eta)))
    E, (g_L, g_pos) = jax.jit(jax.value_and_grad(
        lambda L, p: jax_ewald.energy_ewald(L, q, p, eta=eta, **boxes), argnums=(0, 1)))(
        jnp.asarray(SI_LATTICE), pos)
    return float(E), np.asarray(g_pos), np.asarray(g_L)


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
    _, _, tb, ts = state
    F = dt.compute_forces(ts)
    Fc = dt.compute_forces_cart(ts)
    assert F.dtype == torch.float64 and F.shape == (2, 3)
    d = _max_diff(F, jax_derivatives["forces"])
    dc = _max_diff(Fc, jax_derivatives["forces_cart"])
    print(f"forces vs JAX: reduced {d:.2e}, Cartesian {dc:.2e}")
    assert d < BAR and dc < BAR


def test_forces_split_matches(state, jax_derivatives):
    """From the port's realified U (rows [x; y]) and occupation [nk, nb]."""
    jb, js, tb, ts = state
    U = torch.cat([ts.psi.real, ts.psi.imag], -1)
    F = compute_forces_split(tb, prepare_split_data(tb), U, ts.occupation, ts.rho)
    F_split = np.asarray(jax_forces_split(
        jb, jax_prepare_split_data(jb, dtype=jnp.float64), jnp.asarray(U.numpy()),
        js.occupation, js.rho))
    d, ds = _max_diff(F, jax_derivatives["forces"]), _max_diff(F, F_split)
    print(f"split forces vs JAX: complex path {d:.2e}, split path {ds:.2e}")
    assert d < BAR and ds < BAR


def test_energy_at_lattice_matches(state):
    jb, js, tb, ts = state
    strain = np.eye(3) + 1e-2 * np.array([[1.0, 0.3, -0.2], [0.3, -0.5, 0.1],
                                          [-0.2, 0.1, 0.7]])
    energy_ref = _jax_energy_at_lattice(jb, js.psi, js.occupation)
    for L in (SI_LATTICE, strain @ SI_LATTICE):
        E = stresses.energy_at_lattice(tb, ts.psi, ts.occupation, torch.as_tensor(L))
        assert abs(float(E) - float(energy_ref(jnp.asarray(L)))) < BAR


def test_stresses_match(state, jax_derivatives):
    _, _, _, ts = state
    S = dt.compute_stresses_cart(ts)
    d = _max_diff(S, jax_derivatives["stresses"])
    print(f"stresses vs JAX: {d:.2e}")
    assert S.shape == (3, 3) and d < BAR


def test_stresses_split_matches(state, jax_derivatives):
    """The JAX split path takes its Ewald and PspCorrection part by central
    finite differences: the port is held to it within the difference the
    JAX package shows between its own two paths."""
    jb, js, tb, ts = state
    U = torch.cat([ts.psi.real, ts.psi.imag], -1)
    S = compute_stresses_split(tb, prepare_split_data(tb), U, ts.occupation)
    S_split = np.asarray(jax_stresses_split(
        jb, jax_prepare_split_data(jb, dtype=jnp.float64), jnp.asarray(U.numpy()),
        js.occupation))
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
    """Unported cases raise, naming their ROADMAP item (classical pairwise
    terms, item 11).  The other cases check what was refused before and now
    runs: "symmetry" (item 5a) holds the derivatives symmetrized over the
    four operations of the displaced Si2 (detected by the port) against the
    JAX package's on the same basis, within 1e-12; "nlcc" (item 8b) holds
    the NLCC derivatives of a Gaussian core density to central differences
    of their energy (tests/test_torch_upf.py holds the NLCC and meta-GGA
    derivatives against the JAX package's); "tau" (item 8b): a tau on an LDA
    result does not enter its derivatives."""
    jb, js, tb, ts = state
    basis, res = copy.copy(tb), copy.copy(ts)
    fn = dt.compute_forces_cart if derivative == "forces" else dt.compute_stresses_cart
    if what == "nlcc":
        _nlcc_derivatives_match_differences(tb, ts, derivative)
        return
    elif what == "pairwise":
        basis.terms = copy.copy(tb.terms)
        basis.terms.pairwise_forces = np.zeros((2, 3))
    elif what == "tau":
        res.tau = res.rho
        assert _max_diff(fn(res, basis), fn(ts, tb)) == 0.0
        return
    else:
        Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
        basis.symmetries = symmetry_operations(SI_LATTICE, [Si, Si], POSITIONS)
        jbs = copy.copy(jb)
        jbs.symmetries = [jax_symmetry.SymOp.make(op.W, op.w) for op in basis.symmetries]
        assert len(basis.symmetries) == 4
        if derivative == "forces":
            out = dt.compute_forces_cart(res, basis).numpy()
            ref = jax_forces.symmetrize_forces(jbs, _jax_forces(jb, js)) \
                @ np.linalg.inv(jb.model.lattice)
        else:
            out = dt.compute_stresses_cart(res, basis).numpy()
            ref = _jax_stresses(jbs, js.psi, js.occupation)
        print(f"symmetrized {derivative} vs JAX: {_max_diff(out, ref):.2e}")
        assert _max_diff(out, ref) < BAR
        return
    with pytest.raises(NotImplementedError, match="item 11"):
        fn(res, basis)
