"""dftk_tpu_torch's crystal symmetry against the JAX package.

Small cells only, torch at one thread:
  * the lattice point group and the space-group operations of Si2, Si8
    conventional, Si2 with atom 0 moved along [111] and Si2 moved
    generically, from the native engine and from the numpy path, equal the
    JAX package's as sets (W exactly, w mod 1 within 1e-10);
  * on Si2 at Ecut 5, the Monkhorst-Pack IBZ k-points and weights (shifted
    and unshifted), `basis.symmetries`, the symmetric FFT size and the
    symmetrization maps (idx, tau, lowpass) equal the JAX basis' arrays;
  * the density symmetrizer against the JAX one on a seeded random density
    (1e-13), and idempotent; `symmetrize_forces` and `symmetrize_stresses`
    against the JAX functions on the same seeded inputs (1e-14);
  * the ABINIT silicon golden at Ecut 7 (grid 17, 4 irreducible k-points)
    through the port: ABINIT's eigenvalues and energy within 0.03, the k = 0
    triple degeneracy within 1e-7, and the energy within 1e-9 Ha of the
    JAX package's f64 SCF; the symmetric Si2 Gamma split SCF within 1e-9 Ha
    of the JAX package's `symmetrize=True` split SCF.  Both JAX values are
    recorded in tests/data/torch_port_symmetry.json with their commands,
    and the ABINIT numbers copied there from tests/testcases.py (which
    `test_abinit_copy_matches` holds);
  * `diag_full`, `DielectricMixing` and `lda_xc_teter93` against the JAX
    package's on the same inputs (1e-12).
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dftk_tpu as dftk
from dftk_tpu import symmetry as jax_symmetry
from dftk_tpu.ops.density import build_symmetrization_maps as jax_maps
from dftk_tpu.ops.density import make_symmetrizer as jax_symmetrizer
from dftk_tpu.ops.eigen.dense import diag_full as jax_diag_full
from dftk_tpu.ops.xc.functionals import lda_xc_teter93_energy as jax_teter93
from dftk_tpu.postprocess.forces import symmetrize_forces as jax_symmetrize_forces
from dftk_tpu.postprocess.stresses import symmetrize_stresses as jax_symmetrize_stresses
from dftk_tpu.scf.mixing import DielectricMixing as JaxDielectricMixing

import dftk_tpu_torch as dt
from dftk_tpu_torch import symmetry
from dftk_tpu_torch.ops.density import build_symmetrization_maps, make_symmetrizer
from dftk_tpu_torch.ops.eigen.dense import diag_full
from dftk_tpu_torch.ops.engine_split import make_symmetrizer_split
from dftk_tpu_torch.ops.xc.functionals import lda_xc_teter93_energy, resolve_functionals
from dftk_tpu_torch.postprocess.forces import symmetrize_forces
from dftk_tpu_torch.postprocess.stresses import symmetrize_stresses
from dftk_tpu_torch.scf.mixing import DielectricMixing

DATA = pathlib.Path(__file__).parent / "data"
A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
FCC = [np.array(p, dtype=float) for p in ([0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0])]
CELLS = {   # name: (lattice, positions)
    "si2": (SI_LATTICE, [np.ones(3) / 8, -np.ones(3) / 8]),
    "si8": (2 * A_SI * np.eye(3), [f + s * np.ones(3) / 8 for f in FCC for s in (1, -1)]),
    "si2_111": (SI_LATTICE, [np.ones(3) / 8 + 0.01, -np.ones(3) / 8]),
    "si2_generic": (SI_LATTICE, [np.array([0.13, 0.12, 0.125]), -np.ones(3) / 8]),
}
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def reference():
    with open(DATA / "torch_port_symmetry.json") as f:
        return json.load(f)


def _model(pkg, cell, **kw):
    lattice, positions = CELLS[cell]
    Si = pkg.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    return pkg.model_DFT(lattice, [Si] * len(positions), positions,
                         functionals=["lda_x", "lda_c_vwn"], **kw)


def _jax_basis(cell, Ecut, kgrid):
    """A JAX basis of the cell with the kinetic term only: its symmetries,
    k-points and grids are the full model's, without the seconds its Ewald
    term spends compiling."""
    lattice, positions = CELLS[cell]
    Si = dftk.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dftk.Model(lattice, [Si] * len(positions), positions, term_types=[dftk.Kinetic()])
    return dftk.PlaneWaveBasis(model, Ecut=Ecut, kgrid=kgrid)


def _op_set(ops):
    """{(W, w mod 1 rounded to 1e-10)} of a list of operations."""
    return {(tuple(map(tuple, np.asarray(op.W).tolist())),
             tuple(np.round(np.asarray(op.w, dtype=float), 10) % 1.0)) for op in ops}


def _same_ops(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x.W), np.asarray(y.W))
        d = np.asarray(x.w, dtype=float) - np.asarray(y.w, dtype=float)
        assert np.abs(d - np.round(d)).max() < 1e-10


@pytest.mark.parametrize("engine", ["native", "numpy"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_symmetry_operations_match(cell, engine, monkeypatch):
    lattice, positions = CELLS[cell]
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    if engine == "numpy":   # as where the engine's buffer is too small
        monkeypatch.setattr(symmetry, "native_symmetry_operations", lambda *a, **k: None)
    ops = symmetry.symmetry_operations(lattice, [Si] * len(positions), positions)
    ref = jax_symmetry.symmetry_operations(lattice, ["Si"] * len(positions), positions)
    assert len(ops) == len(ref) and _op_set(ops) == _op_set(ref)
    assert {op.W for op in ops} <= {tuple(map(tuple, W.tolist()))
                                    for W in symmetry.lattice_point_group(lattice)}
    point_group = lambda pg: sorted(tuple(W.ravel().tolist()) for W in pg)
    assert point_group(symmetry.lattice_point_group(lattice)) == \
        point_group(jax_symmetry.lattice_point_group(lattice))


def test_model_symmetries_default_and_explicit():
    """model_DFT's default detects the operations; an explicit list is taken
    as given; magnetic moments split the atoms by moment in the detection
    (antiparallel moments on Si2: the operations that swap the two atoms
    drop out), as in the JAX package."""
    model, ref = _model(dt, "si2_111"), _model(dftk, "si2_111")
    _same_ops(model.symmetries, ref.symmetries)
    inversion = jax_symmetry.SymOp.make(-np.eye(3, dtype=int), np.zeros(3))
    explicit = _model(dt, "si2", symmetries=[inversion])
    assert explicit.symmetries == [symmetry.SymOp.make(-np.eye(3, dtype=int), np.zeros(3))]
    magnetic, ref = (_model(pkg, "si2", magnetic_moments=[1.0, -1.0]) for pkg in (dt, dftk))
    assert magnetic.spin_polarization == "collinear"
    assert len(magnetic.symmetries) == 24
    _same_ops(magnetic.symmetries, ref.symmetries)


@pytest.fixture(scope="module", params=["unshifted", "shifted"])
def bases(request):
    """The JAX and port bases of Si2 with atom 0 moved along [111] at Ecut 5
    on MonkhorstPack (3, 3, 3), or (4, 4, 4) shifted by (1/2, 1/2, 1/2)."""
    size, shift = ((3, 3, 3), (0, 0, 0)) if request.param == "unshifted" \
        else ((4, 4, 4), (0.5, 0.5, 0.5))
    jb = _jax_basis("si2_111", 5.0, dftk.MonkhorstPack(size, shift))
    tb = dt.PlaneWaveBasis(_model(dt, "si2_111"), Ecut=5.0,
                           kgrid=dt.MonkhorstPack(size, shift), device="cpu")
    return jb, tb


def test_basis_symmetry_arrays_equal(bases):
    jb, tb = bases
    assert tb.fft_size == jb.fft_size and tb.n_irreducible_kpoints == jb.n_irreducible_kpoints
    np.testing.assert_array_equal(tb.kcoords, jb.kcoords)
    np.testing.assert_array_equal(tb.kweights, jb.kweights)
    _same_ops(tb.symmetries, jb.symmetries)
    a, b = jax_maps(jb), build_symmetrization_maps(tb)
    np.testing.assert_array_equal(b.idx, np.asarray(a.idx))
    np.testing.assert_array_equal(b.tau, np.asarray(a.tau))
    np.testing.assert_array_equal(b.lowpass, np.asarray(a.lowpass))


def test_symmetrizer_matches_and_is_idempotent(bases):
    jb, tb = bases
    rho = np.random.default_rng(12).random((1,) + tb.fft_size)
    sym = make_symmetrizer(tb)
    out = sym(torch.as_tensor(rho))
    ref = np.asarray(jax_symmetrizer(jb)(jnp.asarray(rho)))
    assert np.abs(out.numpy() - ref).max() < 1e-13
    assert float((sym(out) - out).abs().max()) < 1e-13
    assert make_symmetrizer_split(tb) is not None


@pytest.mark.parametrize("cell", ["si2", "si2_111"])
def test_symmetrize_forces_stresses_match(cell):
    jb = _jax_basis(cell, 4.0, dftk.MonkhorstPack((2, 2, 2)))
    tb = dt.PlaneWaveBasis(_model(dt, cell), Ecut=4.0, kgrid=dt.MonkhorstPack((2, 2, 2)),
                           device="cpu")
    assert len(tb.symmetries) > 1
    rng = np.random.default_rng(13)
    F, S = rng.normal(size=(2, 3)), rng.normal(size=(3, 3))
    S = (S + S.T) / 2
    dF = symmetrize_forces(tb, torch.as_tensor(F)).numpy() - jax_symmetrize_forces(jb, F)
    dS = symmetrize_stresses(tb, torch.as_tensor(S)).numpy() - jax_symmetrize_stresses(jb, S)
    assert np.abs(dF).max() < 1e-14 and np.abs(dS).max() < 1e-14


def test_silicon_golden_small(reference):
    """The ABINIT golden at Ecut 7 through the port (tests/test_silicon_scf.py::
    test_silicon_lda_small's problem), to a density residual of 1e-8 (the
    energy's error is second order in it: 1.4e-14 from the JAX value, as
    at 1e-10)."""
    abinit = reference["abinit_silicon_lda"]
    basis = dt.PlaneWaveBasis(_model(dt, "si2"), Ecut=7.0,
                              kgrid=dt.ExplicitKpoints(*abinit["kpoints"]),
                              fft_size=(17, 17, 17), device="cpu")
    assert len(basis.symmetries) == reference["golden_ecut7"]["n_symmetries"]
    res = dt.self_consistent_field(basis, tol=1e-8, n_bands=8)
    assert res.converged
    assert np.abs(res.eigenvalues[:, :8] - np.array(abinit["eigenvalues"])).max() < 0.03
    assert abs(res.total_energy - abinit["total_energy"]) < 0.03
    e = res.eigenvalues[0]
    assert abs(e[1] - e[3]) < 1e-7
    dE = abs(res.total_energy - reference["golden_ecut7"]["total_energy"])
    print(f"golden Ecut 7: E - E_JAX = {dE:.2e}, k=0 degeneracy {abs(e[1] - e[3]):.2e}")
    assert dE < 1e-9


def test_abinit_copy_matches(reference):
    """The data file's copy of the ABINIT golden equals tests/testcases.py's."""
    from testcases import silicon, silicon_lda_ref_etot, silicon_lda_ref_evals
    abinit = reference["abinit_silicon_lda"]
    assert abinit["eigenvalues"] == silicon_lda_ref_evals
    assert abinit["total_energy"] == silicon_lda_ref_etot
    assert [list(map(float, k)) for k in abinit["kpoints"][0]] == \
        [list(k) for k in silicon["kgrid"].kcoords]
    assert abinit["kpoints"][1] == list(silicon["kgrid"].kweights)


def test_split_scf_symmetric_si2(reference):
    """The symmetric Gamma-only Si2 split SCF to a density residual of 1e-8
    (12 iterations; 1.5e-12 Ha from the JAX value converged to 1e-10)."""
    ref = reference["si2_split_symmetric"]
    basis = dt.PlaneWaveBasis(_model(dt, "si2"), Ecut=7.0, kgrid=(1, 1, 1), device="cpu")
    assert list(basis.fft_size) == ref["fft_size"]
    assert len(basis.symmetries) == ref["n_symmetries"]
    res = dt.self_consistent_field_split(basis, tol=1e-8, is_converged="density",
                                         symmetrize=True)
    dE = abs(res["energies"]["total"] - ref["total_energy"])
    print(f"symmetric Si2 split SCF: E - E_JAX = {dE:.2e}")
    assert res["converged"] and dE < 1e-9


def test_diag_full_matches():
    """diag_full of a seeded Hermitian operator with padded entries against
    the JAX package's: eigenvalues within 1e-9, the rounding of a matrix
    that holds the 1e6 shift of the padded entries (1e6 x 2.2e-16 x a few),
    and the same eigenvectors."""
    rng = np.random.default_rng(14)
    nk, nG, nb = 2, 12, 4
    H = rng.normal(size=(nk, nG, nG)) + 1j * rng.normal(size=(nk, nG, nG))
    H = H + H.conj().transpose(0, 2, 1)
    mask = np.ones((nk, nG))
    mask[1, -3:] = 0
    Ht, Hj = torch.as_tensor(H), jnp.asarray(H)
    mt, mj = torch.as_tensor(mask), jnp.asarray(mask)
    w, X = diag_full(lambda X: torch.einsum("kgh,knh->kng", Ht, X) * mt[:, None],
                     nk, nG, mt, nb)
    wj, Xj = jax_diag_full(lambda X: jnp.einsum("kgh,knh->kng", Hj, X) * mj[:, None],
                           nk, nG, mj, nb)
    assert np.abs(w.numpy() - np.asarray(wj)).max() < 1e-9
    overlap = np.abs(np.einsum("kng,kmg->knm", X.numpy().conj(), np.asarray(Xj)))
    assert np.abs(overlap - np.eye(nb)).max() < 1e-10


@pytest.mark.parametrize("nspin", [1, 2])
def test_dielectric_mixing_and_teter93_match(nspin):
    rng = np.random.default_rng(15 + nspin)
    shape = (nspin, 6, 5, 4)
    dF, rho = rng.normal(size=shape), rng.random(size=shape) + 0.01
    Gsq = rng.random(size=shape[1:]) * 4
    Gsq[0, 0, 0] = 0.0
    mix = DielectricMixing(epsilon_r=8.0).mix_density(torch.as_tensor(dF), torch.as_tensor(Gsq))
    ref = JaxDielectricMixing(epsilon_r=8.0).mix_density(jnp.asarray(dF), jnp.asarray(Gsq))
    assert np.abs(mix.numpy() - np.asarray(ref)).max() < 1e-12
    e = lda_xc_teter93_energy(torch.as_tensor(rho)).numpy()
    assert np.abs(e - np.asarray(jax_teter93(jnp.asarray(rho)))).max() < 1e-12
    [(fun, _)] = resolve_functionals(["lda_xc_teter93"])
    assert fun.energy is lda_xc_teter93_energy
