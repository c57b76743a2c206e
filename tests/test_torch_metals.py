"""dftk_tpu_torch's metals, collinear spin and GGA against the JAX package.

Small cells only, torch at one thread:
  * occupations, Fermi level and entropy of every smearing variant at three
    temperatures on seeded eigenvalues [4, 12] (1e-12), the smearing
    functions at |x| <= 40 (1e-14), and the band-count strategies;
  * PBE and PBEsol, unpolarised and polarised, with rho under 1e-14,
    sigma = 0 and zeta = +-1 among the points: energies 1e-12, the
    potentials (torch.autograd against jax.grad) 1e-10 and finite;
  * on Fe2 (collinear, PBE): guess_density with moments (1e-13), and
    total_potential and total_potential_split on the guess (1e-12);
    the JAX values of the occupations and of the two potentials, whose
    graphs take seconds to compile, come from the data file (below), the
    others from the JAX package in the test;
  * LdosMixing, KerkerDosMixing and HybridMixing on a seeded spin residual
    with a given LDOS (1e-10);
  * SCF and derivative anchors against the JAX package's CPU float64 values
    recorded in tests/data/torch_port_metals.json (each entry's `command`
    regenerates it): iron at Ecut 8, fft 16 on MP (2,2,2) + 1/2
    (paramagnetic at that cutoff) through `nbandsalg`, a T > 0 split SCF whose AdaptiveBands grows the block, and
    the displaced bcc Fe2 PBE cell's energy, forces and stresses (1e-8);
    and the data file's copies of the ABINIT goldens.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dftk_tpu as dftk
from dftk_tpu.models import smearing as jax_smearing
from dftk_tpu.ops.density import guess_density as jax_guess_density
from dftk_tpu.ops.xc import functionals as jax_xc
from dftk_tpu.scf import mixing as jax_mixing
from dftk_tpu.scf import nbands as jax_nbands

import dftk_tpu_torch as dt
from dftk_tpu_torch.interop import split_state_from_numpy, state_from_numpy
from dftk_tpu_torch.models import smearing
from dftk_tpu_torch.models.model import Model
from dftk_tpu_torch.ops import hamiltonian as hamops
from dftk_tpu_torch.ops.engine_split import prepare_split_data, total_potential_split
from dftk_tpu_torch.ops.forces_split import compute_forces_split
from dftk_tpu_torch.ops.occupation import compute_occupation, entropy_energy
from dftk_tpu_torch.ops.terms import AtomicLocal, Hartree, Kinetic, Xc
from dftk_tpu_torch.ops.xc import functionals as xc
from dftk_tpu_torch.scf import mixing, nbands

DATA = pathlib.Path(__file__).parent / "data"
A_FE = 5.42352
FE_PRIMITIVE = 2.71176 * np.array([[-1, 1, 1], [1, -1, 1], [1, 1, -1]], dtype=float)
FE2_POSITIONS = [np.zeros(3), np.ones(3) / 2 + np.array([0.004, -0.002, 0.001])]
AL_LATTICE = np.diag([4 * 7.6324708938577865, 7.6324708938577865, 7.6324708938577865])
AL_POSITIONS = [np.array([0, 0, 0]), np.array([0, 1 / 2, 1 / 2]),
                np.array([1 / 8, 0, 1 / 2]), np.array([1 / 8, 1 / 2, 0])]
SMEARINGS = {"FermiDirac": (), "Gaussian": (), "MarzariVanderbilt": (),
             "MethfesselPaxton0": (0,), "MethfesselPaxton1": (1,),
             "MethfesselPaxton2": (2,)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def reference():
    with open(DATA / "torch_port_metals.json") as f:
        return json.load(f)


def _smearings(name):
    cls = name.rstrip("012")
    args = SMEARINGS[name]
    return getattr(smearing, cls)(*args), getattr(jax_smearing, cls)(*args)


@pytest.mark.parametrize("name", list(SMEARINGS))
def test_occupation_and_entropy_match(name, reference):
    """compute_occupation and entropy_energy on seeded eigenvalues [4, 12]
    at T = 0.003, 0.01, 0.1 (8 electrons, filled 2): occupations, epsF and
    the entropy within 1e-12 of the JAX package's (the `occupations` entry
    of the data file: its compile of 18 Fermi searches takes seconds), the
    electron count within 1e-10."""
    port, _ = _smearings(name)
    evals = torch.as_tensor(np.sort(np.random.default_rng(21).normal(size=(4, 12)), axis=1))
    w = torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64)
    for T in (0.003, 0.01, 0.1):
        ref = reference["occupations"][f"{name} {T}"]
        occ, epsF = compute_occupation(evals, w, 8, 2.0, T, port)
        assert abs(float(epsF) - ref["epsF"]) < 1e-12
        assert np.abs(occ.numpy() - np.array(ref["occupation"])).max() < 1e-12
        assert abs(float(torch.sum(w[:, None] * occ)) - 8) < 1e-10
        S = entropy_energy(evals, w, epsF, T, port, 2.0)
        assert abs(float(S) - ref["entropy"]) < 1e-12


@pytest.mark.parametrize("name", list(SMEARINGS))
def test_smearing_at_large_x(name):
    """Occupation and entropy at |x| <= 40: no overflow of exp and no
    0 * inf in the entropies; within 1e-14 of the JAX package's."""
    port, ref = _smearings(name)
    x = np.linspace(-40.0, 40.0, 321)
    for fn in ("occupation", "entropy"):
        out = getattr(port, fn)(torch.as_tensor(x)).numpy()
        assert np.all(np.isfinite(out))
        assert np.abs(out - np.asarray(getattr(ref, fn)(jnp.asarray(x)))).max() < 1e-14


def test_band_strategies_match():
    """FixedBands and AdaptiveBands: the counts of a metal and an insulator,
    and the growth decision on seeded occupations, as the JAX package's."""
    Fe = dt.ElementPsp.from_symbol("Fe", psp="lda/fe-q8")
    model = dt.model_DFT(FE_PRIMITIVE, [Fe], [np.zeros(3)], functionals="PBE",
                         temperature=0.01, magnetic_moments=[4.0], symmetries=False)
    cold = dt.model_DFT(FE_PRIMITIVE, [Fe], [np.zeros(3)], functionals="PBE", symmetries=False)
    for port, ref in ((nbands.AdaptiveBands(), jax_nbands.AdaptiveBands()),
                      (nbands.FixedBands(7), jax_nbands.FixedBands(7))):
        assert port.bands(model) == ref.bands(model)
        assert port.bands(cold) == ref.bands(cold)
    occ = np.zeros((3, 10))
    occ[:, :7] = 1.0
    for top, grows in ((7, False), (8, True), (9, True)):
        occ[1, top] = 1e-6
        got = nbands.AdaptiveBands().update(torch.as_tensor(occ), None)
        assert got == jax_nbands.AdaptiveBands().update(occ, None)
        assert (got is not None) == grows


def _gga_inputs(nspin, seed):
    """rho [nspin, 64] and sigma with rho under 1e-14 (and exactly 0),
    sigma = 0, and under spin zeta = +1 and -1 among the points."""
    rng = np.random.default_rng(seed)
    rho = rng.random((nspin, 64)) * 0.5 + 1e-3
    rho[:, :4] = 1e-16
    rho[:, 4] = 0.0
    sigma = rng.random((1 if nspin == 1 else 3, 64)) * 0.1
    sigma[:, 8:12] = 0.0
    if nspin == 2:
        rho[1, 12:16] = 0.0          # zeta = +1
        rho[0, 16:20] = 0.0          # zeta = -1
        sigma[1] = rng.normal(size=64) * 0.02
    return rho, sigma


@pytest.mark.parametrize("nspin", [1, 2])
def test_gga_functionals_match(nspin):
    """Each functional of PBE and PBEsol: energy density within 1e-12, and
    its gradients in rho and sigma (torch.autograd against jax.grad, all
    four in one jitted call) within 1e-10 and finite everywhere."""
    rho, sigma = _gga_inputs(nspin, 30 + nspin)
    names = xc.FUNCTIONAL_SETS["PBE"] + xc.FUNCTIONAL_SETS["PBEsol"]

    @jax.jit
    def jax_values(a, b):
        out = []
        for name in names:
            f_j = jax_xc.FUNCTIONALS[name].energy
            out.append((f_j(a, b), jax.grad(lambda a, b: jnp.sum(f_j(a, b)),
                                            argnums=(0, 1))(a, b)))
        return out

    for name, (e_j, (gr_j, gs_j)) in zip(names, jax_values(jnp.asarray(rho),
                                                           jnp.asarray(sigma))):
        r = torch.tensor(rho, requires_grad=True)
        s = torch.tensor(sigma, requires_grad=True)
        e = xc.FUNCTIONALS[name].energy(r, s)
        gr, gs = torch.autograd.grad(e.sum(), (r, s))
        assert np.abs(e.detach().numpy() - np.asarray(e_j)).max() < 1e-12
        assert torch.isfinite(gr).all() and torch.isfinite(gs).all()
        assert np.abs(gr.numpy() - np.asarray(gr_j)).max() < 1e-10
        assert np.abs(gs.numpy() - np.asarray(gs_j)).max() < 1e-10


@pytest.fixture(scope="module")
def fe2_local():
    """Fe2 (conventional bcc, atom 1 moved), collinear, moments (4, 2), with
    the density-dependent local terms only (Kinetic, AtomicLocal, Hartree,
    Xc PBE), in both packages at Ecut 3, Gamma, fft 8^3."""
    def model(pkg, Model_, terms):
        Fe = pkg.ElementPsp.from_symbol("Fe", psp="lda/fe-q8")
        return Model_(A_FE * np.eye(3), [Fe, Fe], FE2_POSITIONS, term_types=terms,
                      magnetic_moments=[4.0, 2.0], temperature=0.01, symmetries=False)
    pbe = ("gga_x_pbe", "gga_c_pbe")
    jm = model(dftk, dftk.Model, [dftk.Kinetic(), dftk.AtomicLocal(), dftk.Hartree(),
                                  dftk.Xc(pbe)])
    tm = model(dt, Model, [Kinetic(), AtomicLocal(), Hartree(), Xc(pbe)])
    jb = dftk.PlaneWaveBasis(jm, Ecut=3.0, fft_size=(8, 8, 8))
    tb = dt.PlaneWaveBasis(tm, Ecut=3.0, fft_size=(8, 8, 8), device="cpu")
    return jb, tb


def test_guess_density_with_moments(fe2_local):
    jb, tb = fe2_local
    assert tb.model.spin_polarization == "collinear" and tb.n_kpoints == 2
    rho = dt.guess_density(tb, [4.0, 2.0]).numpy()
    ref = np.asarray(jax_guess_density(jb, magnetic_moments=[4.0, 2.0]))
    assert rho.shape == (2, 8, 8, 8)
    assert np.abs(rho - ref).max() < 1e-13
    magn = float(dt.spin_density(torch.as_tensor(rho)).sum()) * tb.dvol
    assert abs(magn - 6.0) < 1e-10
    assert abs(float(dt.total_density(torch.as_tensor(rho)).sum()) * tb.dvol - 16) < 1e-10


def test_total_potential_spin_pbe(fe2_local, reference):
    """The fused local potential of both spin channels and the energies on
    the guess density: total_potential against the JAX package's, and
    total_potential_split against its split engine's, 1e-12 (the
    `fe2_local_potential` entry of the data file: their GGA graphs take
    seconds to compile)."""
    jb, tb = fe2_local
    ref = reference["fe2_local_potential"]
    _, rho = state_from_numpy(rho=np.array(jax_guess_density(jb, magnetic_moments=[4.0, 2.0])),
                              device="cpu")
    vol = tb.model.unit_cell_volume
    V, _, E = hamops.total_potential(tb.terms, rho, vol)
    Vs, _, Es = total_potential_split(tb.terms, prepare_split_data(tb), rho, vol)
    assert V.shape == (2, 8, 8, 8)
    assert np.abs(V.numpy() - np.array(ref["V"])).max() < 1e-12
    assert np.abs(Vs.numpy() - np.array(ref["V_split"])).max() < 1e-12
    for k in ("AtomicLocal", "Hartree", "Xc"):
        assert abs(float(E[k]) - ref["energies"][k]) < 1e-12
        assert abs(float(Es[k]) - ref["energies_split"][k]) < 1e-12


@pytest.mark.parametrize("name", ["LdosMixing", "KerkerDosMixing", "HybridMixing"])
def test_ldos_mixings_match(name):
    """On a seeded spin residual [2, 8, 6, 5] with a given LDOS (summed over
    spins [1, ...] as the SCF driver gives it, and for KerkerDos per spin
    [2, ...]), within 1e-10 of the JAX package's."""
    rng = np.random.default_rng(40)
    shape = (2, 8, 6, 5)
    dF = rng.normal(size=shape)
    Gsq = rng.random(size=shape[1:]) * 4
    Gsq[0, 0, 0] = 0.0
    dvol, volume = 0.31, 0.31 * 240
    port, ref = getattr(mixing, name)(), getattr(jax_mixing, name)()
    # only KerkerDos reads the spin channels of the LDOS
    for nl in ((1, 2) if name == "KerkerDosMixing" else (1,)):
        ldos = rng.random(size=(nl,) + shape[1:]) * 0.05
        kw = dict(ldos=ldos, dvol=dvol)
        if name != "LdosMixing":
            kw["volume"] = volume
        out = port.mix_density(torch.as_tensor(dF), torch.as_tensor(Gsq),
                               **{k: torch.as_tensor(v) if k == "ldos" else v
                                  for k, v in kw.items()})
        ref_out = ref.mix_density(jnp.asarray(dF), jnp.asarray(Gsq),
                                  **{k: jnp.asarray(v) if k == "ldos" else v
                                     for k, v in kw.items()})
        assert np.abs(out.numpy() - np.asarray(ref_out)).max() < 1e-10


def test_iron_lda_anchor(reference):
    """test_iron_lda_small's problem (Ecut 8, fft 16, teter93, FermiDirac
    0.01, moment 4) on MP (2,2,2) + 1/2 through AdaptiveBands with 8 bands
    to converge: energy, Fermi level, magnetisation and electron count
    within 1e-8 of the JAX package's 8-band SCF."""
    ref = reference["iron_lda_small"]
    Fe = dt.ElementPsp.from_symbol("Fe", psp="lda/fe-q8")
    model = dt.model_DFT(FE_PRIMITIVE, [Fe], [np.zeros(3)], functionals=("lda_xc_teter93",),
                         temperature=0.01, magnetic_moments=[4.0],
                         smearing=dt.Smearing.FermiDirac())
    basis = dt.PlaneWaveBasis(model, Ecut=8.0, fft_size=(16, 16, 16), device="cpu",
                              kgrid=dt.MonkhorstPack((2, 2, 2), (0.5, 0.5, 0.5)))
    assert basis.n_kpoints == ref["n_kpoints"] and len(basis.symmetries) == ref["n_symmetries"]
    res = dt.self_consistent_field(basis, tol=1e-9, rho=dt.guess_density(basis, [4.0]),
                                   nbandsalg=dt.AdaptiveBands(n_bands_converge=8))
    rho = res.rho
    magn = float(dt.spin_density(rho).sum()) * basis.dvol
    n_el = float(rho.sum()) * basis.dvol
    dE = res.total_energy - ref["total_energy"]
    print(f"iron Ecut 8: E - E_JAX = {dE:.2e}, magnetisation {magn:.6f}, "
          f"{res.n_iter} iterations")
    assert res.converged and "Entropy" in res.energies
    assert abs(dE) < 1e-8 and abs(res.epsF - ref["epsF"]) < 1e-8
    assert abs(magn - ref["magnetisation"]) < 1e-8 and abs(n_el - 8) < 1e-8
    assert res.occupation.max() <= 1 + 1e-12


def test_split_scf_adaptive_bands_grow(reference):
    """A T > 0 split SCF whose AdaptiveBands grows 5 -> 8 -> 11 -> 14 (Al4,
    Ecut 3, Gamma, FermiDirac 0.01, 6 occupied bands): the same growth and
    the energy within 1e-8 of the JAX package's split SCF."""
    ref = reference["split_adaptive_small"]
    Al = dt.ElementPsp.from_symbol("Al", psp="lda/al-q3")
    model = dt.model_DFT(AL_LATTICE, [Al] * 4, AL_POSITIONS,
                         functionals=["lda_x", "lda_c_pw"], temperature=0.01)
    basis = dt.PlaneWaveBasis(model, Ecut=3.0, kgrid=(1, 1, 1), device="cpu")
    growth = []
    res = dt.self_consistent_field_split(
        basis, tol=1e-8, maxiter=80, n_bands=4, n_extra_bands=1, is_converged="density",
        callback=lambda info: growth.append(info["adaptive_bands"])
        if "adaptive_bands" in info else None)
    dE = res["energies"]["total"] - ref["total_energy"]
    print(f"split SCF with AdaptiveBands: E - E_JAX = {dE:.2e}, growth {growth}")
    assert res["converged"] and growth == ref["growth"]
    assert res["occupation"].shape[1] == ref["n_bands_final"]
    assert abs(dE) < 1e-8


def test_fe2_pbe_derivatives_anchor(reference):
    """The displaced bcc Fe2 cell of chip_smoke.py phase k4 at Ecut 6,
    Gamma: energy, magnetisation, forces and stresses within 1e-8 of the
    JAX package's; the split adapter's forces equal the complex path's on
    the same state."""
    ref = reference["fe2_pbe_derivatives_small"]
    Fe = dt.ElementPsp.from_symbol("Fe", psp="lda/fe-q8")
    model = dt.model_DFT(A_FE * np.eye(3), [Fe, Fe], FE2_POSITIONS, functionals="PBE",
                         temperature=0.01, smearing=dt.Smearing.FermiDirac(),
                         magnetic_moments=[4.0, 4.0])
    basis = dt.PlaneWaveBasis(model, Ecut=6.0, kgrid=dt.MonkhorstPack((1, 1, 1)), device="cpu")
    res = dt.self_consistent_field(basis, tol=1e-10, rho=dt.guess_density(basis, [4.0, 4.0]),
                                   maxiter=100)
    F = dt.compute_forces_cart(res).numpy()
    S = dt.compute_stresses_cart(res).numpy()
    magn = float(dt.spin_density(res.rho).sum()) * basis.dvol
    dE, dF = res.total_energy - ref["total_energy"], np.abs(F - ref["forces_cart"]).max()
    dS = np.abs(S - ref["stresses_cart"]).max()
    print(f"Fe2 PBE: E - E_JAX = {dE:.2e}, forces {dF:.2e}, stresses {dS:.2e}")
    assert res.converged and abs(dE) < 1e-8 and abs(magn - ref["magnetisation"]) < 1e-8
    assert dF < 1e-8 and dS < 1e-8
    U, rho, occ = split_state_from_numpy(
        U=np.concatenate([res.psi.real.numpy(), res.psi.imag.numpy()], axis=-1),
        rho=res.rho.numpy(), occupation=res.occupation, device="cpu")
    Fs = compute_forces_split(basis, None, U, occ, rho)
    assert float((Fs - dt.compute_forces(res)).abs().max()) < 1e-12


def test_abinit_copies_match(reference):
    """The data file's copies of the ABINIT goldens that chip_smoke.py phase
    k holds the port to equal tests/test_metals_spin.py's and
    tests/test_silicon_pbe.py's."""
    import inspect

    import test_metals_spin
    import test_silicon_pbe
    iron_lda, iron_pbe = reference["abinit_iron_lda"], reference["abinit_iron_pbe"]
    assert iron_pbe["eigenvalues"] == test_metals_spin.IRON_PBE_REF_EVALS.tolist()
    assert repr(iron_lda["total_energy"]) in inspect.getsource(
        test_metals_spin.test_iron_lda_golden)
    source = inspect.getsource(test_metals_spin.test_iron_pbe_golden)
    assert repr(iron_pbe["total_energy"]) in source and repr(iron_pbe["magnetisation"]) in source
    si = reference["abinit_silicon_pbe"]
    assert si["eigenvalues_k0"] == list(test_silicon_pbe.REF_EVALS_K0)
    assert si["total_energy"] == test_silicon_pbe.REF_ETOT
