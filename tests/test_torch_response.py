"""dftk_tpu_torch's response core (`response/chi0.py`, `response/hessian.py`)
against the JAX package.

Torch at one thread, the plain kernel versions, float64, on the JAX
package's own SCF states carried over by `interop.scf_state_from_numpy`
(from tests/data/torch_port_response.json, whose entries' `command`
regenerates them with tests/data/make_torch_port_response.py: the JAX
response functions compile for seconds each, so their values are
recorded) and the seeded inputs of that script:
  * on Gamma Si2 (LDA): the Hartree + XC kernel K drho (1e-12 relative),
    the product dV psi through the pruned local apply against the JAX
    package's full-cube one (1e-12), Omega + K on fixed (psi, dpsi)
    (1e-12) and its CG solve (1e-8, both to 1e-10), chi0 dV at
    Sternheimer tol 1e-12 (1e-9), and the Dyson solve with inexact GMRES
    against the exact one (1e-8);
  * on a small aluminium (T > 0, fractional occupations): chi0 dV at tol
    1e-12 and with the balanced band tolerances of density_tol 1e-7
    (1e-9), its charge conserved, and apply_chi0_generic's with_detail
    responses dpsi, df and depsF (1e-9);
  * the XC kernel of a spin-polarised PBE density against a central
    difference of the potential (1e-8), and TB09 and the meta-GGAs
    refused by the kernel.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.interop import scf_state_from_numpy
from dftk_tpu_torch.ops import hamiltonian as hamops
from dftk_tpu_torch.ops.density import compute_density, make_symmetrizer
from dftk_tpu_torch.response import chi0 as chi0_mod
from dftk_tpu_torch.response.hessian import apply_kernel, make_omega_plus_k, solve_dyson

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_response",
                                               DATA / "make_torch_port_response.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def reference():
    with open(DATA / "torch_port_response.json") as f:
        return json.load(f)


def injected_state(basis, entry):
    """The JAX SCF state of a data-file entry on the port's basis; rho is
    the port's density of the JAX orbitals (the JAX SCF's last density is
    that same function of them)."""
    s = entry["state"]
    assert list(basis.fft_size) == entry["fft_size"]
    psi, occ = make.as_complex(s["psi"]), np.array(s["occupation"])
    rho = compute_density(basis.data, basis.tensor(psi, basis.dtype), basis.tensor(occ),
                          basis.fft_size, basis.model.unit_cell_volume,
                          basis.model.n_spin_components, symmetrizer=make_symmetrizer(basis))
    return scf_state_from_numpy(basis, psi, occ, s["eigenvalues"], s["epsF"], rho.numpy())


@pytest.fixture(scope="module")
def si2(reference):
    basis = make.si2_basis(dt, device="cpu")
    entry = reference["si2_gamma"]
    inputs = make.seeded_inputs(basis.fft_size, basis.mask_np, make.N_OCC_SI2)
    return basis, entry, injected_state(basis, entry), inputs


def rel_err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape and np.isfinite(a).all()
    return np.abs(a - ref).max() / np.abs(ref).max()


def test_apply_kernel_matches_jax(si2):
    basis, entry, state, inputs = si2
    out = apply_kernel(basis, state.rho, torch.as_tensor(inputs["drho"]))
    err = rel_err(out, entry["apply_kernel"])
    print(f"K drho: {err:.2e} relative")
    assert err < 1e-12


def test_dV_psi_matches_full_cube(si2):
    basis, entry, state, inputs = si2
    ctx = chi0_mod.make_chi0_context(state, basis)
    out = chi0_mod.apply_dV(ctx.ham, ctx.psi, torch.as_tensor(inputs["dV"]), basis.data.kspin)
    err = rel_err(out, make.as_complex(entry["dV_psi"]))
    print(f"dV psi (pruned apply against the full cube): {err:.2e} relative")
    assert err < 1e-12


def test_omega_plus_k_apply_matches_jax(si2):
    basis, entry, state, inputs = si2
    n = make.N_OCC_SI2
    OmegaK, _, _ = make_omega_plus_k(basis, state.psi[:, :n], state.occupation[:, :n])
    out = OmegaK(torch.as_tensor(inputs["dpsi"]))
    err = rel_err(out, make.as_complex(entry["omega_plus_k"]))
    print(f"(Omega + K) dpsi: {err:.2e} relative")
    assert err < 1e-12
    ov = torch.einsum("kng,kmg->knm", state.psi[:, :n].conj(), out)
    assert float(ov.abs().max()) < 1e-12 * float(out.abs().max())      # in the tangent space


def test_solve_omega_plus_k_matches_jax(si2):
    basis, entry, state, inputs = si2
    n = make.N_OCC_SI2
    rhs = torch.as_tensor(inputs["dpsi"])
    chi0_mod.counts.reset()
    dpsi = dt.solve_omega_plus_k(basis, state.psi[:, :n], state.occupation[:, :n], rhs,
                                 cg_tol=1e-10)
    err = rel_err(dpsi, make.as_complex(entry["solve_omega_plus_k"]))
    OmegaK, Pc, _ = make_omega_plus_k(basis, state.psi[:, :n], state.occupation[:, :n])
    resid = float(torch.linalg.vector_norm(OmegaK(dpsi) + Pc(rhs)))
    print(f"(Omega + K)^-1: {err:.2e} relative, {chi0_mod.counts.steps['omega_plus_k']} CG "
          f"steps, residual {resid:.1e}")
    assert err < 1e-8 and resid < 1e-9


def test_apply_chi0_insulator_matches_jax(si2):
    basis, entry, state, inputs = si2
    ctx = chi0_mod.make_chi0_context(state, basis)
    chi0_mod.counts.reset()
    out = dt.apply_chi0(ctx, basis, torch.as_tensor(inputs["dV"]), tol=1e-12)
    err = rel_err(out, entry["chi0"])
    print(f"insulator chi0 dV: {err:.2e} relative, {chi0_mod.counts.steps['sternheimer']} CG "
          f"steps, {chi0_mod.counts.host_reads} host reads")
    assert err < 1e-9
    assert chi0_mod.counts.host_reads == chi0_mod.counts.steps["sternheimer"] + 1


@pytest.fixture(scope="module")
def al_small(reference):
    entry = reference["al_small"]
    basis = make.al_basis(dt, 5.0, dt.MonkhorstPack((2, 2, 2)), True, device="cpu")
    assert basis.n_kpoints == entry["n_kpoints"]
    ctx = chi0_mod.make_chi0_context(injected_state(basis, entry), basis)
    return basis, entry, ctx, torch.as_tensor(make.smooth_potential(basis.fft_size))


@pytest.mark.parametrize("density_tol", [None, 1e-7], ids=["tol", "balanced"])
def test_apply_chi0_metal_matches_jax(al_small, density_tol):
    basis, entry, ctx, dV = al_small
    out = dt.apply_chi0(ctx, basis, dV, tol=1e-12, density_tol=density_tol)
    err = rel_err(out, entry["chi0" if density_tol is None else "chi0_balanced"])
    charge = float(out.sum()) * basis.dvol
    print(f"metal chi0 dV (density_tol {density_tol}): {err:.2e} relative, charge {charge:.1e}")
    assert err < 1e-9 and abs(charge) < 1e-8


def test_apply_chi0_detail_matches_jax(al_small):
    """with_detail's orbital, occupation and Fermi-level responses."""
    basis, entry, ctx, dV = al_small
    dVpsi = chi0_mod.apply_dV(ctx.ham, ctx.psi, dV, basis.data.kspin)
    drho, dpsi, df, depsF = chi0_mod.apply_chi0_generic(ctx, basis, dVpsi, tol=1e-12,
                                                        with_detail=True)
    want = entry["detail"]
    errs = dict(drho=rel_err(drho, entry["chi0"]), dpsi=rel_err(dpsi, make.as_complex(want["dpsi"])),
                df=rel_err(df, want["df"]),
                depsF=abs(float(depsF) - want["depsF"]) / abs(want["depsF"]))
    print("chi0 detail, relative to the JAX package's: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    assert max(errs.values()) < 1e-9


def test_inexact_gmres_matches_exact(si2):
    basis, _, state, inputs = si2
    dV = torch.as_tensor(inputs["dV"])
    exact, _ = solve_dyson(state, dV, basis=basis, tol=1e-8)
    inexact, _ = solve_dyson(state, dV, basis=basis, tol=1e-8, inexact=True)
    diff = float((exact - inexact).abs().max())
    print(f"Dyson drho, inexact against exact GMRES: {diff:.2e} (max|drho| "
          f"{float(exact.abs().max()):.2e})")
    assert diff < 1e-8


def _pbe_spin_basis():
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dt.model_DFT(make.SI_LATTICE, [Si, Si], make.SI_POSITIONS, functionals="PBE",
                         magnetic_moments=[1.0, 0.5], symmetries=False)
    return dt.PlaneWaveBasis(model, Ecut=4.0, kgrid=(1, 1, 1), fft_size=(10, 10, 10),
                             device="cpu")


def test_xc_kernel_gga_spin_matches_finite_difference():
    """The double backward through the PBE energy with its spectral
    gradient, both spins: K drho against a central difference of
    total_potential (whose Hartree part is linear)."""
    basis = _pbe_spin_basis()
    rng = np.random.default_rng(5)
    rho = basis.tensor(0.02 + 0.01 * rng.random((2,) + basis.fft_size))
    drho = basis.tensor(rng.normal(size=(2,) + basis.fft_size))
    vol, h = basis.model.unit_cell_volume, 1e-7
    fd = (hamops.total_potential(basis.terms, rho + h * drho, vol)[0]
          - hamops.total_potential(basis.terms, rho - h * drho, vol)[0]) / (2 * h)
    err = rel_err(apply_kernel(basis, rho, drho), fd)
    print(f"PBE spin K drho against the central difference: {err:.2e} relative")
    assert err < 1e-8          # the difference's own error: 1.9e-10 at h = 1e-7, ~h^2


@pytest.mark.parametrize("functionals", ["TB09", "SCAN"])
def test_kernel_refuses_tau_functionals(functionals):
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dt.model_DFT(make.SI_LATTICE, [Si, Si], make.SI_POSITIONS, functionals=functionals)
    basis = dt.PlaneWaveBasis(model, Ecut=3.0, kgrid=(1, 1, 1), fft_size=(9, 9, 9), device="cpu")
    rho = dt.guess_density(basis)
    with pytest.raises(ValueError, match="rho alone"):
        apply_kernel(basis, rho, rho)
