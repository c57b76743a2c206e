"""dftk_tpu_torch's meta-GGA path against the JAX package.

Torch at one thread; the JAX package's functions run under jax.jit:
  * SCAN, r2SCAN and TPSS (exchange and correlation), unpolarised and
    polarised, with rho under 1e-14 (and 0), sigma = 0, tau = 0, alpha = 1
    and (polarised) zeta = +-1 among the points: energy densities within
    1e-12, their gradients in rho, sigma and tau (torch.autograd against
    jax.grad, recorded in the data file below: their compile takes seconds)
    within 1e-10 and finite everywhere;
  * TB09: the Becke-Roussel solve and the mBJ potential of both spin
    settings within 1e-10;
  * on the displaced C2 of tests/torch_port_cells.py (C_m.upf: NLCC and
    tau_core): tau of seeded orbitals and the von Weizsaecker tau (1e-12),
    total_potential with tau (V, Vtau and the energies, 1e-12), and the
    exact H apply with the DivAgrad term, complex and split (1e-12);
  * the bf16 ('default') sphere apply (the JAX package's 'default' is
    exact on a CPU, so JAX has no bf16 apply to hold it to): by the 10x
    margin rule against a bf16 apply built term by term from the exact Ham
    (each p_a's DivAgrad chain on its own); and on a Ham without Vtau
    against the compact filter's 'default' apply;
  * SCF anchors against tests/data/torch_port_mgga.json (the JAX package's
    CPU float64 SCFs; each entry's `command` regenerates it): Gamma Si2
    SCAN through the LOBPCG SCF and the split SCF, and diamond C2 SCAN +
    NLCC through the split CheFSI SCF ("mixed", which under a meta-GGA
    filters with the sphere apply; its LOBPCG SCF is in
    tests/test_torch_upf.py), within 1e-8 Ha; and the data file's copy of
    DFTK's SCAN silicon golden.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dftk_tpu as dftk
from dftk_tpu.ops import hamiltonian as jax_ham
from dftk_tpu.ops.density import compute_kinetic_energy_density as jax_tau
from dftk_tpu.ops.density import guess_density as jax_guess_density
from dftk_tpu.ops.density import von_weizsaecker_tau as jax_vw_tau
from dftk_tpu.ops.xc import functionals as jax_xc
from dftk_tpu.ops.xc import tb09 as jax_tb09

import dftk_tpu_torch as dt
from dftk_tpu_torch.interop import mgga_from_numpy, state_from_numpy
from dftk_tpu_torch.kernels.local_apply import LocalFactors, local_apply_plain, round_bf16
from dftk_tpu_torch.ops import hamiltonian as hamops
from dftk_tpu_torch.ops.density import compute_kinetic_energy_density, von_weizsaecker_tau
from dftk_tpu_torch.ops.engine_split import (apply_H_split, compact_filter_ops,
                                             compute_tau_split, default_ham,
                                             prepare_split_data, sphere_filter_ops)
from dftk_tpu_torch.ops.pruned import compact_to_sphere, sphere_to_compact
from dftk_tpu_torch.ops.xc import functionals as xc
from dftk_tpu_torch.ops.xc import tb09

from torch_port_cells import C_POSITIONS, carbon_basis, displaced_carbon

DATA = pathlib.Path(__file__).parent / "data"
A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
MGGA = ("mgga_x_scan", "mgga_x_r2scan", "mgga_x_tpss", "mgga_c_tpss")
BAR = 1e-12
SPLIT = dict(eigensolver="chefsi", chebyshev_degree=10, chefsi_cycles=2,
             filter_precision="mixed", is_converged="density")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def reference():
    with open(DATA / "torch_port_mgga.json") as f:
        return json.load(f)


def _diff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("nspin", [1, 2])
def test_mgga_functionals_match(nspin, reference):
    """SCAN, r2SCAN, TPSS-x and TPSS-c on 64 points with rho under 1e-14
    (and 0), sigma = 0, tau = 0, alpha = 1 (unpolarised) and zeta = +-1
    (polarised) among them: energy density within 1e-12, its gradients in
    rho, sigma and tau within 1e-10 of the JAX package's (the
    `mgga_functionals` entry of the data file: the JAX graphs' compile
    takes seconds) and finite everywhere."""
    ref = reference["mgga_functionals"][str(nspin)]
    worst_e, worst_g = 0.0, 0.0
    for name in MGGA:
        args = [torch.tensor(ref[k], dtype=torch.float64, requires_grad=True)
                for k in ("rho", "sigma", "tau")]
        e = xc.FUNCTIONALS[name].energy(*args)
        grads = torch.autograd.grad(e.sum(), args)
        assert all(bool(torch.isfinite(g).all()) for g in grads), name
        worst_e = max(worst_e, _diff(e.detach().numpy(), ref[name]["energy"]))
        worst_g = max(worst_g, max(_diff(g.numpy(), ref[name][f"d_{k}"])
                                   for g, k in zip(grads, ("rho", "sigma", "tau"))))
    print(f"meta-GGA nspin={nspin}: energies {worst_e:.1e}, potentials {worst_g:.1e}")
    assert worst_e < 1e-12 and worst_g < 1e-10


@pytest.fixture(scope="module")
def carbon():
    return displaced_carbon()


@pytest.mark.parametrize("nspin", [1, 2])
def test_tb09_matches(carbon, nspin):
    """TB09 on the C2 guess density (polarised: split 0.6 / 0.4) with tau =
    tau_W + 0.2 rho^(5/3) (the port's guess and tau_W, which equal the JAX
    package's: test_tau_and_potentials_match, tests/test_torch_upf.py):
    the Becke-Roussel solve (both branches, equal to the JAX package's and
    its residual at roundoff) and the mBJ potential within 1e-10."""
    jb, tb = carbon
    rho1 = dt.guess_density(tb)
    rho_t = rho1 if nspin == 1 else torch.cat([0.6 * rho1, 0.4 * rho1])
    tau_t = von_weizsaecker_tau(rho_t, tb.terms.data.G_cart) + 0.2 * rho_t ** (5 / 3)
    rho, tau = rho_t.numpy(), tau_t.numpy()
    G = jnp.asarray(jb.G_cube_cart)
    y = np.concatenate([-np.logspace(-6, 4, 50), np.logspace(-6, 4, 50)])
    V_j, x_j = jax.jit(lambda r, t, y: (jax_tb09.tb09_potential(r, G, t),
                                        jax_tb09.br89_x_solve(y)))(
        jnp.asarray(rho), jnp.asarray(tau), jnp.asarray(y))
    x = tb09.br89_x_solve(torch.as_tensor(y))
    assert _diff(x.numpy(), x_j) < 1e-12
    assert float(((tb09._g(x) - torch.as_tensor(y)) / torch.as_tensor(y)).abs().max()) < 1e-10
    V = tb09.tb09_potential(rho_t, tb.terms.data.G_cart, tau_t)
    print(f"TB09 nspin={nspin}: potential {_diff(V.numpy(), V_j):.1e} from the JAX package's")
    assert torch.isfinite(V).all() and _diff(V.numpy(), V_j) < 1e-10


@pytest.fixture(scope="module")
def carbon_state(carbon):
    """Seeded orbitals (5 bands, 4 occupied) on the C2 sphere, the JAX
    guess density, and each package's tau, potentials and H."""
    jb, tb = carbon
    rng = np.random.default_rng(5)
    X = (rng.normal(size=(1, jb.nG_max, 5)) + 1j * rng.normal(size=(1, jb.nG_max, 5))) \
        * tb.mask_np[:, :, None]
    psi = np.linalg.qr(X)[0].transpose(0, 2, 1).copy()
    occ = np.array([[2.0, 2, 2, 2, 0]])
    rho = np.asarray(jax_guess_density(jb))
    vol = jb.model.unit_cell_volume
    G = jnp.asarray(jb.G_cube_cart)

    @jax.jit
    def jax_side(psi, occ, rho):
        tau = jax_tau(jb.data, jb.data.Gpk_cart, psi, occ, jb.fft_size, vol, 1)
        V, Vtau, E = jax_ham.total_potential(jb.terms, rho, G, vol, tau=tau)
        ham = jax_ham.build_ham(jb.data, jb.terms.data, V, Vtau=Vtau)
        return (tau, jax_vw_tau(rho, G), V, Vtau, E,
                jax_ham.apply_H(ham, psi, jb.fft_size, vol))

    ref = jax_side(jnp.asarray(psi), jnp.asarray(occ), jnp.asarray(rho))
    psi_t, rho_t = state_from_numpy(psi=psi, rho=rho, device="cpu")
    tau = compute_kinetic_energy_density(tb.data, psi_t, torch.as_tensor(occ), tb.fft_size,
                                         vol, 1)
    V, Vtau, E = hamops.total_potential(tb.terms, rho_t, vol, tau=tau)
    ham = hamops.build_ham(tb.data, tb.terms.data, V, tb.pruned, Vtau=Vtau)
    return dict(psi=psi_t, occ=torch.as_tensor(occ), rho=rho_t, tau=tau, V=V, Vtau=Vtau, E=E,
                ham=ham, ref=ref)


def test_tau_and_potentials_match(carbon, carbon_state):
    """tau of the seeded orbitals (and the split API's), the von Weizsaecker
    tau of the guess density, and total_potential with tau (the NLCC core
    density and core kinetic-energy density shift what the functional
    sees): V, Vtau and the energies within 1e-12 of the JAX package's; the
    JAX arrays carried over by interop give the same potentials."""
    _, tb = carbon
    s = carbon_state
    tau_j, vw_j, V_j, Vtau_j, E_j, _ = s["ref"]
    vol = tb.model.unit_cell_volume
    U = torch.cat([s["psi"].real, s["psi"].imag], dim=-1)
    tau_split = compute_tau_split(prepare_split_data(tb), U, s["occ"], tb.fft_size, vol, 1)
    errs = dict(tau=_diff(s["tau"].numpy(), tau_j),
                tau_split=_diff(tau_split.numpy(), s["tau"].numpy()),
                vw=_diff(von_weizsaecker_tau(s["rho"], tb.terms.data.G_cart).numpy(), vw_j),
                V=_diff(s["V"].numpy(), V_j), Vtau=_diff(s["Vtau"].numpy(), Vtau_j),
                energies=max(abs(float(s["E"][k]) - float(E_j[k])) for k in E_j))
    tau_c, _, rho_core, tau_core = mgga_from_numpy(
        tau=tau_j, rho_core=carbon[0].terms.rho_core_np, tau_core=carbon[0].terms.tau_core_np,
        device="cpu")
    terms2 = dataclasses.replace(tb.terms, data=tb.terms.data._replace(
        rho_core=rho_core, tau_core=tau_core))
    V2, Vtau2, _ = hamops.total_potential(terms2, s["rho"], vol, tau=tau_c)
    errs["interop"] = max(_diff(V2.numpy(), V_j), _diff(Vtau2.numpy(), Vtau_j))
    print("C2 tau and potentials against the JAX package: "
          + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
    assert float(s["Vtau"].abs().max()) > 1e-3 and max(errs.values()) < BAR


def test_divagrad_apply_matches(carbon, carbon_state):
    """H psi with the DivAgrad term, exact: the complex apply, the split
    API's realified apply (whole and band-chunked) and the sphere filter's
    'highest' apply, within 1e-12 of the JAX package's apply_H."""
    _, tb = carbon
    s = carbon_state
    H_j = np.asarray(s["ref"][-1])
    H = hamops.apply_H(s["ham"], s["psi"]).numpy()
    U = torch.cat([s["psi"].real, s["psi"].imag], dim=-1)
    nG = tb.nG_max
    out = {}
    for chunk in (None, 2):
        HU = apply_H_split(s["ham"], U, tb.fft_size, tb.model.unit_cell_volume, band_chunk=chunk)
        out[f"split (chunk {chunk})"] = _diff((HU[..., :nG] + 1j * HU[..., nG:]).numpy(), H_j)
    out["sphere filter"] = _diff(sphere_filter_ops(s["ham"], ("highest",))[0](s["psi"]).numpy(),
                                 H_j)
    out["complex"] = _diff(H, H_j)
    divagrad = hamops.apply_divagrad(s["ham"], s["psi"])
    print(f"DivAgrad apply against the JAX package (scale {np.abs(H_j).max():.2f}, DivAgrad "
          f"{float(divagrad.abs().max()):.2f}): "
          + ", ".join(f"{k} {v:.1e}" for k, v in out.items()))
    assert float(divagrad.abs().max()) > 1e-3 and max(out.values()) < BAR


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _default_apply_by_hand(ham, psi):
    """The bf16 ('default') H apply built term by term from the exact Ham:
    complex64 data and float32 potentials, each local part through the
    plain bf16 chain (the DivAgrad term one p_a at a time, not stacked),
    the nonlocal GEMMs on operands rounded to bf16.  Returns (H psi, its
    DivAgrad term)."""
    c64, f32 = torch.complex64, torch.float32
    pf = ham.pruned
    fac = LocalFactors(fwd=tuple(f.to(c64) for f in pf.factors.fwd),
                       bwd=tuple(f.to(c64) for f in pf.factors.bwd))
    mask, x, p = ham.mask.to(f32), psi.to(c64), ham.Gpk.to(f32)

    def local(y, V):
        return compact_to_sphere(local_apply_plain(sphere_to_compact(y, pf), V.to(f32), fac,
                                                   "default"), pf, mask)

    divagrad = sum(0.5 * p[:, None, :, a] * local(p[:, None, :, a] * x, ham.Vtau_zxy)
                   for a in range(3))
    P = round_bf16(ham.P.to(c64))
    DPd = torch.einsum("kgp,kng->knp", P.conj(), round_bf16(x)) @ ham.D.to(c64).T
    out = (ham.kin.to(f32)[:, None, :] * x + local(x, ham.V_zxy) + divagrad
           + torch.einsum("kgp,knp->kng", P, round_bf16(DPd)))
    return out * mask[:, None, :], divagrad


def test_default_sphere_apply_margin(carbon, carbon_state):
    """The bf16 ('default') sphere apply with the DivAgrad term, and that
    term alone, by the 10x margin rule: each one's difference from its
    counterpart built by hand (`_default_apply_by_hand`) is at most a
    tenth of that counterpart's difference from the exact one, the
    rounding, which is of bf16's size (1e-4 to 1e-2; relative Frobenius
    norms).  Without Vtau it equals the
    compact filter's 'default' apply (the same products in the same order;
    10x margin)."""
    _, tb = carbon
    s = carbon_state
    ham, psi = s["ham"], s["psi"]
    default, exact = sphere_filter_ops(ham, ("default", "highest"))
    Hd = default(psi).to(torch.complex128)
    assert default.dtype == torch.complex64
    c128 = lambda t: t.to(torch.complex128)
    by_hand, dag_hand = map(c128, _default_apply_by_hand(ham, psi))
    dag = c128(hamops.apply_divagrad(default_ham(ham), psi.to(torch.complex64), "default"))
    rounding, vs_hand = _rel(by_hand, exact(psi)), _rel(Hd, by_hand)
    dag_rounding = _rel(dag_hand, hamops.apply_divagrad(ham, psi))
    dag_vs_hand = _rel(dag, dag_hand)
    ham0 = ham._replace(Vtau_zxy=None, Gpk=None)
    enter, leave, apply_c = compact_filter_ops(ham0, tb.model.unit_cell_volume,
                                               precision="default")
    compact = leave(apply_c(enter(psi).to(torch.complex64))).to(torch.complex128)
    sphere = sphere_filter_ops(ham0, ("default",))[0](psi).to(torch.complex128)
    vs_compact = _rel(sphere, compact)
    print(f"'default' sphere apply: {vs_hand:.3e} from the bf16 apply built by hand, which "
          f"is {rounding:.3e} from the exact one; its DivAgrad term {dag_vs_hand:.3e} from the "
          f"one built by hand, {dag_rounding:.3e} from the exact one; without Vtau "
          f"{vs_compact:.1e} from the compact 'default'")
    assert 1e-4 < rounding < 1e-2 and 1e-4 < dag_rounding < 1e-2
    assert vs_hand * 10 <= rounding and dag_vs_hand * 10 <= dag_rounding
    assert vs_compact * 10 <= _rel(sphere, sphere_filter_ops(ham0, ("highest",))[0](psi))


def _silicon_scan():
    Si = dt.ElementPsp.from_symbol("Si", psp="pbe/si-q4")
    model = dt.model_DFT(SI_LATTICE, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                         functionals="SCAN")
    return dt.PlaneWaveBasis(model, Ecut=6.0, kgrid=(1, 1, 1), fft_size=(15, 15, 15),
                             device="cpu")


@pytest.mark.parametrize("cell", ["si2_scan_gamma", "c2_scan_nlcc"])
def test_mgga_scf_anchor(reference, cell):
    """Gamma Si2 SCAN (Ecut 6, fft 15), default symmetries, through the
    LOBPCG SCF and the split SCF with LOBPCG (its eigensolver floor at
    1e-10), and diamond C2 SCAN + NLCC (Ecut 10, fft 18) through the split
    CheFSI SCF ("mixed", which under a meta-GGA filters with the sphere
    apply; its LOBPCG SCF is tests/test_torch_upf.py's displaced-cell
    anchor), each to a density tolerance of 1e-7 and within 1e-8 Ha of the
    JAX package's run of the same loop to 1e-10 (the energy's error is
    second order in the density's), with tau."""
    ref = reference[cell]
    if cell == "si2_scan_gamma":
        basis = _silicon_scan()
        split = dict(eigensolver="lobpcg", is_converged="density", diagtol_min=1e-10)
        res = dt.self_consistent_field(basis, tol=1e-7, maxiter=60)
        dE = res.total_energy - ref["total_energy"]
        print(f"{cell}: LOBPCG E - E_JAX = {dE:.2e} ({res.n_iter} iterations)")
        assert res.converged and res.tau is not None and abs(dE) < 1e-8
    else:
        basis = carbon_basis(dt, C_POSITIONS, device="cpu")
        split = SPLIT
    assert len(basis.symmetries) == ref["n_symmetries"]
    sres = dt.self_consistent_field_split(basis, tol=1e-7, maxiter=100, **split)
    dEs = sres["energies"]["total"] - ref["split"]["total_energy"]
    print(f"{cell}: split E - E_JAX = {dEs:.2e} ({sres['n_iter']} iterations)")
    assert sres["converged"] and sres["tau"] is not None and abs(dEs) < 1e-8


def test_scan_golden_copy_matches(reference):
    """The data file's copy of DFTK's SCAN silicon golden, which
    chip_smoke.py phase l1 holds the port to, equals tests/test_scan.py's."""
    import test_scan
    golden = reference["silicon_scan_golden"]["golden"]
    assert golden["total_energy"] == test_scan.REF_ETOT
    assert golden["eigenvalues_k0"] == list(test_scan.REF_K0)
