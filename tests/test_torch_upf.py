"""dftk_tpu_torch's UPF pseudopotentials, the other elements and the NLCC
core densities against the JAX package.

Torch at one thread; the JAX package's evaluators are numpy, so they run
live here:
  * the three UPF files of tests/data/pseudos (C_m and Al_m: ONCVPSP
    meta-GGA files with NLCC and PP_TAUMOD; gth/Si.pbe-hgh.upf): every
    parsed field equal, Simpson weights (uniform and nonuniform grids),
    the Hankel transforms and every evaluator within 1e-12, each `*_sq`
    evaluator equal to its plain one on numpy arrays and torch tensors
    (1e-12), its slope in p^2 (the stresses' derivative) within 1e-7 of
    the value's scale of a Richardson central difference, and its
    curvature (the elastic response's second derivative, autograd twice)
    within 1e-7 of scale of a Richardson central difference of the slope;
  * ElementCoulomb, ElementGaussian, ElementCohenBergstresser and a
    virtual-crystal PspLinComb (C_m + Al_m): local potentials, charges,
    decay lengths, projectors, couplings and core densities (1e-12);
  * on displaced diamond C2 (C_m.upf, SCAN, Ecut 10, fft 18, Gamma): the
    core density and core kinetic-energy density on the grid, the
    projectors, the local potential, the psp correction and the guess
    density from PP_RHOATOM (1e-12);
  * against tests/data/torch_port_mgga.json (the JAX package's CPU float64
    SCFs; each entry's `command` regenerates it): silicon PBE from the GTH
    UPF file (Ecut 7, fft 17, the silicon k-set) within 1e-8 Ha of the JAX
    run and 5e-4 Ha of the HGH one (tests/test_psp_upf.py:71-87); the
    displaced C2's SCAN + NLCC LOBPCG SCF within 1e-8 Ha, its forces (the
    NLCC and tau_core terms included) within 1e-7 Ha/bohr and stresses
    within 1e-8 Ha/bohr^3, the split adapters equal to the complex path.
"""
import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import torch

import dftk_tpu as dftk
from dftk_tpu.models import elements as jax_elements
from dftk_tpu.models import psp_upf as jax_upf
from dftk_tpu.ops.density import guess_density as jax_guess_density

import dftk_tpu_torch as dt
from dftk_tpu_torch.models import elements, psp_upf
from dftk_tpu_torch.ops.forces_split import compute_forces_split
from dftk_tpu_torch.ops.stresses_split import compute_stresses_split

from torch_port_cells import displaced_carbon

DATA = pathlib.Path(__file__).parent / "data"
UPFS = {"C_m": DATA / "pseudos" / "C_m.upf", "Al_m": DATA / "pseudos" / "Al_m.upf",
        "Si_gth": DATA / "pseudos" / "gth" / "Si.pbe-hgh.upf"}
A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
SI_KPOINTS = ([[0, 0, 0], [1 / 3, 0, 0], [1 / 3, 1 / 3, 0], [-1 / 3, 1 / 3, 0]],
              [1 / 27, 8 / 27, 6 / 27, 12 / 27])
P_GRID = np.linspace(0.0, 12.0, 61)
BAR = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def reference():
    with open(DATA / "torch_port_mgga.json") as f:
        return json.load(f)


def _diff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _evaluators(psp):
    """(name, plain(p), sq(psq) or None) of every radial evaluator of psp."""
    out = [("local", psp.local_fourier, psp.local_fourier_sq)]
    for l in range(psp.lmax + 1):
        for i in range(1, psp.n_proj_radial(l) + 1):
            out.append((f"projector {i} l={l}",
                        lambda p, i=i, l=l: psp.projector_fourier(i, l, p),
                        lambda s, i=i, l=l: psp.projector_fourier_sq(i, l, s)))
    for l in range(len(psp.r2_pswfcs)):
        for i in range(1, psp.n_pswfc_radial(l) + 1):
            out.append((f"pswfc {i} l={l}", lambda p, i=i, l=l: psp.pswfc_fourier(i, l, p), None))
    if psp.has_valence_density():
        out.append(("valence", psp.valence_density_fourier, None))
    if psp.has_core_density():
        out.append(("core", psp.core_density_fourier, psp.core_density_fourier_sq))
    if psp.has_core_tau():
        out.append(("core tau", psp.core_tau_fourier, psp.core_tau_fourier_sq))
    return out


@pytest.mark.parametrize("name", list(UPFS))
def test_upf_parse_and_evaluators_match(name):
    """Every parsed field of the file equal to the JAX package's; the
    evaluators at |p| in [0, 12] within 1e-12; each `*_sq` equal to its
    plain evaluator on numpy and torch p^2 (1e-12), its slope (torch
    autograd through the tensor path) within 1e-7 of scale of a Richardson
    central difference of the plain evaluator in p^2 (|p| in [1, 12]),
    and its curvature (autograd of the slope's graph) within 1e-7 of scale
    of a Richardson central difference of the slope."""
    port, ref = psp_upf.parse_upf(str(UPFS[name])), jax_upf.parse_upf(str(UPFS[name]))
    for f in dataclasses.fields(ref):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name
    r = np.asarray(port.rgrid)
    assert _diff(psp_upf.simpson_weights(r), jax_upf.simpson_weights(r)) < BAR
    r_nonuniform = np.cumsum(np.linspace(0.01, 0.03, 101))
    assert _diff(psp_upf.simpson_weights(r_nonuniform),
                 jax_upf.simpson_weights(r_nonuniform)) < BAR
    for l in range(4):
        assert _diff(psp_upf.hankel(r, port.r2_rho_ion, l, P_GRID),
                     jax_upf.hankel(r, ref.r2_rho_ion, l, P_GRID)) < BAR
    assert abs(port.energy_correction() - ref.energy_correction()) < BAR
    worst, worst_slope, worst_curv = 0.0, 0.0, 0.0
    p_fd = P_GRID[P_GRID >= 1.0]

    def richardson(f):
        h = 1e-3 * p_fd ** 2
        fd = lambda h: (f(p_fd ** 2 + h) - f(p_fd ** 2 - h)) / (2 * h)
        return (4 * fd(h / 2) - fd(h)) / 3

    for (label, plain, sq), (_, plain_ref, _) in zip(_evaluators(port), _evaluators(ref)):
        value = plain(P_GRID)
        worst = max(worst, _diff(value, plain_ref(P_GRID)))
        if sq is None:
            continue
        assert _diff(sq(P_GRID ** 2), value) < BAR, label

        def slope_of(q, sq=sq):
            psq = torch.tensor(q, requires_grad=True)
            return torch.autograd.grad(sq(psq).sum(), psq)[0].numpy()

        psq = torch.tensor(p_fd ** 2, requires_grad=True)
        out = sq(psq)
        (slope,) = torch.autograd.grad(out.sum(), psq, create_graph=True)
        (curv,) = torch.autograd.grad(slope.sum(), psq)
        assert _diff(out.detach().numpy(), plain(p_fd)) < BAR, label
        fd = richardson(lambda q: plain(np.sqrt(q)))
        worst_slope = max(worst_slope, _diff(slope.detach().numpy(), fd)
                          / max(np.abs(fd).max(), 1e-300))
        fd = richardson(slope_of)
        worst_curv = max(worst_curv, _diff(curv.numpy(), fd) / max(np.abs(fd).max(), 1e-300))
    print(f"{name}: evaluators {worst:.2e} from the JAX package's; slopes {worst_slope:.2e}, "
          f"curvatures {worst_curv:.2e} (relative) from central differences")
    assert worst < BAR and worst_slope < 1e-7 and worst_curv < 1e-7


def test_other_elements_match():
    """ElementCoulomb, ElementGaussian and ElementCohenBergstresser (local
    potentials on numpy |p| and torch p^2, charges, decay lengths), and the
    virtual-crystal PspLinComb of C_m and Al_m (x = 0.3), against the JAX
    package's: 1e-12."""
    p = np.linspace(0.0, 6.0, 121)
    cases = [(elements.ElementCoulomb(Z=3), jax_elements.ElementCoulomb(Z=3)),
             (elements.ElementGaussian(alpha=1.7, L=0.8), jax_elements.ElementGaussian(alpha=1.7, L=0.8)),
             (elements.ElementCohenBergstresser("Ge"), jax_elements.ElementCohenBergstresser("Ge"))]
    unit = 2 * math.pi / jax_elements.ElementCohenBergstresser("Ge").lattice_constant
    for port, ref in cases:
        q = np.sort(np.concatenate([p, unit * np.sqrt([3.0, 8.0, 11.0])]))
        assert _diff(port.local_potential_fourier(q), ref.local_potential_fourier(q)) < BAR
        assert port.charge_ionic() == ref.charge_ionic()
        assert elements.atom_decay_length(port) == jax_elements.atom_decay_length(ref)
        if not isinstance(port, elements.ElementCohenBergstresser):
            t = port.local_potential_fourier_sq(torch.as_tensor(q[1:] ** 2))
            assert _diff(t.numpy(), ref.local_potential_fourier(q[1:])) < BAR
    els = [dt.ElementPsp.from_symbol(s, psp=str(UPFS[f])) for s, f in (("C", "C_m"), ("Al", "Al_m"))]
    jels = [dftk.ElementPsp.from_symbol(s, psp=str(UPFS[f])) for s, f in (("C", "C_m"), ("Al", "Al_m"))]
    vca = dt.virtual_crystal_approximation(*els, 0.3)
    jvca = dftk.virtual_crystal_approximation(*jels, 0.3)
    assert vca.Z == jvca.Z and vca.psp.Zion == jvca.psp.Zion
    assert vca.psp.lmax == jvca.psp.lmax and vca.psp.n_proj() == jvca.psp.n_proj()
    for l in range(vca.psp.lmax + 1):
        assert _diff(vca.psp.h[l], jvca.psp.h[l]) == 0.0
        for i in range(1, vca.psp.n_proj_radial(l) + 1):
            assert _diff(vca.psp.projector_fourier(i, l, p),
                         jvca.psp.projector_fourier(i, l, p)) < BAR
    for fn in ("local_fourier", "core_density_fourier", "core_tau_fourier"):
        assert _diff(getattr(vca.psp, fn)(p), getattr(jvca.psp, fn)(p)) < BAR, fn
    assert abs(vca.psp.energy_correction() - jvca.psp.energy_correction()) < BAR


@pytest.fixture(scope="module")
def carbon():
    """The displaced C2 (SCAN, C_m.upf) in both packages
    (tests/torch_port_cells.py)."""
    return displaced_carbon()


def test_nlcc_terms_match(carbon):
    """On the displaced C2: the NLCC core density and core kinetic-energy
    density on the grid, the UPF projectors, the local potential, the
    psp-correction energy and the guess density (from
    PP_RHOATOM) against the JAX package's: 1e-12."""
    jb, tb = carbon
    jt, tt = jb.terms, tb.terms
    errs = dict(rho_core=_diff(tt.rho_core_np, jt.rho_core_np),
                tau_core=_diff(tt.tau_core_np, jt.tau_core_np),
                projectors=_diff(tt.data.P.numpy(), jt.P_np),
                couplings=_diff(tt.data.D.numpy(), jt.D_np),
                local=_diff(tt.data.vloc_static.numpy(), jt.vloc_np),
                psp_correction=abs(tt.E_psp_correction - jt.E_psp_correction),
                guess=_diff(dt.guess_density(tb).numpy(), jax_guess_density(jb)))
    print("C2 terms against the JAX package: "
          + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()))
    assert tt.tau_core_np.max() > 0.1 and tt.rho_core_np.max() > 0.1
    assert max(errs.values()) < BAR


def test_upf_pbe_scf_anchor(reference):
    """Silicon PBE from gth/Si.pbe-hgh.upf at Ecut 7, fft 17 on the silicon
    k-set (tests/test_psp_upf.py:71-87): the port's LOBPCG SCF to 1e-8
    within 1e-8 Ha of the JAX package's to 1e-10, and within 5e-4 Ha of
    the JAX run on the built-in pbe/si-q4 table."""
    ref, hgh = reference["si_upf_pbe"], reference["si_hgh_pbe"]
    Si = dt.ElementPsp.from_symbol("Si", psp=str(UPFS["Si_gth"]))
    model = dt.model_DFT(SI_LATTICE, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                         functionals="PBE")
    basis = dt.PlaneWaveBasis(model, Ecut=7.0, kgrid=dt.ExplicitKpoints(*SI_KPOINTS),
                              fft_size=(17, 17, 17), device="cpu")
    res = dt.self_consistent_field(basis, tol=1e-8, maxiter=60)
    dE = res.total_energy - ref["total_energy"]
    print(f"Si PBE from UPF: E - E_JAX = {dE:.2e}; E - E_JAX(HGH) = "
          f"{res.total_energy - hgh['total_energy']:.2e}")
    assert res.converged and abs(dE) < 1e-8
    assert abs(res.total_energy - hgh["total_energy"]) < 5e-4


def test_nlcc_derivatives_anchor(carbon, reference):
    """The displaced C2 (SCAN with NLCC and tau_core): the LOBPCG SCF to
    1e-11 within 1e-8 Ha of the JAX package's energy, its forces within
    1e-7 Ha/bohr and stresses within 1e-8 Ha/bohr^3 of the JAX values (two
    JAX SCFs from different seeds agree far inside both); the split
    adapters on the same state (tau rebuilt from the orbitals) equal the
    complex path within 1e-12."""
    ref = reference["c2_scan_nlcc_derivatives"]
    _, tb = carbon
    assert len(tb.symmetries) == ref["n_symmetries"]
    res = dt.self_consistent_field(tb, tol=1e-11, maxiter=80)
    F_red = dt.compute_forces(res)
    F = dt.compute_forces_cart(res).numpy()
    S = dt.compute_stresses_cart(res)
    dE = res.total_energy - ref["total_energy"]
    dF, dS = _diff(F, ref["forces_cart"]), _diff(S.numpy(), ref["stresses_cart"])
    print(f"C2 SCAN+NLCC: E - E_JAX = {dE:.2e}, forces {dF:.2e}, stresses {dS:.2e} "
          f"(two JAX SCFs: {ref['two_runs_agree']['forces']:.1e}, "
          f"{ref['two_runs_agree']['stresses']:.1e})")
    assert res.converged and abs(dE) < 1e-8 and dF < 1e-7 and dS < 1e-8
    assert max(ref["two_runs_agree"]["forces"], ref["two_runs_agree"]["stresses"]) < 1e-9
    U = torch.cat([res.psi.real, res.psi.imag], dim=-1)
    occ = torch.as_tensor(res.occupation)
    Fs = compute_forces_split(tb, None, U, occ, res.rho)
    Ss = compute_stresses_split(tb, None, U, occ)
    assert float((Fs - F_red).abs().max()) < BAR
    assert float((Ss - S).abs().max()) < BAR
