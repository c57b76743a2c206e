"""dftk_tpu_torch's public helpers against the JAX package.

Torch at one thread, float64, against the JAX package's values recorded in
tests/data/torch_port_helpers.json (each entry's `command` reruns
tests/data/make_torch_port_helpers.py, whose seeded numpy inputs this file
imports), at the per-operator bar of 1e-12 (relative to max(1, |value|),
tests/test_engine_split.py:174):
  * kgrid_from_total_number, the lattice converters, diameter, ylm_real,
    count_n_proj and the dtype policy of config.py;
  * the cube and sphere FFTs, the split scatter/gather, the pruned maps
    and factors (`build_pruned_fft` with the reference's dtype argument)
    and the pruned sphere <-> real-space transforms on the si_setup cell;
  * build_sandwich and apply_local_sandwich, and apply_local_sandwich
    against the port's own complex local apply (kernels A -> B -> A's
    plain version on the CPU) on the same V;
  * von_weizsaecker_tau_split, tb09_potential_split and xc_energy_split
    (LDA, PBE; unpolarised and collinear);
  * the split stress adapter: energy_at_lattice_split ("all", "psi",
    "density") at the lattice and a strained one, its strain gradient by
    autograd, and prepare_stress_data's structure factors;
  * the ScfConvergence* criteria as the callable `is_converged` of both SCF
    loops, and ScfDefaultCallback's table.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch import config
from dftk_tpu_torch.bzmesh import kgrid_from_total_number
from dftk_tpu_torch.kernels.local_apply import local_apply
from dftk_tpu_torch.ops import engine_split as es
from dftk_tpu_torch.ops import fft as fftops
from dftk_tpu_torch.ops.hamiltonian import to_zxy
from dftk_tpu_torch.ops.stresses_split import energy_at_lattice_split, prepare_stress_data
from dftk_tpu_torch.ops.terms import count_n_proj
from dftk_tpu_torch.scf import driver
from dftk_tpu_torch.utils import lattice as lat
from dftk_tpu_torch.utils.special import ylm_real

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_helpers", DATA / "make_torch_port_helpers.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
with open(DATA / "torch_port_helpers.json") as _f:
    REF = json.load(_f)
BAR = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def basis():
    return make.si_setup_basis(dt, device="cpu")


def _close(out, ref, bar=BAR, what=""):
    out, ref = np.asarray(out, dtype=float), np.asarray(ref, dtype=float)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    err = np.max(np.abs(out - ref) / np.maximum(1.0, np.abs(ref)), initial=0.0)
    assert err < bar, (what, err)
    return err


def _held(out, ref, what):
    """The port's array against a recorded `summary`."""
    if torch.is_tensor(out):
        out = out.detach().numpy()
    got = make.summary(np.asarray(out))
    assert got["shape"] == ref["shape"], (what, got["shape"], ref["shape"])
    return max(_close(got[k], ref[k], what=f"{what}.{k}") for k in ("first", "sum", "wsum", "sample"))


def test_utilities():
    ref = REF["utilities"]
    for n, size in ref["kgrid"].items():
        assert list(kgrid_from_total_number(make.SI_LATTICE, int(n)).kgrid_size) == size
    for name in ("vector_red_to_cart", "vector_cart_to_red", "covector_red_to_cart",
                 "covector_cart_to_red", "recip_vector_red_to_cart"):
        _close(getattr(lat, name)(make.SKEW, make.VECTORS.T), ref[name], what=name)
    _close(lat.compute_inverse_lattice(make.SKEW), ref["compute_inverse_lattice"])
    _close(lat.diameter(make.SKEW), ref["diameter"])
    _close([[ylm_real(l, m, v) for v in make.VECTORS] + [ylm_real(l, m, np.zeros(3))]
            for l, m in make.YLM_CASES], ref["ylm_real"], what="ylm_real")
    for el, psp in (("Si", "lda/si-q4"), ("C", "lda/c-q4")):
        assert count_n_proj(dt.ElementPsp.from_symbol(el, psp=psp).psp) == ref["count_n_proj"][el]
    assert config.default_precision() == config.Precision(torch.float64, torch.complex128)
    assert config.mixed_precision() == config.Precision(torch.float32, torch.complex64)


def test_transforms(basis):
    ref = REF["transforms"]
    n, vol = basis.fft_size, basis.model.unit_cell_volume
    f = torch.as_tensor(make.seeded((2,) + n, 1) + 1j * make.seeded((2,) + n, 2))
    _held(fftops.ifft_cube(f, vol).numpy().view(float), ref["ifft_cube"], "ifft_cube")
    _held(fftops.irfft_cube(f, vol), ref["irfft_cube"], "irfft_cube")
    _held(fftops.fft_cube(f.real, vol).numpy().view(float), ref["fft_cube"], "fft_cube")
    k = 1
    Gidx, mask = basis.data.Gidx[k], basis.data.mask[k]
    c = torch.as_tensor((make.seeded((3, basis.nG_max), 3) + 1j * make.seeded((3, basis.nG_max), 4))
                        * basis.mask_np[k])
    psir = fftops.ifft_sphere(c, Gidx, mask, n, vol)
    _held(psir.numpy().view(float), ref["ifft_sphere"], "ifft_sphere")
    _held(fftops.fft_sphere(psir, Gidx, mask, vol).numpy().view(float), ref["fft_sphere"],
          "fft_sphere")

    xy = torch.as_tensor(make.split_orbitals(basis.mask_np, make.N_BANDS, 5))
    bd = basis.data
    cube = es.scatter_cube_split(xy, bd.Gidx, bd.mask, n)
    _held(cube, ref["scatter_cube_split"], "scatter_cube_split")
    _held(es.gather_cube_split(cube * 1.5 - 0.25, bd.Gidx, bd.mask), ref["gather_cube_split"],
          "gather_cube_split")
    pf = es.build_pruned_fft(basis, dtype=torch.float64)
    rp = ref["pruned"]
    assert list(pf.m_shape) == rp["m_shape"]
    assert np.array_equal(pf.Gidx_c.numpy(), np.array(rp["Gidx_c"]))
    _held(pf.inv_idx, rp["inv_idx"], "inv_idx")
    for F, B, rf, rb in zip(pf.factors.fwd, pf.factors.bwd, rp["Ff"], rp["Fb"]):
        m_, n_ = F.shape
        _held(es._realify_matrix(F).reshape(m_, 2, n_, 2), rf, "Ff")
        _held(es._realify_matrix(B).reshape(n_, 2, m_, 2), rb, "Fb")
    real = es.sphere_to_real_pruned(xy, pf, bd.mask)
    _held(real, ref["sphere_to_real_pruned"], "sphere_to_real_pruned")
    scaled = real * (1.0 + torch.as_tensor(make.seeded(real.shape[:-1], 6)))[..., None]
    _held(es.real_to_sphere_pruned(scaled, pf, bd.mask, n), ref["real_to_sphere_pruned"],
          "real_to_sphere_pruned")


def test_sandwich(basis):
    """The sandwich against the JAX package's, and against the port's
    complex local apply on the same V (1e-12 of max|out|)."""
    ref = REF["transforms"]
    pf = basis.pruned
    V = torch.as_tensor(0.3 * make.seeded((1,) + basis.fft_size, 7))
    M = es.build_sandwich(pf, V)
    _held(M, ref["build_sandwich"], "build_sandwich")
    x = torch.as_tensor(make.seeded((basis.n_kpoints, make.N_BANDS) + pf.m_shape + (2,), 8))
    out = es.apply_local_sandwich(x, pf, M, basis.data.kspin)
    _held(out, ref["apply_local_sandwich"], "apply_local_sandwich")
    chain = local_apply(torch.view_as_complex(x), to_zxy(V, basis.data.kspin), pf.factors)
    err = float((torch.view_as_complex(out) - chain).abs().max())
    assert err < BAR * float(chain.abs().max()), err


def test_densities(basis):
    ref = REF["densities"]
    pbe = make.si_setup_basis(dt, functionals=("gga_x_pbe", "gga_c_pbe"), device="cpu")
    G = torch.as_tensor(basis.G_cube_cart)
    for ns in (1, 2):
        rho = torch.as_tensor(make.smooth_density(basis.fft_size, ns))
        tau = es.von_weizsaecker_tau_split(rho, G)
        _held(tau, ref[f"vw_tau_{ns}"], f"vw_tau_{ns}")
        _held(es.tb09_potential_split(rho, G, make.tb09_tau(rho, tau)), ref[f"tb09_{ns}"],
              f"tb09_{ns}")
        _close(float(es.xc_energy_split(basis.terms.xc, rho, G, basis.model.unit_cell_volume)),
               ref[f"xc_lda_{ns}"], what="xc_lda")
        _close(float(es.xc_energy_split(pbe.terms.xc, rho, G, pbe.model.unit_cell_volume, 0.7)),
               ref[f"xc_pbe_{ns}"], what="xc_pbe")


def test_stress_adapter(basis):
    ref = REF["densities"]
    st = prepare_stress_data(basis)
    for got, want in zip(st.sf_loc, ref["stress_data"]["sf_loc"]):
        _held(got, want, "sf_loc")
    for got, want in zip(st.sf_nl, ref["stress_data"]["sf_nl"]):
        _held(got, want, "sf_nl")
    _held(st.Gred_pk, ref["stress_data"]["Gred_pk"], "Gred_pk")
    xy = torch.as_tensor(make.split_orbitals(basis.mask_np, make.N_BANDS, 9))
    wocc = torch.as_tensor(basis.kweights)[:, None] * 2.0 * torch.ones((1, make.N_BANDS))
    symm = es.make_symmetrizer_split(basis, torch.float64)
    L0 = torch.as_tensor(basis.model.lattice)
    L1 = (torch.eye(3, dtype=torch.float64) + torch.as_tensor(make.STRAIN)) @ L0
    for name, L in (("L0", L0), ("strained", L1)):
        for include in ("all", "psi", "density"):
            E = energy_at_lattice_split(basis, st, xy, wocc, L, symmetrizer=symm, include=include)
            _close(float(E), ref[f"energy_{name}_{include}"], what=f"{name} {include}")
    eps = torch.zeros((3, 3), dtype=torch.float64, requires_grad=True)
    E = energy_at_lattice_split(basis, st, xy, wocc,
                                (torch.eye(3, dtype=torch.float64) + (eps + eps.T) / 2) @ L0,
                                symmetrizer=symm)
    (grad,) = torch.autograd.grad(E, eps)
    _close(grad.numpy(), ref["strain_gradient"], what="strain gradient")


def test_scf_criteria(capsys):
    """ScfConvergence{Density,Energy,Force} as the callable is_converged of
    both loops end where the built-in criteria do, and ScfDefaultCallback
    prints one row per iteration."""
    b = make.si_setup_basis(dt, device="cpu")
    ref = dt.self_consistent_field(b, tol=1e-8, is_converged="density", n_bands=4)
    res = dt.self_consistent_field(b, tol=1e-8, is_converged=driver.ScfConvergenceDensity(1e-8),
                                   n_bands=4, callback=driver.ScfDefaultCallback())
    assert res.converged and res.n_iter == ref.n_iter
    assert abs(res.total_energy - ref.total_energy) < 1e-12
    rows = [l for l in capsys.readouterr().out.splitlines() if l.strip()[:1].isdigit()]
    assert len(rows) == res.n_iter
    force = driver.ScfConvergenceForce(1e-5)
    res_f = dt.self_consistent_field(b, tol=1e-12, is_converged=force, n_bands=4)
    assert res_f.converged and force._prev is not None and res_f.n_iter >= 2
    kw = dict(tol=1e-9, n_bands=4, maxiter=40)
    ref_s = es.self_consistent_field_split(b, is_converged="energy", **kw)
    res_s = es.self_consistent_field_split(b, is_converged=driver.ScfConvergenceEnergy(1e-9), **kw)
    assert res_s["converged"] and res_s["n_iter"] == ref_s["n_iter"]
    assert abs(res_s["energies"]["total"] - ref_s["energies"]["total"]) < 1e-12
    force_s = driver.ScfConvergenceForce(1e-5)
    res_fs = es.self_consistent_field_split(b, is_converged=force_s, **kw)
    assert res_fs["converged"] and force_s._prev is not None and res_fs["n_iter"] < kw["maxiter"]
