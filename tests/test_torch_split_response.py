"""dftk_tpu_torch's split-engine response adapters (`response/chi0_split.py`,
`response/phonon_split.py`) and the split force data
(`ops/forces_split.py::prepare_force_data`) against the JAX package.

The adapters turn the split SCF's realified orbitals (rows [x; y]) into
complex psi and run the complex response; the JAX package solves on the
realified vectors.  Torch at one thread, the plain kernel versions,
float64, on the JAX package's SCF states of tests/data/
torch_port_phonon_q.json (regenerated by each entry's `command`) and
tests/data/torch_port_phonon.json:
  * tests/test_chi0_split.py's silicon (Ecut 6, kgrid 2^3, fft 16):
    apply_chi0_split_ctx of its dV, given as a potential and as a
    realified rhs, within the reference's 1e-9 of max(1, max|drho|) of the
    JAX split value; solve_dyson_split within its 1e-10; apply_kernel_split
    within 1e-12 relative; sternheimer_split equal to the detailed chi0's
    dpsi;
  * the metallic branch on a small aluminium (Ecut 5, MonkhorstPack 2^3):
    drho, df and depsF of the detailed chi0 within 1e-9, the electron count
    kept to 1e-10;
  * dynmat_dfpt_gamma_split on the Gamma silicon of
    tests/test_torch_phonon.py (T = 0 and T = 0.01) within 1e-9 relative of
    the JAX package's dynmat_dfpt_gamma at that file's GAMMA_DFPT_TOLS,
    and its NLCC refusal;
  * prepare_force_data's arrays of the Gamma silicon and the UPF diamond
    within 1e-13.
The reference's own split DFPT test (Si2, Ecut 5, kgrid 2^3, tol 1e-8)
takes minutes on the CPU: `chip_smoke.py` phase o4 holds the adapter
against its JAX value and against dynmat_dfpt_gamma on the card.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.ops.density import compute_density, make_symmetrizer
from dftk_tpu_torch.ops.engine_split import apply_H_split, prepare_split_data
from dftk_tpu_torch.ops.forces_split import prepare_force_data
from dftk_tpu_torch.response import chi0_split as cs
from dftk_tpu_torch.response.chi0 import apply_dV
from dftk_tpu_torch.response.phonon_split import dynmat_dfpt_gamma_split

DATA = pathlib.Path(__file__).parent / "data"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, DATA / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


make = _load("make_phonon_q", "make_torch_port_phonon_q.py")
make_phonon = make.make_phonon
from_b64 = make.from_b64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def reference():
    with open(DATA / "torch_port_phonon_q.json") as f:
        return json.load(f)


def split_res(basis, entry):
    """The reference's split result dict of a data-file entry's JAX SCF
    state: rows [x; y] per band, occupations, eigenvalues, density, epsF."""
    s = entry["state"]
    assert list(basis.fft_size) == entry["fft_size"]
    psi = from_b64(s["psi"])
    return dict(U=np.concatenate([psi.real, psi.imag], axis=-1),
                occupation=np.array(from_b64(s["occupation"])),
                eigenvalues=np.array(from_b64(s["eigenvalues"])), rho=np.array(from_b64(s["rho"])),
                epsF=s["epsF"])


def max_err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape and np.isfinite(a).all()
    return np.abs(a - ref).max()


@pytest.fixture(scope="module")
def si2(reference):
    entry = reference["chi0_split"]
    basis = make.si2_split_basis(dt, device="cpu")
    res = split_res(basis, entry)
    ctx = cs.make_chi0_split_context(basis, prepare_split_data(basis), res)
    return basis, entry, res, ctx, torch.as_tensor(make.split_dV(basis.fft_size))


@pytest.mark.parametrize("given", ["delta_V", "rhs"])
def test_apply_chi0_split_matches_jax(si2, given):
    basis, entry, _, ctx, dV = si2
    if given == "rhs":
        dVpsi = apply_dV(ctx.ham, ctx.psi, dV, basis.data.kspin)
        drho = cs.apply_chi0_split_ctx(basis, ctx, rhs=torch.cat([dVpsi.real, dVpsi.imag], -1),
                                       tol=1e-11)
    else:
        drho = cs.apply_chi0_split_ctx(basis, ctx, dV, tol=1e-11)
    want = from_b64(entry["chi0"])
    err = max_err(drho, want)
    print(f"split chi0 ({given}) against the JAX split value: {err:.2e}, max|drho| "
          f"{np.abs(want).max():.2e}")
    assert err < 1e-9 * max(1.0, np.abs(want).max())


def test_solve_dyson_split_matches_jax(si2):
    basis, entry, res, ctx, dV = si2
    drho, dV_tot = cs.solve_dyson_split(basis, ctx, dV, res["rho"], tol=1e-9,
                                        sternheimer_tol=1e-11)
    err = max_err(drho, from_b64(entry["dyson_drho"]))
    err_V = max_err(dV_tot, from_b64(entry["dyson_dV"]))
    print(f"split Dyson against the JAX split value: drho {err:.2e}, dV_tot {err_V:.2e}")
    assert err < 1e-10 and err_V < 1e-9


def test_apply_kernel_split_matches_jax(si2):
    basis, entry, res, ctx, dV = si2
    K = cs.apply_kernel_split(basis, ctx.sd, res["rho"], 1e-2 * dV)
    want = from_b64(entry["kernel"])
    err = max_err(K, want) / np.abs(want).max()
    print(f"split kernel: {err:.2e} relative")
    assert err < 1e-12


def test_sternheimer_split_is_the_chi0_solve(si2):
    """sternheimer_split on realified rows (with the split H apply) gives
    the orbital response of the detailed chi0 of the same rhs."""
    basis, _, res, ctx, dV = si2
    dVpsi = apply_dV(ctx.ham, ctx.psi, dV, basis.data.kspin)
    rhs = torch.cat([dVpsi.real, dVpsi.imag], -1)
    _, dpsi, _, _ = cs.apply_chi0_split_ctx(basis, ctx, rhs=rhs, tol=1e-9, with_detail=True)
    occ = ctx.occupation > 1e-8
    m3 = occ[:, :, None].to(rhs.dtype)
    kin2, mask2 = (torch.cat([t, t], -1) for t in (ctx.ham.kin, basis.data.mask))
    x = cs.sternheimer_split(lambda u: apply_H_split(ctx.ham, u, basis.fft_size,
                                                     basis.model.unit_cell_volume),
                             ctx.U * m3, ctx.eigenvalues, rhs * m3, kin2, mask2, tol=1e-9) * m3
    err = float((x - dpsi).abs().max() / dpsi.abs().max())
    print(f"sternheimer_split against the detailed chi0's dpsi: {err:.1e} relative")
    assert tuple(x.shape) == tuple(rhs.shape) and err < 1e-12


def test_apply_chi0_split_metal_matches_jax(reference):
    entry = reference["chi0_split_metal"]
    basis = make.al_small_basis(dt, device="cpu")
    ctx = cs.make_chi0_split_context(basis, prepare_split_data(basis), split_res(basis, entry))
    dV = torch.as_tensor(make.split_dV(basis.fft_size, 0.05))
    drho, dpsi, df, depsF = cs.apply_chi0_split_ctx(basis, ctx, dV, tol=1e-11,
                                                    with_detail=True)
    errs = dict(drho=max_err(drho, from_b64(entry["chi0"])),
                df=max_err(df, from_b64(entry["df"])), depsF=abs(float(depsF) - entry["depsF"]))
    count = float((basis.data.kweights[:, None] * df).sum())
    print("split metallic chi0 against the JAX split value: "
          + ", ".join(f"{k} {v:.1e}" for k, v in errs.items()) + f"; sum w df {count:.1e}")
    assert max(errs.values()) < 1e-9 and abs(count) < 1e-10
    assert dpsi.shape[-1] == 2 * basis.nG_max


@pytest.mark.parametrize("case", ["si2_gamma", "si2_smeared"])
def test_dynmat_dfpt_gamma_split_matches_jax(case):
    """The adapter on the JAX package's Gamma silicon states (the realified
    rows of their orbitals) against its complex dynmat_dfpt_gamma at
    GAMMA_DFPT_TOLS: the adapter computes through the complex path."""
    with open(DATA / "torch_port_phonon.json") as f:
        entry = json.load(f)[case]
    basis = make_phonon.si2_gamma_basis(dt, temperature=0.01 if case == "si2_smeared" else 0.0,
                                        device="cpu")
    s = entry["state"]
    psi, occ = np.array(make_phonon.from_b64(s["psi"])), np.array(s["occupation"])
    rho = compute_density(basis.data, basis.tensor(psi, basis.dtype), basis.tensor(occ),
                          basis.fft_size, basis.model.unit_cell_volume, 1,
                          symmetrizer=make_symmetrizer(basis))
    res = dict(U=np.concatenate([psi.real, psi.imag], -1), occupation=occ,
               eigenvalues=np.array(s["eigenvalues"]), rho=rho.numpy(), epsF=s["epsF"])
    C = dynmat_dfpt_gamma_split(basis, prepare_split_data(basis), res,
                                **make_phonon.GAMMA_DFPT_TOLS)
    want = np.array(entry["dynmat"])
    err = max_err(C, want) / np.abs(want).max()
    print(f"{case} split dynmat against the JAX package's dynmat_dfpt_gamma: {err:.2e} relative")
    assert err < 1e-9


def test_split_dfpt_refuses_nlcc():
    basis = make_phonon.c2_upf_basis(dt, device="cpu")
    nb, nG = 4, basis.nG_max
    res = dict(U=np.zeros((1, nb, 2 * nG)), occupation=np.full((1, nb), 2.0),
               eigenvalues=np.zeros((1, nb)), rho=np.zeros((1,) + basis.fft_size))
    with pytest.raises(NotImplementedError, match="NLCC"):
        dynmat_dfpt_gamma_split(basis, prepare_split_data(basis), res)


@pytest.mark.parametrize("cell", ["si2", "c2_upf"])
def test_prepare_force_data_matches_jax(reference, cell):
    want = reference["force_data"][cell]
    basis = (make_phonon.si2_gamma_basis if cell == "si2" else make_phonon.c2_upf_basis)(
        dt, device="cpu")
    fd = prepare_force_data(basis)._asdict()
    assert set(fd) == set(want)
    errs = {}
    for k, v in fd.items():
        if k.endswith("_groups"):
            assert [list(g) for g in v] == want[k], k
        elif isinstance(v, tuple):
            assert len(v) == len(want[k]), k
            errs[k] = max([max_err(a, from_b64(w)) / max(1.0, np.abs(from_b64(w)).max())
                           for a, w in zip(v, want[k])], default=0.0)
        else:
            assert v.dtype == torch.float64
            errs[k] = max_err(v, from_b64(want[k]).astype(float))
    print(f"prepare_force_data ({cell}): " + ", ".join(f"{k} {v:.0e}" for k, v in errs.items()))
    assert max(errs.values()) < 1e-13
    assert (len(fd["ff_core"]) > 0) == (cell == "c2_upf")
