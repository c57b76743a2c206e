"""dftk_tpu_torch's phonons at q (`response/phonon_q.py`), supercell force
constants and phonon dispersions (`postprocess/phonon.py`) and q-paths
(`postprocess/bands.py`) against the JAX package.

Torch at one thread, the plain kernel versions, float64, on the JAX
package's own SCF states carried over by `interop.scf_state_from_numpy`
(from tests/data/torch_port_phonon_q.json, whose entries' `command`
regenerates them with tests/data/make_torch_port_phonon_q.py: the JAX
response at q takes minutes on the CPU, so its values are recorded):
  * on tests/test_phonon_q.py's silicon (Ecut 4, kgrid 2^3, unfolded to 8
    k-points) at X: the k+q maps exactly; the kernel at q, dV_q psi (the
    kernels' plain versions against the JAX package's full cube), drho_q,
    the six bare dH_q psi and one k+q Sternheimer solve (T = 0 and, for the
    divided-difference pairs, T = 0.01) within 1e-12 relative; H at k+q
    through the permuted Ham equal to H at k_perm within 1e-13;
    dynmat_dfpt_q at X and at 0 within 1e-9 relative, at the data script's
    CPU_Q_TOLS (looser than the reference test's: the packages are compared
    on one state, not the converged response);
  * dynmat_ewald_q exactly as the JAX package's (host numpy in both) and
    its supercell fold at X within 1e-10;
  * dynmat_q, phonon_modes_q and phonon_band_structure on the JAX package's
    force constants of tests/test_phonon_q.py's si_fc fixture within 1e-12,
    irrfbz_path of seven Bravais classes exactly, compute_bands no longer
    the stub that raised naming item 12, and the NLCC refusal of
    dynmat_dfpt_q.
`compute_force_constants` runs 12 SCFs of the 4-atom supercell (over 5 s
on one CPU thread): `chip_smoke.py` phase o3 holds it against the JAX
package's Phi on the card, and phase o1 and o2 the DFPT route against it.
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
from dftk_tpu_torch.postprocess import bands, phonon
from dftk_tpu_torch.response import phonon_q as pq
from dftk_tpu_torch.response.chi0 import make_chi0_context

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_phonon_q",
                                               DATA / "make_torch_port_phonon_q.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
from_b64 = make.from_b64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def reference():
    with open(DATA / "torch_port_phonon_q.json") as f:
        return json.load(f)


def injected_state(basis, entry):
    """The JAX SCF state of a data-file entry (its orbitals, occupations,
    eigenvalues, Fermi level and density) on the port's basis."""
    s = entry["state"]
    assert list(basis.fft_size) == entry["fft_size"]
    return scf_state_from_numpy(basis, from_b64(s["psi"]), from_b64(s["occupation"]),
                                from_b64(s["eigenvalues"]), s["epsF"], from_b64(s["rho"]))


def rel_err(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape and np.isfinite(a).all()
    return np.abs(a - ref).max() / np.abs(ref).max()


class AtX:
    """An injected state, its unfolding, chi0 context and QContext at X."""

    def __init__(self, reference, case, temperature):
        self.entry = reference[case]
        self.state = injected_state(make.si2_q_basis(dt, temperature=temperature, device="cpu"),
                                    self.entry)
        u = dt.unfold_bz(self.state)
        self.basis = u.basis
        self.ctx = make_chi0_context(u, self.basis)
        self.qctx = pq.QContext(self.basis, make.Q_X)
        self.rho = u.rho


@pytest.fixture(scope="module")
def si2_x(reference):
    return AtX(reference, "si2_q", 0.0)


@pytest.fixture(scope="module")
def si2_x_smeared(reference):
    return AtX(reference, "si2_q_smeared", 0.01)


def test_kpq_maps_match_jax(si2_x):
    e, q = si2_x.entry, si2_x.qctx
    assert q.perm.tolist() == e["perm"] and q.G0.tolist() == e["G0"]
    assert q.is_gamma == e["is_gamma"] and si2_x.basis.n_kpoints == 8
    assert (q.G0 != 0).any() and (q.G0 == 0).all(axis=1).any()


def _q_operator(case, name):
    """The port's value of one q-operator of make._q_operators."""
    bu, ctx, qctx = case.basis, case.ctx, case.qctx
    mask_q = bu.mask_np[qctx.perm]
    inp = make.seeded_q_inputs(bu.fft_size, mask_q, ctx.psi.shape[1])
    c = {k: torch.as_tensor(v) for k, v in inp.items()}
    rows = make.Q_ROWS
    if name == "kernel_q":
        return pq.apply_kernel_q(bu, case.rho, c["drho"], make.Q_X)
    if name == "dv_times_psi_q":
        return pq.dv_times_psi_q(ctx, bu, qctx, c["dv"])[rows]
    if name == "drho_q":
        return pq.drho_q_from_dpsi(ctx, bu, qctx, c["dpsi"])
    rhs = pq._bare_rhs_q(bu, ctx, qctx, pq._dvloc_q_grids(bu, make.Q_X))
    if name == "bare_rhs_q":
        return torch.stack([r[0] for r in rhs])
    return pq.sternheimer_q(ctx, bu, qctx, rhs[0], tol=case.entry["sternheimer_tol"])[rows]


@pytest.mark.parametrize("case,name", [
    ("si2_x", "kernel_q"), ("si2_x", "dv_times_psi_q"), ("si2_x", "drho_q"),
    ("si2_x", "bare_rhs_q"), ("si2_x", "sternheimer_q"), ("si2_x_smeared", "sternheimer_q")])
def test_q_operators_match_jax(request, case, name):
    at = request.getfixturevalue(case)
    err = rel_err(_q_operator(at, name), from_b64(at.entry[name]))
    print(f"{case} {name} at X: {err:.2e} relative")
    assert err < 1e-12


def test_perm_ham_applies_h_at_k_plus_q(si2_x):
    """H at k+q (every per-k field of the Ham taken at perm) applied to the
    k_perm orbitals equals H at k_perm.  Permuting only the fields the JAX
    package's Ham has, without the pruned transforms' sphere maps, applies
    the local potential through k's maps: a wrong answer without an error."""
    ham, p = si2_x.ctx.ham, si2_x.qctx.perm_t
    v = si2_x.ctx.psi[p]
    want = hamops.apply_H(ham, si2_x.ctx.psi)[p]
    err = float((hamops.apply_H(pq._perm_ham(ham, p), v) - want).abs().max())
    stale = ham._replace(mask=ham.mask[p], kin=ham.kin[p], V_zxy=ham.V_zxy[p], P=ham.P[p])
    miss = float((hamops.apply_H(stale, v) - want).abs().max())
    print(f"H at k+q against H at k_perm: {err:.1e}; without the sphere maps {miss:.1e}")
    assert err < 1e-13 and miss > 1e-3


@pytest.mark.parametrize("q,key", [(make.Q_X, "dynmat_X"), ([0.0, 0.0, 0.0], "dynmat_0")],
                         ids=["X", "Gamma"])
def test_dynmat_dfpt_q_matches_jax(si2_x, q, key):
    C = pq.dynmat_dfpt_q(si2_x.state, q, **make.CPU_Q_TOLS)
    want = from_b64(si2_x.entry[key])
    err = rel_err(C, want)
    herm = np.abs(C - C.conj().T).max()
    print(f"dynmat_dfpt_q at {q}: {err:.2e} relative to the JAX package's; max|imag| "
          f"{np.abs(C.imag).max():.1e}")
    assert err < 1e-9 and herm < 1e-14


@pytest.mark.parametrize("key", ["fold_cell_X", "fold_cell_generic", "silicon_X",
                                 "silicon_generic"])
def test_dynmat_ewald_q_matches_jax(reference, key):
    cell, qname = key.rsplit("_", 1)
    q = make.Q_X if qname == "X" else [0.25, 0.1, -0.3]
    if cell == "fold_cell":
        a = 5.13
        L = np.array([[0, a, a], [a, 0, a], [a, a, 0]], dtype=float)
        pos = np.array([[0.125, 0.125, 0.125], [-0.125, -0.125, -0.125]])
    else:
        L, pos = make.SI_LATTICE, np.stack(make.SI_POSITIONS)
    D = pq.dynmat_ewald_q(L, np.array([4.0, 4.0]), pos, q)
    err = rel_err(D, from_b64(reference["ewald_q"][key]))
    if key == "fold_cell_X":
        # the exact fold of the 4-atom supercell's Ewald Hessian at X, in the
        # gauge convention
        ph = np.exp(2j * np.pi * (pos @ np.asarray(q)))
        D_gauge = np.einsum("a,aibj,b->aibj", ph, D, ph.conj())
        fold = np.abs(D_gauge - from_b64(reference["ewald_q"]["fold_X"])).max()
        print(f"Ewald D(X) against the supercell fold: {fold:.1e}")
        assert fold < 1e-10
    print(f"dynmat_ewald_q {key}: {err:.1e} relative")
    assert err < 1e-13


@pytest.fixture(scope="module")
def si_fc(reference):
    e = reference["si_fc"]
    model = make.si2_model(dt)
    return e, phonon.ForceConstants(Phi=from_b64(e["Phi"]), offsets=np.array(e["offsets"]),
                                    supercell=tuple(e["supercell"]), atoms=list(model.atoms),
                                    lattice=np.asarray(model.lattice, dtype=float))


def test_force_constant_dispersion_matches_jax(si_fc):
    """dynmat_q and phonon_modes_q at FC_QS and phonon_band_structure on
    the JAX package's Phi; the acoustic sum rule at Gamma and time
    reversal as tests/test_phonon_q.py checks them."""
    e, fc = si_fc
    errs = [rel_err(phonon.dynmat_q(fc, q), from_b64(d)) for q, d in zip(make.FC_QS, e["dynmat_q"])]
    freqs = [phonon.phonon_modes_q(fc, q)[0] for q in make.FC_QS]
    errs += [rel_err(f, w) for f, w in zip(freqs, e["frequencies_q"])]
    bs = phonon.phonon_band_structure(fc, kline_density=make.BAND_KLINE_DENSITY)
    path = bs["qpath"]
    assert path.labels == {int(k): v for k, v in e["band_labels"].items()}
    assert np.array_equal(path.kcoords, from_b64(e["band_qpath"]))
    errs += [rel_err(path.kdistances, from_b64(e["band_kdistances"])),
             rel_err(bs["frequencies"], from_b64(e["band_frequencies"]))]
    print(f"force-constant dispersion: max {max(errs):.1e} relative")
    assert max(errs) < 1e-12
    assert np.abs(freqs[0][:3]).max() < 1e-6 and freqs[0][3] > 0
    assert np.abs(freqs[2] - freqs[3]).max() < 1e-12


@pytest.mark.parametrize("name", list(make.BRAVAIS_LATTICES))
def test_irrfbz_path_matches_jax(reference, name):
    e = reference["bravais"][name]
    path = bands.irrfbz_path(np.array(e["lattice"]), kline_density=10)
    assert bands.detect_bravais(np.array(e["lattice"])) == e["bravais"]
    assert path.labels == {int(k): v for k, v in e["labels"].items()}
    assert np.array_equal(path.kcoords, from_b64(e["kcoords"]))
    assert np.abs(path.kdistances - from_b64(e["kdistances"])).max() < 1e-12


def test_compute_bands_raises_naming_item_12():
    """compute_bands, a stub that raised NotImplementedError naming item 12
    until its port, is the port's own now (tests/test_torch_post_bands.py
    holds it against the JAX package): its docstring names no item, and a
    call without an SCF result fails on the missing result, not in a stub."""
    assert "item 12" not in (bands.compute_bands.__doc__ or "")
    with pytest.raises(AttributeError, match="basis"):
        bands.compute_bands(None)


def test_dynmat_dfpt_q_refuses_nlcc():
    """A psp with a core density: the reference's bare perturbation at q has
    no core term, so both packages refuse (before any response solve)."""
    basis = make.make_phonon.c2_upf_basis(dt, device="cpu")
    nb = 4
    psi = np.zeros((basis.n_kpoints, nb, basis.nG_max), dtype=complex)
    state = scf_state_from_numpy(basis, psi, np.full((1, nb), 2.0), np.zeros((1, nb)), 0.0,
                                 np.zeros((1,) + basis.fft_size))
    with pytest.raises(NotImplementedError, match="NLCC"):
        pq.dynmat_dfpt_q(state, make.Q_X)
