"""dftk_tpu_torch's consumers of the Hamiltonian with the model-Hamiltonian
terms, where the JAX package applies them, against its values
(tests/data/torch_port_terms.json, entry "consumers"; see
tests/test_torch_terms.py), torch at one thread, float64, on the CPU:
  * `evaluate_total_energy` of the rotating 2D GP (Magnetic and
    LocalNonlinearity) at seeded orbitals: 1e-12;
  * `scf_potential_mixing` and `newton` of the 3D GP (External*, and
    LocalNonlinearity, whose second derivative the kernel K carries into
    Newton's Hessian), each from its own start: energies 1e-8 Ha;
  * chi0 of a seeded potential on the Fock-Darwin state (Magnetic), each
    package on its own SCF: 1e-8 of max|drho|;
  * the SCF Hessian (Omega + K) with BlowupCHV on Si2: its quadratic form
    along P_c dV psi, invariant under the orbitals' phases, 1e-8 relative;
  * the split SCF with BlowupCHV on Si2 under filter_precision="default":
    exact LOBPCG steps on every iteration (no bf16 apply), so its energies
    meet the JAX split SCF's (entry "si2"), 1e-8 Ha, as "mixed" does in
    tests/test_torch_terms_scf.py.
"""
import numpy as np
import torch
from test_torch_terms import REF, close, make, summary_close

import dftk_tpu_torch as dt
from dftk_tpu_torch.kernels import local_apply as la
from dftk_tpu_torch.response.chi0 import apply_chi0, make_chi0_context
from dftk_tpu_torch.response.hessian import make_omega_plus_k
from dftk_tpu_torch.scf.newton import newton
from dftk_tpu_torch.scf.potential_mixing import scf_potential_mixing

REF_C = REF["consumers"]
E_BAR = 1e-8


def _start(basis, n_bands, seed):
    return torch.as_tensor(make.seeded_orbitals(basis.mask_np, n_bands, seed))


def test_evaluate_total_energy():
    torch.set_num_threads(1)
    b = make.gp2d_basis(dt, Ecut=8.0, device="cpu")
    E = dt.evaluate_total_energy(b, _start(b, 1, 22), np.ones((1, 1)))
    assert set(E) == set(REF_C["evaluate"])
    for k, v in REF_C["evaluate"].items():
        close(E[k], v)


def test_potential_mixing_and_newton():
    torch.set_num_threads(1)
    b = make.gp3d_basis(dt, Ecut=10.0, device="cpu")
    for name, res in (("potential_mixing", scf_potential_mixing(b, tol=1e-10, maxiter=40)),
                      ("newton", newton(b, tol=1e-10))):
        want = REF_C[name]["energies"]
        assert set(res.energies) == set(want)
        for k, v in want.items():
            assert abs(res.energies[k] - v) < E_BAR, (name, k, res.energies[k], v)


def test_chi0_with_magnetic():
    torch.set_num_threads(1)
    b = make.fock_darwin_basis(dt, Ecut=10.0, device="cpu")
    res = dt.self_consistent_field(b, tol=1e-12, n_bands=2, maxiter=40, psi=_start(b, 5, 25))
    drho = apply_chi0(make_chi0_context(res, b), b, b.tensor(make.seeded_potential(b)[None]),
                      tol=1e-11).numpy()
    summary_close(drho, REF_C["chi0"]["drho"], E_BAR * REF_C["chi0"]["max"])


def test_hessian_with_blowup():
    torch.set_num_threads(1)
    b = make.si2_basis(dt, blowup=dt.BlowupCHV(), device="cpu")
    res = dt.self_consistent_field(b, tol=1e-12, n_bands=4, maxiter=60, psi=_start(b, 7, 27))
    psi, occ = res.psi[:, :4], torch.as_tensor(res.occupation[:, :4])
    OmegaK, Pc, _ = make_omega_plus_k(b, psi, occ)
    q = make.hessian_quadratic_form(OmegaK, lambda d: Pc(torch.as_tensor(d)), b, psi.numpy(),
                                    make.seeded_potential(b))
    want = REF_C["hessian"]["q"]
    assert abs(q - want) < E_BAR * abs(want), (q, want)


def test_split_default_filter_with_blowup():
    torch.set_num_threads(1)
    ref = REF["si2"]["chv"]["split"]["energies"]
    b = make.si2_basis(dt, blowup=dt.BlowupCHV(), device="cpu")
    psi0 = make.seeded_orbitals(b.mask_np, 7, 27)
    la.counts.reset()
    split = dt.self_consistent_field_split(
        b, tol=1e-10, maxiter=60, n_bands=4, n_extra_bands=3, eigensolver="chefsi",
        is_converged="density", U0=torch.as_tensor(np.concatenate([psi0.real, psi0.imag], -1)),
        diagtol_min=1e-12, filter_precision="default")
    assert split["converged"]
    assert la.counts.plain["pruned_axis_dft[bf16]"] == la.counts.plain["local_plane[bf16]"] == 0
    assert set(split["energies"]) == set(ref)
    for k, v in ref.items():
        assert abs(split["energies"][k] - v) < E_BAR, (k, split["energies"][k], v)
