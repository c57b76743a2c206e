"""dftk_tpu_torch's elastic response (`postprocess/elastic_response.py`)
against the JAX package.

Torch at one thread, the plain kernel versions, float64, on the JAX
package's SCF states of tests/data/torch_port_phonon.json (see
tests/test_torch_phonon.py), carried over by
`interop.scf_state_from_numpy`:
  * on Si2 on kgrid 2^3 (Ecut 6, fft 16, unfolded to 8 k-points): the
    strained jvp r_a = d_a(H psi) of the six Voigt strains (the jvp of the
    strained potential and projectors, dV_a psi through the kernels'
    plain versions) against the JAX package's jax.jvp at three k rows
    (1e-12 relative), and the Hessian of the clamped-orbital energy
    (double backward, 1e-11 relative, finite) and its gradient (1e-12 Ha);
  * on Gamma Si2 (Ecut 4) at T = 0 and T = 0.01: elastic_tensor_response,
    its Omega + K branch (the reference's defaults) and its metallic
    branch (Dyson screening and occupation response, at the data script's
    SMEARED_ELASTIC_TOLS), within 1e-9 relative, with the cubic-structure
    checks of tests/test_elastic_resp.py (but C44 > 0, see
    `cubic_structure`);
  * on diamond C2 from the UPF file C_m.upf (LDA, NLCC, Ecut 7, Gamma):
    elastic_tensor_response, through the numerical form factors'
    curvature, within 1e-9 relative, with the cubic checks but the
    normal-shear block.
The full tensor on the k-grid takes more than the CPU tests' budget:
`chip_smoke.py` phase n holds it at Ecut 15 on kgrid 4^3 against the JAX
package's and against the finite-difference `postprocess/elastic.py`.
"""
import json

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.postprocess import elastic_response as er
from dftk_tpu_torch.postprocess.stresses import energy_at_lattice
from test_torch_phonon import DATA, injected_state, make, rel_err


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def reference():
    with open(DATA / "torch_port_phonon.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def si2_unfolded(reference):
    """The unfolded Si2 kgrid state: (entry, state, psi and occupations of
    the 4 occupied bands)."""
    entry = reference["si2_kgrid"]
    u = dt.unfold_bz(injected_state(make.si2_kgrid_basis(dt, device="cpu"), entry))
    psi = u.psi[:, :make.N_OCC_SI2]
    return entry, u, psi, torch.full(psi.shape[:2], 2.0, dtype=torch.float64)


def test_strained_jvp_matches_jax(si2_unfolded):
    entry, u, psi, occ = si2_unfolded
    r_a = torch.stack(er.strain_derivatives(u.basis, psi, occ))[:, make.R_A_ROWS]
    want = make.from_b64(entry["strained_jvp"])
    errs = [rel_err(r_a[a], want[a]) for a in range(6)]
    print("strained jvp r_a, relative: " + ", ".join(f"{e:.1e}" for e in errs))
    assert max(errs) < 1e-12


def test_clamped_orbital_derivatives_match_jax(si2_unfolded):
    entry, u, psi, occ = si2_unfolded
    L0 = torch.as_tensor(u.basis.model.lattice)
    E = torch.as_tensor(np.stack([er._strain_mat(a) for a in range(6)]))

    def F(e6):
        return energy_at_lattice(u.basis, psi, occ, (torch.eye(3, dtype=torch.float64)
                                                     + torch.einsum("a,aij->ij", e6, E)) @ L0)

    z6 = torch.zeros(6, dtype=torch.float64, requires_grad=True)
    HF = torch.autograd.functional.hessian(F, z6.detach())
    (gF,) = torch.autograd.grad(F(z6), z6)
    err_H = rel_err(HF, entry["energy_hessian"])
    err_g = float(np.abs(gF.numpy() - entry["energy_gradient"]).max())
    print(f"clamped-orbital energy: Hessian {err_H:.1e} relative, gradient {err_g:.1e} Ha")
    # the gradient (the stress times the volume, 1.9e-3 Ha) is a sum of
    # energy terms of several Ha that cancel: held in Ha, not relative
    assert err_H < 1e-11 and err_g < 1e-12


def cubic_structure(C, normal_shear=True):
    """tests/test_elastic_resp.py::test_cubic_structure's checks but C44 > 0:
    the Gamma point alone samples silicon too coarsely for a stable shear
    (C44 -2.2e-4 at T 0, -3.0e-3 Ha/bohr^3 at T 0.01, in both packages);
    `chip_smoke.py` phase n1 holds C44 > 0 on kgrid 4^3.  normal_shear=False
    leaves out the zero normal-shear block, which needs the potential's
    full cubic symmetry (see test_upf_elastic_response_matches_jax)."""
    assert abs(C[0, 0] - C[1, 1]) < 1e-8 and abs(C[0, 0] - C[2, 2]) < 1e-8
    assert abs(C[0, 1] - C[0, 2]) < 1e-8 and abs(C[3, 3] - C[4, 4]) < 1e-8
    if normal_shear:
        assert np.abs(C[:3, 3:]).max() < 1e-7
    assert C[0, 0] > C[0, 1] > 0


@pytest.mark.parametrize("case", ["si2_gamma", "si2_smeared"])
def test_elastic_response_matches_jax(reference, case):
    entry, smeared = reference[case], case == "si2_smeared"
    basis = make.si2_gamma_basis(dt, temperature=0.01 if smeared else 0.0, device="cpu")
    C = dt.elastic_tensor_response(injected_state(basis, entry),
                                   **(make.SMEARED_ELASTIC_TOLS if smeared else {}))
    err = rel_err(C, entry["elastic"])
    print(f"{case} elastic tensor: {err:.2e} relative; C11 {C[0, 0]:.8f} C12 {C[0, 1]:.8f} "
          f"C44 {C[3, 3]:.8f} Ha/bohr^3")
    assert err < 1e-9
    cubic_structure(C)


def test_upf_elastic_response_matches_jax(reference):
    """Diamond C2 from the UPF file C_m.upf (LDA, NLCC): elastic_tensor_response
    against the JAX package's (1e-9 relative), whose traced UPF form factors
    are differentiated by jax.  Its clamped-orbital Hessian takes the
    numerical form factors' second p^2 derivative: without it the tensor is
    1.8 (relative) off.  The cubic checks but the normal-shear block: the
    core density is summed over the FFT cube, not a sphere, so its XC
    potential is cubic only to ~1e-5 (the Gamma triplet splits by 4.4e-5
    Ha, the normal-shear block reaches 5.9e-5 Ha/bohr^3, in both
    packages)."""
    entry = reference["c2_upf"]
    C = dt.elastic_tensor_response(injected_state(make.c2_upf_basis(dt, device="cpu"), entry))
    err = rel_err(C, entry["elastic"])
    print(f"C2 UPF elastic tensor: {err:.2e} relative; C11 {C[0, 0]:.8f} C12 {C[0, 1]:.8f} "
          f"C44 {C[3, 3]:.8f} Ha/bohr^3")
    assert err < 1e-9
    cubic_structure(C, normal_shear=False)
