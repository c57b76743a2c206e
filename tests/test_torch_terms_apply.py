"""dftk_tpu_torch's model-Hamiltonian terms in the Hamiltonian, against the
JAX package (tests/data/torch_port_terms.json, entry "applies"; see
tests/test_torch_terms.py) on seeded orbitals, torch at one thread,
float64, within 1e-12 of max(1, max|value|):
  * the Fock-Darwin cell (Ecut 10): H psi with the Magnetic term (torch.fft
    over the whole cube; also from the arrays carried by
    `interop.basis_arrays_from_numpy`), the Kinetic and Magnetic energies
    and the current of `compute_current`;
  * the rotating 2D Gross-Pitaevskii cell (Ecut 8): the LocalNonlinearity
    and Magnetic energies, the total potential (its nonlinearity by
    autograd), H psi and the response kernel K (with the nonlinearity's
    second derivative) along a seeded drho;
  * the anyon cell (Ecut 8): the anyonic energy and the hand operator
    `apply_anyonic`, and the hand operator against torch.autograd of the
    energy (torch's gradient 2 w f H psi, the conjugate of jax.grad's).
"""
import numpy as np
import torch
from test_torch_terms import REF, close, interop_arrays, make, summary_close

import dftk_tpu_torch as dt
from dftk_tpu_torch.ops import hamiltonian as H
from dftk_tpu_torch.ops.anyonic import anyonic_energy, apply_anyonic
from dftk_tpu_torch.ops.density import compute_density
from dftk_tpu_torch.postprocess.current import compute_current
from dftk_tpu_torch.response.hessian import apply_kernel

REF_A = REF["applies"]


def as_complex(d):
    return np.array(d["re"]) + 1j * np.array(d["im"])


def _state(basis, n_bands, seed, occ):
    psi = basis.tensor(make.seeded_orbitals(basis.mask_np, n_bands, seed), basis.dtype)
    occ = basis.tensor(np.array([occ]))
    rho = compute_density(basis.data, psi, occ, basis.fft_size, basis.model.unit_cell_volume, 1)
    return psi, occ, rho


def test_magnetic_apply_energies_and_current():
    torch.set_num_threads(1)
    b = make.fock_darwin_basis(dt, Ecut=10.0, device="cpu")
    ref = REF_A["fock_darwin"]
    psi, occ, _ = _state(b, 4, 21, [1.0, 1.0, 0.5, 0.0])
    ham = H.build_ham(b.data, b.terms.data, b.terms.data.vloc_static[None], b.pruned)
    close(H.apply_H(ham, psi).numpy(), as_complex(ref["Hpsi"]))
    bd, td = interop_arrays(b, Apot=b.terms.Apot_np)
    close(H.apply_H(H.build_ham(bd, td, td.vloc_static[None], b.pruned), psi).numpy(),
          as_complex(ref["Hpsi"]))
    en = H.psi_energies(ham, psi, occ, b.data.kweights)
    assert set(en) == set(ref["energies"])
    for k, v in ref["energies"].items():
        close(float(en[k]), v)
    state = type("State", (), dict(psi=psi, occupation=occ.numpy(), basis=b))()
    summary_close(compute_current(state).numpy(), ref["J"])


def test_nonlinearity_potential_and_kernel():
    torch.set_num_threads(1)
    b = make.gp2d_basis(dt, Ecut=8.0, device="cpu")
    ref = REF_A["gp2d"]
    assert list(b.fft_size) == ref["fft_size"]
    psi, occ, rho = _state(b, 2, 22, [0.7, 0.3])
    summary_close(rho.numpy(), ref["rho"])
    vol = b.model.unit_cell_volume
    V, _, energies = H.total_potential(b.terms, rho, vol)
    ham = H.build_ham(b.data, b.terms.data, V, b.pruned)
    energies.update(H.psi_energies(ham, psi, occ, b.data.kweights))
    assert set(energies) == set(ref["energies"])
    for k, v in ref["energies"].items():
        close(float(energies[k]), v)
    de = H.density_energies(b.terms, rho, vol)
    close(float(de["LocalNonlinearity"]), ref["energies"]["LocalNonlinearity"])
    summary_close(V.numpy(), ref["V"])
    close(H.apply_H(ham, psi).numpy(), as_complex(ref["Hpsi"]))
    drho = b.tensor(np.random.default_rng(24).normal(size=tuple(rho.shape)) * 1e-3)
    summary_close(apply_kernel(b, rho, drho).numpy(), ref["K"])


def _anyon_args(b, psi, occ, rho):
    hbar, beta, rho_ref, Aref = b.terms.anyonic
    return (occ, torch.sum(rho, dim=0), b.tensor(rho_ref), b.tensor(Aref), b.terms.data.G_cart,
            hbar, beta, b.fft_size, b.model.unit_cell_volume)


def test_anyonic_energy_and_hand_operator():
    torch.set_num_threads(1)
    b = make.anyon_basis(dt, device="cpu")
    ref = REF_A["anyonic"]
    psi, occ, rho = _state(b, 1, 23, [1.0])
    args = _anyon_args(b, psi, occ, rho)
    close(float(anyonic_energy(b.data, psi, *args)), ref["E"])
    close(apply_anyonic(b.data, psi, *args).numpy(), as_complex(ref["Hpsi"]))


def test_anyonic_autograd_matches_hand_operator():
    """torch.autograd of E_anyonic[psi] (with the density of psi inside) is
    2 w f (H_hand psi), within 1e-12 of its max (tests/test_anyonic.py's
    check, in torch's gradient convention)."""
    torch.set_num_threads(1)
    b = make.anyon_basis(dt, device="cpu")
    psi, occ, rho = _state(b, 1, 23, [1.0])
    vol = b.model.unit_cell_volume
    with torch.enable_grad():
        x = psi.clone().requires_grad_(True)
        r = compute_density(b.data, x, occ, b.fft_size, vol, 1)
        (g,) = torch.autograd.grad(anyonic_energy(b.data, x, *_anyon_args(b, x, occ, r)), x)
    hand = 2 * (b.data.kweights[:, None] * occ)[:, :, None] * apply_anyonic(
        b.data, psi, *_anyon_args(b, psi, occ, rho))
    assert float((g - hand).abs().max()) < 1e-12 * float(g.abs().max())
