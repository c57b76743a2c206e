"""dftk_tpu_torch's model-Hamiltonian terms through the entry points, against
the JAX package's SCFs from the same numpy starts
(tests/data/torch_port_terms.json; see tests/test_torch_terms.py), torch
at one thread, float64, on the CPU:
  * Fock-Darwin (Ecut 10, Magnetic): the LOBPCG SCF's eigenvalues (1e-8)
    and energies (1e-8 Ha), the L_z of `compute_current` (1e-8; -1 within
    1e-3), and direct minimization's energy (1e-8 Ha);
  * the 1D Gross-Pitaevskii equation with Gaussian nuclei
    (examples/custom_potential.py, Ecut 500, LocalNonlinearity on a line):
    energies 1e-8 Ha, forces 1e-7 Ha/bohr and |F0 + F1| < 1e-5;
  * Si2 with BlowupCHV and with BlowupAbinit: both SCF loops (the split
    loop's CheFSI takes LOBPCG steps under a blow-up, bf16 then exact)
    against the JAX LOBPCG and split SCFs, 1e-8 Ha;
  * Si2 with a smooth external potential and a Lennard-Jones pairwise
    term: both loops' energies (the split loop with the exact CheFSI
    filter; 1e-8 Ha; the split total minus its PairwisePotential entry
    against the JAX split total, which has none) and the LOBPCG forces
    (1e-7 Ha/bohr);
  * anyons (Ecut 8, beta 5) by direct minimization from the winding
    start: energies 1e-8 Ha.
"""
import numpy as np
import pytest
import torch
from test_torch_terms import REF, make

import dftk_tpu_torch as dt
from dftk_tpu_torch.postprocess.current import compute_current

E_BAR, F_BAR = 1e-8, 1e-7


def _energies_close(out, ref, bar=E_BAR):
    assert set(out) == set(ref), (sorted(out), sorted(ref))
    for k, v in ref.items():
        assert abs(out[k] - v) < bar, (k, out[k], v)


def _start(basis, n_bands, seed):
    return torch.as_tensor(make.seeded_orbitals(basis.mask_np, n_bands, seed))


def test_fock_darwin():
    torch.set_num_threads(1)
    ref = REF["fock_darwin"]
    b = make.fock_darwin_basis(dt, Ecut=10.0, device="cpu")
    psi0 = _start(b, 9, 25)
    res = dt.self_consistent_field(b, tol=1e-10, n_bands=6, maxiter=30, psi=psi0)
    assert res.converged
    assert np.abs(res.eigenvalues[0, :6] - np.array(ref["eigenvalues"])[:6]).max() < E_BAR
    _energies_close(res.energies, ref["energies"])
    Lz = make.lz(b, compute_current(res).numpy())
    assert abs(Lz - ref["Lz"]) < E_BAR and abs(Lz + 1) < 1e-3
    d = dt.direct_minimization(b, tol=1e-10, maxiter=400, psi=psi0[:, :2])
    assert d.converged
    _energies_close(d.energies, ref["direct"]["energies"])


def test_gp1d_scf_and_forces():
    torch.set_num_threads(1)
    ref = REF["gp1d"]
    b = make.gp1d_basis(dt, device="cpu")
    assert list(b.fft_size) == ref["fft_size"]
    res = dt.self_consistent_field(b, tol=1e-10, maxiter=60, psi=_start(b, 4, 26),
                                   rho=torch.zeros((1,) + b.fft_size, dtype=torch.float64))
    assert res.converged
    _energies_close(res.energies, ref["energies"])
    F = dt.compute_forces(res).numpy()
    assert np.abs(F - np.array(ref["forces"])).max() < F_BAR
    assert abs(F[0, 0] + F[1, 0]) < 1e-5


def _both_loops(b, filter_precision="mixed"):
    psi0 = make.seeded_orbitals(b.mask_np, 7, 27)
    res = dt.self_consistent_field(b, tol=1e-10, maxiter=40, n_bands=4,
                                   psi=torch.as_tensor(psi0))
    split = dt.self_consistent_field_split(
        b, tol=1e-10, maxiter=60, n_bands=4, n_extra_bands=3, eigensolver="chefsi",
        is_converged="density", U0=torch.as_tensor(np.concatenate([psi0.real, psi0.imag], -1)),
        diagtol_min=1e-12, filter_precision=filter_precision)
    assert res.converged and split["converged"]
    return res, split


@pytest.mark.parametrize("blowup", ["chv", "abinit"])
def test_si2_blowup_both_loops(blowup):
    torch.set_num_threads(1)
    ref = REF["si2"][blowup]
    bl = {"chv": dt.BlowupCHV, "abinit": dt.BlowupAbinit}[blowup]()
    res, split = _both_loops(make.si2_basis(dt, blowup=bl, device="cpu"))
    _energies_close(res.energies, ref["energies"])
    _energies_close(split["energies"], ref["split"]["energies"])


def test_si2_external_pairwise():
    torch.set_num_threads(1)
    ref = REF["si2"]["ext_pair"]
    res, split = _both_loops(make.si2_basis(dt, external=True, pairwise=True, device="cpu"),
                             "highest")
    _energies_close(res.energies, ref["energies"])
    E_pw = ref["energies"]["PairwisePotential"]
    assert abs(split["energies"]["PairwisePotential"] - E_pw) < E_BAR
    _energies_close({k: v - (E_pw if k == "total" else 0.0)
                     for k, v in split["energies"].items() if k != "PairwisePotential"},
                    ref["split"]["energies"])
    assert abs(split["energies"]["total"] - ref["energies"]["total"]) < E_BAR
    F = dt.compute_forces(res).numpy()
    assert np.abs(F - np.array(ref["forces"])).max() < F_BAR


def test_anyons_direct_minimization():
    torch.set_num_threads(1)
    ref = REF["anyons"]
    b = make.anyon_basis(dt, device="cpu")
    res = dt.direct_minimization(b, tol=1e-10, maxiter=3000,
                                 psi=torch.as_tensor(make.winding_start(b)))
    assert res.converged
    _energies_close(res.energies, ref["energies"])
