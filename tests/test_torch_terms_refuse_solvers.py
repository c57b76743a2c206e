"""dftk_tpu_torch refuses what the JAX package's other solvers leave out
(see tests/test_torch_terms_refuse.py): Newton, direct minimization and
the energy evaluation report no PairwisePotential energy, and the
evaluation and the response drop the Anyonic term; the terms without a
gap run (the forces take the pairwise term, a Magnetic SCF reports its
energy)."""
import types

import numpy as np
import pytest
import torch
from test_torch_terms import make
from test_torch_terms_refuse import cell_with, check_refusal

import dftk_tpu_torch as dt


@pytest.mark.parametrize("what, kind, message", [
    ("newton", "pairwise", "PairwisePotential.*newton.py"),
    ("evaluate", "pairwise", "PairwisePotential.*energy_eval.py"),
    ("evaluate", "anyonic", "direct_minimization"),
    ("direct", "pairwise", "PairwisePotential.*direct.py"),
    ("chi0", "anyonic", "direct_minimization")])
def test_reference_gap_raises(what, kind, message):
    check_refusal(what, kind, message)


def test_terms_without_a_gap_do_not_raise():
    """The forces take the pairwise term, and a Magnetic model's SCF
    energies carry the Magnetic entry (the refusals name only the gaps)."""
    b = cell_with("pairwise")
    nb = 4
    psi = torch.as_tensor(make.seeded_orbitals(b.mask_np, nb, 3))
    occ = torch.full((1, nb), 2.0, dtype=torch.float64)
    rho = dt.guess_density(b)
    F = dt.compute_forces(types.SimpleNamespace(psi=psi, occupation=occ, rho=rho), b).numpy()
    assert np.isfinite(F).all()
    res = dt.self_consistent_field(cell_with("magnetic"), tol=1e-6, maxiter=3)
    assert "Magnetic" in res.energies
