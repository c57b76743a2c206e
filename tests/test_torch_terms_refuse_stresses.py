"""dftk_tpu_torch's stresses refuse every model-Hamiltonian term and the
kinetic blow-up, which the JAX package's `energy_at_lattice` leaves out
(see tests/test_torch_terms_refuse.py)."""
import pytest
from test_torch_terms_refuse import check_refusal


@pytest.mark.parametrize("what, kind, message", [
    ("stresses", "pairwise", "PairwisePotential.*energy_at_lattice"),
    ("stresses", "external", "ExternalFromReal.*energy_at_lattice"),
    ("stresses", "magnetic", "Magnetic.*energy_at_lattice"),
    ("stresses", "nonlinear", "LocalNonlinearity.*energy_at_lattice"),
    ("stresses", "anyonic", "Anyonic.*energy_at_lattice"),
    ("stresses", "blowup", "Kinetic blow-up.*bare kinetic")])
def test_reference_gap_raises(what, kind, message):
    check_refusal(what, kind, message)
