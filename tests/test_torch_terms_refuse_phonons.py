"""dftk_tpu_torch refuses what the JAX package's second derivatives leave
out (see tests/test_torch_terms_refuse.py): the DFPT dynamical matrices
have no pairwise part, the one at q no magnetic or nonlinear one, and the
elastic tensor by response no blow-up."""
import pytest
from test_torch_terms_refuse import check_refusal


@pytest.mark.parametrize("what, kind, message", [
    ("dynmat_gamma", "pairwise", "PairwisePotential.*clamped-ion Hessian"),
    ("dynmat_q", "pairwise", "PairwisePotential.*clamped-ion Hessian"),
    ("dynmat_q", "magnetic", "Magnetic.*_perm_ham"),
    ("dynmat_q", "nonlinear", "LocalNonlinearity.*apply_kernel_q"),
    ("elastic", "blowup", "elastic_tensor_response.*Kinetic blow-up")])
def test_reference_gap_raises(what, kind, message):
    check_refusal(what, kind, message)
