"""Where the JAX package leaves a model-Hamiltonian term out of a
computation without an error, dftk_tpu_torch raises NotImplementedError
naming the reference's gap (ROADMAP Queue 3), rather than return a number
that silently lacks the term.  Each case is held by its message, on small
CPU cells (tests/data/make_torch_port_terms.py's constructors).  This file
has the SCF loops and the helpers; tests/test_torch_terms_refuse_*.py the
other solvers, the phonons and the stresses (six cases or fewer a file, so
that pytest-xdist sends each out after the long tests/test_phonon_q.py):
  * the split SCF has no Magnetic, LocalNonlinearity or Anyonic term (its
    split data carry no vector potential, its split potential no
    nonlinearity), nor does the LOBPCG SCF take Anyonic (both name
    direct_minimization for it, as the JAX package's driver does), and
    potential mixing reports no PairwisePotential energy and drops the
    Anyonic term.
"""
import functools
import types

import pytest
import torch
from test_torch_terms import make

import dftk_tpu_torch as dt


@functools.lru_cache(maxsize=None)
def cell_with(kind):
    """A small CPU basis with the term `kind` (cached)."""
    torch.set_num_threads(1)
    return {"magnetic": lambda: make.fock_darwin_basis(dt, Ecut=3.0, device="cpu"),
            "nonlinear": lambda: make.gp1d_basis(dt, Ecut=30.0, device="cpu"),
            "anyonic": lambda: make.anyon_basis(dt, Ecut=3.0, device="cpu"),
            "pairwise": lambda: make.si2_basis(dt, pairwise=True, device="cpu"),
            "external": lambda: make.external_bases(dt, device="cpu")["real"],
            "blowup": lambda: make.si2_basis(dt, blowup=dt.BlowupCHV(), device="cpu")}[kind]()


def _state(basis):
    return types.SimpleNamespace(basis=basis, psi=None, occupation=None, rho=None,
                                 eigenvalues=None, epsF=0.0)


def _call(what, basis):
    from dftk_tpu_torch.response.chi0 import make_chi0_context
    from dftk_tpu_torch.response.phonon_dfpt import dynmat_dfpt_gamma
    from dftk_tpu_torch.response.phonon_q import dynmat_dfpt_q
    from dftk_tpu_torch.scf.newton import newton
    from dftk_tpu_torch.scf.potential_mixing import scf_potential_mixing
    st = _state(basis)
    return {"split": lambda: dt.self_consistent_field_split(basis),
            "scf": lambda: dt.self_consistent_field(basis),
            "direct": lambda: dt.direct_minimization(basis),
            "potential_mixing": lambda: scf_potential_mixing(basis),
            "newton": lambda: newton(basis),
            "evaluate": lambda: dt.evaluate_total_energy(basis, None, None),
            "chi0": lambda: make_chi0_context(st),
            "dynmat_gamma": lambda: dynmat_dfpt_gamma(st),
            "dynmat_q": lambda: dynmat_dfpt_q(st, [0.5, 0.0, 0.0]),
            "stresses": lambda: dt.compute_stresses_cart(st),
            "elastic": lambda: dt.elastic_tensor_response(st)}[what]()


def check_refusal(what, kind, message):
    """`what` on the cell `kind` raises NotImplementedError matching message."""
    with pytest.raises(NotImplementedError, match=message):
        _call(what, cell_with(kind))


@pytest.mark.parametrize("what, kind, message", [
    ("split", "magnetic", "Magnetic.*self_consistent_field"),
    ("split", "nonlinear", "LocalNonlinearity.*engine_split"),
    ("split", "anyonic", "direct_minimization"),
    ("scf", "anyonic", "direct_minimization"),
    ("potential_mixing", "anyonic", "direct_minimization"),
    ("potential_mixing", "pairwise", "PairwisePotential.*potential_mixing.py")])
def test_reference_gap_raises(what, kind, message):
    check_refusal(what, kind, message)
