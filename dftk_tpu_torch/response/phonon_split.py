"""Gamma-point DFPT dynamical matrices at a split-SCF state.

Port of the API of `dftk_tpu/response/phonon_split.py::
dynmat_dfpt_gamma_split`.  The JAX package assembles the bare
perturbations, the Sternheimer solves and the screening in realified
arithmetic for the TPU; on the card this is an adapter over the complex
path, as `response/chi0_split.py` is: the split SCF's orbitals become
complex psi (`scf/energy_eval.py::split_state_to_complex`) and
`response/phonon_dfpt.py::dynmat_dfpt_gamma` computes the matrix, every
dV psi and every apply of H on kernels A -> B -> A on a CUDA tensor.
Insulators and metals (T > 0: the occupation and Fermi-level response and
the divided-difference band pairs).  Psps with an NLCC core density
raise, as in the reference.

Not ported: the reference's f32 workarounds `_clamped_hessian_np` (the
clamped-ion Hessian in host numpy, because its f32 autodiff Hessian was
the largest error of the all-f32 pipeline) and `_bare_rhs_split` (the bare
perturbations in split-complex arithmetic), nor `_dvloc_grids_real`: the
complex path's double-backward Hessian and `_bare_rhs` do their work in
float64.
"""
import torch

from ..interop import SCFState
from ..scf.energy_eval import split_state_to_complex
from .chi0_split import _real
from .phonon_dfpt import dynmat_dfpt_gamma
from ..parallel.mesh import refuse_distributed


def dynmat_dfpt_gamma_split(basis, sd, split_res, tol=1e-6, sternheimer_tol=None,
                            acoustic_sum_rule=True, band_chunk=None):
    """Cartesian force-constant matrix [3na, 3na] (numpy) at Gamma of a
    `self_consistent_field_split` result dict (csplit band representation;
    U, occupation, eigenvalues, rho and, for metals, epsF) on `basis`, the
    full (unfolded) k-set.  sternheimer_tol defaults to 1e-10 in float64
    and 1e-5 in float32, as the reference's; sd and band_chunk are taken
    for its signature."""
    refuse_distributed(basis, "dynmat_dfpt_gamma_split")
    if basis.terms.rho_core_np is not None:
        raise NotImplementedError("split DFPT with NLCC psps is not implemented (nor in "
                                  "the reference)")
    if sternheimer_tol is None:
        sternheimer_tol = 1e-10 if basis.rdtype == torch.float64 else 1e-5
    psi, occ = split_state_to_complex(basis, split_res["U"], split_res["occupation"])

    state = SCFState(basis=basis, psi=psi, occupation=occ,
                     eigenvalues=_real(basis, split_res["eigenvalues"]),
                     epsF=float(split_res.get("epsF", 0.0)), rho=_real(basis, split_res["rho"]))
    return dynmat_dfpt_gamma(state, tol=tol, sternheimer_tol=sternheimer_tol,
                             acoustic_sum_rule=acoustic_sum_rule)
