"""chi0 and the Dyson equation at a split-SCF state.

Port of the API of `dftk_tpu/response/chi0_split.py`.  The JAX package
solves the Sternheimer equations on realified vectors u = (x; y) so that
the response compiles on TPU backends without complex dtypes; the card has
complex128, so these are adapters, as `ops/forces_split.py` is: the split
SCF's orbitals (rows [x; y] per complex band, `scf/energy_eval.py::
split_state_to_complex`) become complex psi, the response runs through
`response/chi0.py` and `response/hessian.py` (every apply of H and every
dV psi on kernels A -> B -> A on a CUDA tensor), and what the reference
returns realified (dpsi, the Sternheimer solution) comes back as rows
[x; y].  The reference's Sternheimer solve has no Schur complement of the
computed unoccupied bands, and neither have these adapters.

Not ported: the reference's csplit helpers `_project_out_c` (the complex
projector on realified vectors) and `_dV_times_U` (dV psi by matmul DFTs
on realified cubes), TPU workarounds (ROADMAP, "Not to port"): the complex
path's `_project_out` and `apply_dV` do their work.
"""
from typing import Any, NamedTuple

import torch

from ..ops import hamiltonian as hamops
from ..ops.engine_split import _complex, _realified
from ..scf.energy_eval import split_state_to_complex
from .chi0 import Chi0Context, apply_chi0_generic, apply_dV, sternheimer_solver
from .hessian import apply_kernel, gmres
from ..parallel.mesh import refuse_distributed


def sternheimer_split(apply_H, U_occ, eps_occ, rhs, kin2, mask2, tol=1e-6, maxiter=200):
    """The projected Sternheimer system P_c (H - eps_n) P_c dpsi_n =
    -P_c rhs_n on realified rows: U_occ [nk, no, 2nG] the occupied bands,
    eps_occ [nk, no], rhs [nk, no, 2nG], apply_H on realified rows (e.g.
    `ops/engine_split.py::apply_H_split`), kin2 and mask2 [nk, 2nG] the
    kinetic energies and mask repeated for x and y.  Returns dpsi
    (realified), orthogonal in the complex sense to the occupied space:
    `response/chi0.py::sternheimer_solver` on the complex bands."""
    nG = kin2.shape[-1] // 2

    def apply_c(x):
        return _complex(apply_H(_realified(x).to(U_occ.dtype)))

    dpsi = sternheimer_solver(apply_c, _complex(U_occ), eps_occ, _complex(rhs), kin2[..., :nG],
                              mask2[..., :nG], tol=tol, maxiter=maxiter)
    return _realified(dpsi).to(U_occ.dtype)


class SplitChi0Context(NamedTuple):
    """A split-SCF state for repeated chi0 applies: the split data, the
    total potential V [nspin, grid], the realified orbitals U and their
    occupations, eigenvalues and Fermi level, and the complex H and psi the
    adapters apply."""
    sd: Any
    V: torch.Tensor
    U: torch.Tensor
    occupation: torch.Tensor
    eigenvalues: torch.Tensor
    epsF: torch.Tensor
    ham: hamops.Ham
    psi: torch.Tensor


def _real(basis, a):
    """a (numpy, a tensor or a number) as a real tensor of the basis' dtype
    on its device."""
    return torch.as_tensor(a, dtype=basis.rdtype, device=basis.device)


def make_chi0_split_context(basis, sd, split_res):
    """The SplitChi0Context of a `self_consistent_field_split` result dict
    (or any dict with U, occupation, eigenvalues, rho and optionally epsF,
    numpy or tensors) in the csplit band representation: one U row [x; y]
    per complex band."""
    refuse_distributed(basis, "make_chi0_split_context")
    rho = _real(basis, split_res["rho"])
    V, _, _ = hamops.total_potential(basis.terms, rho, basis.model.unit_cell_volume)
    psi, occ = split_state_to_complex(basis, split_res["U"], split_res["occupation"])
    return SplitChi0Context(
        sd=sd, V=V, U=_real(basis, split_res["U"]), occupation=occ,
        eigenvalues=_real(basis, split_res["eigenvalues"]),
        epsF=_real(basis, float(split_res.get("epsF", 0.0))),
        ham=hamops.build_ham(basis.data, basis.terms.data, V, basis.pruned), psi=psi)


def _chi0_context(ctx: SplitChi0Context):
    return Chi0Context(ham=ctx.ham, psi=ctx.psi, occupation=ctx.occupation,
                       eigenvalues=ctx.eigenvalues, epsF=ctx.epsF)


def apply_chi0_split_ctx(basis, ctx: SplitChi0Context, delta_V=None, tol=1e-6,
                         occupation_threshold=1e-8, band_chunk=None, rhs=None,
                         with_detail=False):
    """delta_rho = chi0 delta_V for a local potential delta_V [nspin, grid],
    or the response to a general realified rhs = dH psi [nk, nb, 2nG] (the
    displacement perturbations of the phonon DFPT).  T > 0 includes the
    occupation and Fermi-level response and the divided-difference band
    pairs.  with_detail=True returns (drho, dpsi [nk, nb, 2nG] realified,
    df, depsF).  band_chunk is taken for the reference's signature: the
    complex apply takes every band at once."""
    refuse_distributed(basis, "apply_chi0_split_ctx")
    if rhs is None:
        nspin = basis.model.n_spin_components
        dV = _real(basis, delta_V).expand((nspin,) + tuple(basis.fft_size))
        dVpsi = apply_dV(ctx.ham, ctx.psi, dV, basis.data.kspin)
    else:
        dVpsi = _complex(_real(basis, rhs))
    out = apply_chi0_generic(_chi0_context(ctx), basis, dVpsi, tol=tol,
                             occupation_threshold=occupation_threshold, use_schur=False,
                             with_detail=with_detail)
    if not with_detail:
        return out
    drho, dpsi, df, depsF = out
    return drho, _realified(dpsi), df, depsF


def apply_kernel_split(basis, sd, rho0, drho):
    """K drho = d(V_H + V_xc)/drho . drho (`response/hessian.py::
    apply_kernel`; sd is taken for the reference's signature)."""
    return apply_kernel(basis, _real(basis, rho0), drho)


def solve_dyson_split(basis, ctx: SplitChi0Context, dV_ext, rho0, tol=1e-6, maxiter=40,
                      sternheimer_tol=1e-6, band_chunk=None, verbose=False):
    """The self-consistent density response at a split-SCF state: (1 -
    chi0 K) drho = chi0 dV_ext by GMRES (`response/hessian.py::gmres`)
    over `apply_chi0_split_ctx` and `apply_kernel_split`.  Returns (drho,
    dV_tot)."""
    refuse_distributed(basis, "solve_dyson_split")
    dV_ext = _real(basis, dV_ext)

    def chi0(dv):
        return apply_chi0_split_ctx(basis, ctx, dv, tol=sternheimer_tol, band_chunk=band_chunk)

    def kernel(dr):
        return apply_kernel_split(basis, ctx.sd, rho0, dr)

    drho = gmres(lambda d: d - chi0(kernel(d)), chi0(dV_ext), tol=tol, maxiter=maxiter,
                 verbose=verbose)
    return drho, dV_ext + kernel(drho)
