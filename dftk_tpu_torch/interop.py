"""Carry arrays of the JAX package (`dftk_tpu`) into the port's tensors.

Takes numpy arrays only: it imports neither jax nor the JAX package.  The
two packages draw random numbers from different generators, so comparisons
between them share inputs rather than seeds: the JAX package's basis and
terms arrays, its orbitals and its density go through these functions
(as `np.asarray(...)` of the JAX arrays) onto the port's device and dtype.
"""
from typing import Any, NamedTuple

import numpy as np
import torch

from .basis import BasisData, real_dtype
from .ops.terms import TermsData


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def basis_arrays_from_numpy(*, Gidx, mask, kin, Gpk_cart, kweights, kspin,
                            vloc_static, hartree_coeffs, P, D, Gsq_cart,
                            kinetic_scale=1.0, kin_explicit=None, Apot=None,
                            device="cuda", dtype=torch.complex128):
    """The JAX package's `basis.data` and `basis.terms.data` arrays as the
    port's (BasisData, TermsData) on `device`, complex `dtype` and its real
    counterpart (NLCC core densities: `mgga_from_numpy`).  kin_explicit is
    the JAX terms' explicit kinetic [nk, nG] (`terms.kin_np`: a blow-up or
    a kinetic scaling) and Apot its vector potential [n1, n2, n3, 3]
    (`terms.Apot_np`), or None."""
    rdt = real_dtype(dtype)
    bd = BasisData(Gidx=_t(Gidx, torch.int64, device), mask=_t(mask, rdt, device),
                   kin=_t(kin, rdt, device), Gpk_cart=_t(Gpk_cart, rdt, device),
                   kweights=_t(kweights, rdt, device),
                   kspin=_t(kspin, torch.int64, device))
    td = TermsData(vloc_static=_t(vloc_static, rdt, device),
                   hartree_coeffs=_t(hartree_coeffs, rdt, device),
                   P=_t(P, dtype, device), D=_t(D, rdt, device),
                   Gsq_cart=_t(Gsq_cart, rdt, device),
                   kinetic_scale=float(kinetic_scale),
                   kin=None if kin_explicit is None else _t(kin_explicit, rdt, device),
                   Apot=None if Apot is None else _t(Apot, rdt, device))
    return bd, td


def state_from_numpy(psi=None, rho=None, device="cuda", dtype=torch.complex128):
    """Orbitals psi [nk, nb, nG] (complex) and density rho [nspin, n1, n2, n3]
    (real; two channels, up and down, under collinear spin) as tensors;
    either may be None."""
    out_psi = None if psi is None else _t(psi, dtype, device)
    out_rho = None if rho is None else _t(rho, real_dtype(dtype), device)
    return out_psi, out_rho


def mgga_from_numpy(tau=None, Vtau=None, rho_core=None, tau_core=None, device="cuda",
                    dtype=torch.float64):
    """A meta-GGA state's and an NLCC model's grid arrays: the kinetic-energy
    density tau and the potential Vtau [nspin, n1, n2, n3] (an SCF's, or
    `total_potential`'s), and the terms' core density and core kinetic-
    energy density [n1, n2, n3], as real tensors of `dtype`; any may be
    None."""
    return tuple(None if a is None else _t(a, dtype, device)
                 for a in (tau, Vtau, rho_core, tau_core))


def split_state_from_numpy(U=None, rho=None, occupation=None, device="cuda",
                           dtype=torch.float64):
    """A split SCF's state: realified orbitals U [nk, nb, 2nG] (rows [x; y],
    as the JAX split SCF returns them, and as `self_consistent_field_split`
    takes `U0`), the density rho [nspin, n1, n2, n3] (`rho0`) and the
    occupations [nk, nb], as real tensors of `dtype`; any may be None."""
    return tuple(None if a is None else _t(a, dtype, device) for a in (U, rho, occupation))


class SCFState(NamedTuple):
    """An SCF state on the port's device: what the response functions
    (`make_chi0_context`, `solve_dyson`, `compute_polarizability`) read of
    an SCF result."""
    basis: Any
    psi: torch.Tensor            # [nk, nb, nG] complex
    occupation: torch.Tensor     # [nk, nb]
    eigenvalues: torch.Tensor    # [nk, nb]
    epsF: float
    rho: torch.Tensor            # [nspin, n1, n2, n3]


def scf_state_from_numpy(basis, psi, occupation, eigenvalues, epsF, rho):
    """A JAX SCF result's state (its psi, occupation, eigenvalues, epsF and
    rho, as numpy) as an SCFState on the port's `basis` (its device and
    dtypes), so that both packages' response functions see one state."""
    rdt = real_dtype(basis.dtype)
    return SCFState(basis=basis, psi=_t(psi, basis.dtype, basis.device),
                    occupation=_t(occupation, rdt, basis.device),
                    eigenvalues=_t(eigenvalues, rdt, basis.device), epsF=float(epsF),
                    rho=_t(rho, rdt, basis.device))
