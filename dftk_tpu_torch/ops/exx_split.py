"""Exact (Fock) exchange with the split engine's API.

Port of `dftk_tpu/ops/exx_split.py`, whose functions take and return
realified orbitals U [nk, nb, 2nG] (a row [x; y] per complex band x + iy)
because the TPU backend has no complex dtype.  The port keeps that API at
the boundary only and computes on complex tensors through
`ops/hamiltonian.py::apply_exchange` and `ops/exx_ace.py` (the realified
algebra is a TPU workaround, ROADMAP "Not to port"); the split SCF itself
calls the complex functions directly.
"""
import torch

from .engine_split import _complex as _cplx
from .engine_split import _realified as _rows
from .exx_ace import apply_ace, build_ace
from .hamiltonian import Exchange, apply_exchange


def _exchange(kern, U_gen, f_gen, Gidx, mask, fft_size, volume, iq, kspin):
    kern = torch.as_tensor(kern)
    assert tuple(kern.shape[-3:]) == tuple(fft_size)
    return Exchange(kernel=kern, psi=_cplx(U_gen), occ=f_gen, Gidx=Gidx,
                    mask=mask, volume=volume, iq=iq, kspin=kspin)


def apply_exchange_split(kern, U_gen, f_gen, U, Gidx, mask, fft_size, volume,
                         iq=None, kspin=None):
    """(Vx phi) on realified bands U [nk, nb, 2nG] -> [nk, nb, 2nG].

    kern  [n1,n2,n3] kernel at Gamma, or the [nq, n1,n2,n3] stack at G + q
          (`ops/coulomb.py::exx_q_kernels`) with iq [nk, nk] and kspin [nk]
    U_gen [nk, nx, 2nG] generating orbitals, f_gen [nk, nx] their weights
          w_k f / filled."""
    exx = _exchange(kern, U_gen, f_gen, Gidx, mask, fft_size, volume, iq, kspin)
    return _rows(apply_exchange(exx, _cplx(U)))


def exchange_energy_split(kern, U, f_gen, occupation, kweights, Gidx, mask, fft_size,
                          volume, iq=None, kspin=None):
    """E_x = 1/2 sum w f <psi|Vx psi> of realified bands U, generated by
    themselves at weights f_gen."""
    vx = apply_exchange_split(kern, U, f_gen, U, Gidx, mask, fft_size, volume, iq, kspin)
    band_e = torch.sum(U * vx, -1)                      # Re <u|vx u>
    return 0.5 * torch.sum(kweights[:, None] * occupation * band_e)


def build_ace_split(kern, U_gen, f_gen, Gidx, mask, fft_size, volume, jitter=None,
                    iq=None, kspin=None):
    """The ACE vectors Xi [nk, nx, 2nG] of realified generators (per k
    point: on a k-grid W carries the cross-k generator sum).  The default
    jitter is the JAX package's: max(1e-12, 50 eps) of U_gen's dtype."""
    if jitter is None:
        jitter = max(1e-12, 50 * torch.finfo(U_gen.dtype).eps)
    exx = _exchange(kern, U_gen, f_gen, Gidx, mask, fft_size, volume, iq, kspin)
    return _rows(build_ace(exx, jitter))


def apply_ace_split(xi, U):
    """(V_ACE phi) = -Xi (Xi^H phi) on realified bands."""
    return _rows(apply_ace(_cplx(xi), _cplx(U)))
