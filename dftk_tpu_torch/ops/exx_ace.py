"""Adaptively Compressed Exchange (ACE) for hybrid-functional SCF.

Port of `dftk_tpu/ops/exx_ace.py` (Lin Lin, JCTC 12, 2242 (2016)).  The
Fock operator applied inside the eigensolver is replaced by its low-rank
compression

    V_ACE = - sum_m |xi_m><xi_m|,   Xi = conj(L^{-1}) W,   L L^H = -Psi^H W,
    W_m = Vx psi_m,

which agrees with Vx exactly on span(Psi) and is negative semidefinite
everywhere.  One full exchange apply per SCF step (building W) replaces
one per eigensolver matvec; the compressed apply is two GEMMs.
"""
import torch

from .hamiltonian import Exchange, apply_exchange


class AceCounts:
    """The ACE builds since the last reset (each one bare exchange apply)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.builds = 0


counts = AceCounts()


def build_ace(exx: Exchange, jitter=1e-12):
    """Xi [nk, nx, nG] for the generators of exx (psi of exx is Psi).

    -M = -Psi^H W is positive semidefinite up to round-off (the Coulomb
    kernel is >= 0); rows of zero occupation make it singular, so the
    Cholesky factor is taken of -M plus jitter times its trace (at least 1)."""
    counts.builds += 1
    psi = exx.psi
    W = apply_exchange(exx, psi)                                   # Vx psi
    M = psi.conj() @ W.transpose(1, 2)                             # [nk, nx, nx]
    M = (M + M.conj().transpose(1, 2)) / 2
    nx = M.shape[-1]
    tr = torch.clamp(-torch.diagonal(M, dim1=1, dim2=2).sum(-1).real, min=1.0)
    A = -M + (jitter * tr)[:, None, None] * torch.eye(nx, dtype=M.dtype, device=M.device)
    L = torch.linalg.cholesky(A)
    # V_ACE Psi = W  <=>  C^H C = -(M^T)^{-1} for Xi = C W, solved by
    # C = conj(L)^{-1}:  Xi = conj(L^{-1} conj(W))
    return torch.linalg.solve_triangular(L, W.conj(), upper=False).conj()


def apply_ace(xi, phi):
    """(V_ACE phi) = - xi (xi^H phi): two GEMMs per k."""
    c = phi @ xi.conj().transpose(1, 2)                            # [nk, nb, nx]
    return -(c @ xi)
