"""Dense diagonalization (reference `src/eigen/diag_full.jl`).

Port of `dftk_tpu/ops/eigen/dense.py`: the operator is materialised as a
[nk, nG, nG] matrix by applying it to the identity, and diagonalised by
batched `torch.linalg.eigh`.  Only for small problems and tests; padded
basis entries get a large diagonal so that they sort to the top.
"""
import torch

_PAD_SHIFT = 1e6


def diag_full(apply_A, nk, nG, mask, n_bands, dtype=torch.complex128):
    """Lowest n_bands eigenpairs of the operator at each k-point:
    eigenvalues [nk, n_bands] and vectors [nk, n_bands, nG]."""
    eye = torch.eye(nG, dtype=dtype, device=mask.device)
    cols = apply_A(eye.expand(nk, nG, nG) * mask[:, :, None])   # cols[k, n] = H e_n
    H = cols.transpose(1, 2)
    H = (H + H.conj().transpose(1, 2)) / 2
    H = H + torch.diag_embed((1.0 - mask) * _PAD_SHIFT).to(dtype)
    w, v = torch.linalg.eigh(H)
    return w[:, :n_bands], v[:, :, :n_bands].transpose(1, 2) * mask[:, None, :]
