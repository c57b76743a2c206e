"""Pruned transforms between the G-sphere and real space.

Port of `dftk_tpu/ops/engine_split.py::build_pruned_fft` (:91-135), written
with complex factors instead of the JAX package's realified ones.

The G-sphere occupies only m_a of the n_a grid indices along axis a, so the
sphere -> real-space transform can start from a "compact cube"
[m1, m2, m3] holding exactly the occupied planes, and contract each axis
with a rectangular DFT factor:

    forward  F_a [m_a, n_a] = exp(+2 pi i g j / n_a)       (compact -> grid)
    backward B_a [n_a, m_a] = exp(-2 pi i j g / n_a) / n_a (grid -> compact)

for g the occupied frequencies and j the grid points.  The 1/n_a in B_a
makes backward(V * forward(x)) the sphere matrix element of V without a
separate scaling pass.  The local-potential apply of `ops/hamiltonian.py`
runs this chain through `kernels/local_apply.py`.

m_a is padded to a multiple of 8 as in the JAX package; the pad cells are
never occupied and their factor rows and columns are zero.  Keeping the pad
makes the compact index maps equal to the JAX package's element by element.
"""
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.local_apply import LocalFactors


_COMPLEX = {torch.float64: torch.complex128, torch.float32: torch.complex64}


class PrunedFFT(NamedTuple):
    Gidx_c: torch.Tensor     # [nk, nG] int64 flat index into the compact cube
    inv_idx: torch.Tensor    # [nk, m1*m2*m3] int64 sphere slot per compact
    #                          cell (nG = "read a zero" slot)
    m_shape: tuple           # (m1, m2, m3)
    factors: LocalFactors    # complex axis factors, see module docstring


def build_pruned_fft(basis, dtype=None, pad=8):
    """The basis' pruned transforms, factors in the complex `dtype` (default
    the basis' own; a real dtype, the reference's spelling, takes its
    complex counterpart)."""
    dtype = basis.dtype if dtype is None else _COMPLEX.get(dtype, dtype)
    fft_size = basis.fft_size
    idx = basis.Gidx_np                            # [nk, nG] flat full-cube
    iaxes = np.unravel_index(idx, fft_size)        # 3 x [nk, nG]
    sels, poss, m = [], [], []
    for a in range(3):
        sel = np.unique(iaxes[a])                  # sorted occupied indices
        pos = np.full(fft_size[a], -1, dtype=np.int64)
        pos[sel] = np.arange(len(sel))
        sels.append(sel)
        poss.append(pos)
        m.append(-(-len(sel) // pad) * pad)
    Gidx_c = (poss[0][iaxes[0]] * m[1] + poss[1][iaxes[1]]) * m[2] \
        + poss[2][iaxes[2]]

    fwd, bwd = [], []
    for a in range(3):
        n = fft_size[a]
        F = np.zeros((m[a], n), dtype=np.complex128)
        F[:len(sels[a])] = np.exp(2j * np.pi * np.outer(sels[a], np.arange(n)) / n)
        fwd.append(basis.tensor(F, dtype))
        bwd.append(basis.tensor(F.T.conj() / n, dtype))

    # inverse placement map: compact cell -> sphere slot (nG = zero pad);
    # only real (mask > 0) sphere slots participate
    nk, nG = idx.shape
    inv = np.full((nk, int(np.prod(m))), nG, dtype=np.int64)
    live = basis.mask_np > 0
    for k in range(nk):
        inv[k, Gidx_c[k, live[k]]] = np.nonzero(live[k])[0]
    return PrunedFFT(Gidx_c=basis.tensor(Gidx_c, torch.int64),
                     inv_idx=basis.tensor(inv, torch.int64),
                     m_shape=tuple(m),
                     factors=LocalFactors(fwd=tuple(fwd), bwd=tuple(bwd)))


def sphere_to_compact(psi, pf: PrunedFFT):
    """[nk, nb, nG] sphere coefficients -> [nk, nb, m1, m2, m3] compact cube
    (a gather through the inverse map; empty cells read the zero pad)."""
    nk, nb, _ = psi.shape
    padded = torch.nn.functional.pad(psi, (0, 1))
    Nc = pf.inv_idx.shape[-1]
    flat = torch.gather(padded, 2, pf.inv_idx[:, None, :].expand(nk, nb, Nc))
    return flat.reshape((nk, nb) + pf.m_shape)


def compact_to_sphere(xc, pf: PrunedFFT, mask):
    """[nk, nb, m1, m2, m3] compact cube -> [nk, nb, nG] (masked)."""
    nk, nb = xc.shape[:2]
    flat = xc.reshape(nk, nb, -1)
    nG = pf.Gidx_c.shape[-1]
    out = torch.gather(flat, 2, pf.Gidx_c[:, None, :].expand(nk, nb, nG))
    return out * mask[:, None, :]
