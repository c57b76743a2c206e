"""Real solid harmonics, for the projector form factors.

Port of `dftk_tpu/utils/special.py`.  R_l^m(r) = r^l Y_l^m(r/|r|) for
l <= 3, the Wikipedia real-spherical-harmonics table (the reference's
convention, DFTK `src/common/spherical_harmonics.jl:31-66`).  They are
homogeneous polynomials, so smooth at the origin: on a torch tensor they
are differentiable in `rvec`, which the stresses trace through the lattice.

Input [..., 3] (numpy array or torch tensor) -> output of the same kind
[..., (lmax+1)^2] with flat index i = l^2 + (l + m).
"""
import math

import numpy as np
import torch

LM_INDEX = {(l, m): l * l + l + m for l in range(4) for m in range(-l, l + 1)}


def solid_harmonics_real(rvec, lmax):
    """All real solid harmonics up to lmax, stacked on the last axis."""
    if lmax > 3:
        raise NotImplementedError("solid harmonics only implemented for l <= 3")
    if torch.is_tensor(rvec):
        full, stack = torch.full_like, torch.stack
    else:
        rvec = np.asarray(rvec)
        full, stack = np.full_like, np.stack
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    pi = math.pi
    out = [full(x, math.sqrt(1 / (4 * pi)))]
    if lmax >= 1:
        c1 = math.sqrt(3 / (4 * pi))
        out += [c1 * y, c1 * z, c1 * x]
    if lmax >= 2:
        out += [
            math.sqrt(15 / (4 * pi)) * x * y,
            math.sqrt(15 / (4 * pi)) * y * z,
            math.sqrt(5 / (16 * pi)) * (2 * z**2 - x**2 - y**2),
            math.sqrt(15 / (4 * pi)) * x * z,
            math.sqrt(15 / (16 * pi)) * (x**2 - y**2),
        ]
    if lmax >= 3:
        out += [
            math.sqrt(35 / (32 * pi)) * (3 * x**2 - y**2) * y,
            math.sqrt(105 / (4 * pi)) * x * y * z,
            math.sqrt(21 / (32 * pi)) * y * (4 * z**2 - x**2 - y**2),
            math.sqrt(7 / (16 * pi)) * z * (2 * z**2 - 3 * x**2 - 3 * y**2),
            math.sqrt(21 / (32 * pi)) * x * (4 * z**2 - x**2 - y**2),
            math.sqrt(105 / (16 * pi)) * (x**2 - y**2) * z,
            math.sqrt(35 / (32 * pi)) * (x**2 - 3 * y**2) * x,
        ]
    return stack(out, -1)


def ylm_real(l, m, rvec):
    """Single real spherical harmonic Y_l^m at a unit (or general) vector
    (numpy; 0 at the origin for l > 0)."""
    rvec = np.asarray(rvec, dtype=float)
    r = np.linalg.norm(rvec)
    if l == 0:
        return math.sqrt(1 / (4 * math.pi))
    if r < 10 * np.finfo(float).eps:
        return 0.0
    return float(solid_harmonics_real(rvec / r, l)[..., LM_INDEX[(l, m)]])
