"""Real solid harmonics (host-side numpy), for the projector form factors.

Port of `dftk_tpu/utils/special.py`.  R_l^m(r) = r^l Y_l^m(r/|r|) for
l <= 3, the Wikipedia real-spherical-harmonics table (the reference's
convention, DFTK `src/common/spherical_harmonics.jl:31-66`).

Input [..., 3] -> output [..., (lmax+1)^2] with flat index i = l^2 + (l + m).
"""
import numpy as np

LM_INDEX = {(l, m): l * l + l + m for l in range(4) for m in range(-l, l + 1)}


def solid_harmonics_real(rvec, lmax):
    """All real solid harmonics up to lmax, stacked on the last axis."""
    if lmax > 3:
        raise NotImplementedError("solid harmonics only implemented for l <= 3")
    rvec = np.asarray(rvec)
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    pi = np.pi
    out = [np.full(x.shape, np.sqrt(1 / (4 * pi)), dtype=x.dtype)]
    if lmax >= 1:
        c1 = np.sqrt(3 / (4 * pi))
        out += [c1 * y, c1 * z, c1 * x]
    if lmax >= 2:
        out += [
            np.sqrt(15 / (4 * pi)) * x * y,
            np.sqrt(15 / (4 * pi)) * y * z,
            np.sqrt(5 / (16 * pi)) * (2 * z**2 - x**2 - y**2),
            np.sqrt(15 / (4 * pi)) * x * z,
            np.sqrt(15 / (16 * pi)) * (x**2 - y**2),
        ]
    if lmax >= 3:
        out += [
            np.sqrt(35 / (32 * pi)) * (3 * x**2 - y**2) * y,
            np.sqrt(105 / (4 * pi)) * x * y * z,
            np.sqrt(21 / (32 * pi)) * y * (4 * z**2 - x**2 - y**2),
            np.sqrt(7 / (16 * pi)) * z * (2 * z**2 - 3 * x**2 - 3 * y**2),
            np.sqrt(21 / (32 * pi)) * x * (4 * z**2 - x**2 - y**2),
            np.sqrt(105 / (16 * pi)) * (x**2 - y**2) * z,
            np.sqrt(35 / (32 * pi)) * (x**2 - 3 * y**2) * x,
        ]
    return np.stack(out, axis=-1)
