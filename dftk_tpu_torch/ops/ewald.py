"""Ewald summation: point-charge electrostatics in a neutralising background.

Port of the energy of `dftk_tpu/ops/ewald.py` (reference
`src/terms/ewald.jl:64-168`): the real- and reciprocal-space lattice sums
as dense tensor ops over index boxes bounded on the host.

Energy = 1/2 sum'_{ij,R} Zi Zj erfc(eta |ri-rj-R|)/|ri-rj-R|    (real part)
       + 2 pi / Omega sum_{G != 0} |S(G)|^2 e^{-|G|^2/4 eta^2}/|G|^2   (recip)
       - eta/sqrt(pi) sum_i Zi^2  -  pi/(2 eta^2 Omega) (sum_i Zi)^2
"""
import math

import numpy as np
import torch

from ..utils.lattice import compute_recip_lattice, estimate_integer_lattice_bounds


def default_eta(lattice):
    lattice = np.asarray(lattice, dtype=float)
    recip = compute_recip_lattice(lattice)
    return math.sqrt(math.sqrt(1.69 * np.linalg.norm(recip / (2 * np.pi))
                               / np.linalg.norm(lattice))) / 2


def _integer_box(lims):
    axes = [np.arange(-l, l + 1) for l in lims]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)


def ewald_sum_bounds(lattice, positions, eta):
    """Static summation boxes (conservative, DFTK ewald.jl:83-99)."""
    lattice = np.asarray(lattice, dtype=float)
    max_exp_arg = -math.log(np.finfo(float).eps) + 5
    max_erfc_arg = math.sqrt(max_exp_arg)
    recip = compute_recip_lattice(lattice)
    Glims = estimate_integer_lattice_bounds(recip, math.sqrt(max_exp_arg) * 2 * eta)
    pos = np.asarray(positions, dtype=float)
    poslims = np.max(pos[:, None, :] - pos[None, :, :], axis=(0, 1))
    Rlims = estimate_integer_lattice_bounds(lattice, max_erfc_arg / eta, poslims)
    return _integer_box(Glims), _integer_box(Rlims)


def energy_ewald(lattice, charges, positions, eta=None, device="cuda",
                 chunk=64):
    """Ewald energy in float64 on `device`.

    lattice [3,3] (columns), charges [na], positions [na,3] fractional."""
    lattice = np.asarray(lattice, dtype=float)
    if eta is None:
        eta = default_eta(lattice)
    Gbox, Rbox = ewald_sum_bounds(lattice, positions, eta)
    f64 = dict(dtype=torch.float64, device=device)
    L = torch.as_tensor(lattice, **f64)
    q = torch.as_tensor(np.asarray(charges, dtype=float), **f64)
    pos = torch.as_tensor(np.asarray(positions, dtype=float), **f64)
    recip = torch.as_tensor(compute_recip_lattice(lattice), **f64)
    volume = abs(float(np.linalg.det(lattice)))

    # reciprocal sum
    G = torch.as_tensor(Gbox, **f64)
    nonzero = torch.as_tensor(np.any(Gbox != 0, axis=1), device=device)
    Gsq = torch.sum((G @ recip.T) ** 2, dim=1)
    phase = 2 * math.pi * (G @ pos.T)                          # [ng, na]
    sf2 = torch.sum(q * torch.cos(phase), 1) ** 2 \
        + torch.sum(q * torch.sin(phase), 1) ** 2
    Gsq_safe = torch.where(nonzero, Gsq, torch.ones_like(Gsq))
    terms = torch.where(nonzero, sf2 * torch.exp(-Gsq / (4 * eta ** 2)) / Gsq_safe,
                        torch.zeros_like(Gsq))
    sum_recip = (terms.sum() - q.sum() ** 2 / (4 * eta ** 2)) * 4 * math.pi / volume

    # real-space sum, chunked over the lattice images
    R = torch.as_tensor(Rbox, **f64)
    ZiZj = q[:, None] * q[None, :]
    eye = torch.eye(len(q), dtype=torch.bool, device=device)
    diff = pos[:, None, :] - pos[None, :, :]                   # [na, na, 3]
    sum_real = -2 * eta / math.sqrt(math.pi) * torch.sum(q ** 2)
    for i0 in range(0, len(R), chunk):
        Rc = R[i0:i0 + chunk]
        dcart = (diff[None] - Rc[:, None, None, :]) @ L.T      # [nr, na, na, 3]
        self_pair = torch.all(Rc == 0, dim=1)[:, None, None] & eye[None]
        dsq = torch.sum(dcart * dcart, -1)
        d = torch.sqrt(torch.where(self_pair, torch.ones_like(dsq), dsq))
        sum_real = sum_real + torch.sum(torch.where(
            self_pair, torch.zeros_like(d), ZiZj * torch.special.erfc(eta * d) / d))
    return float((sum_recip + sum_real) / 2)
