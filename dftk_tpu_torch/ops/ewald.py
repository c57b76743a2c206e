"""Ewald summation: point-charge electrostatics in a neutralising background.

Port of `dftk_tpu/ops/ewald.py` (reference `src/terms/ewald.jl:64-168`):
the real- and reciprocal-space lattice sums as dense tensor ops over index
boxes bounded on the host.  The energy is a float64 tensor differentiable
in the positions and the lattice, so forces and stresses come from
`torch.autograd`; the numpy twins serve callers that want host f64 values.

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


def _host(x):
    """A tensor's values (detached) or an array-like as a float64 array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=float)


def energy_ewald(lattice, charges, positions, eta=None, device="cuda",
                 chunk=64, Gbox=None, Rbox=None):
    """Ewald energy, a 0-d float64 tensor on `device`.

    lattice [3,3] (columns), charges [na], positions [na,3] fractional;
    lattice and positions may be tensors with requires_grad, and the energy
    is differentiable in both (the self pair and G = 0 are masked before
    any division or sqrt, so the gradients are finite).  Gbox/Rbox: integer
    index boxes, bounded on the host from the lattice and positions' values
    if omitted."""
    if eta is None:
        eta = default_eta(_host(lattice))
    if Gbox is None or Rbox is None:
        Gbox, Rbox = ewald_sum_bounds(_host(lattice), _host(positions), eta)
    f64 = dict(dtype=torch.float64, device=device)
    L = torch.as_tensor(lattice, **f64)
    q = torch.as_tensor(np.asarray(charges, dtype=float), **f64)
    pos = torch.as_tensor(positions, **f64)
    recip = 2 * math.pi * torch.linalg.inv(L.T)
    volume = torch.abs(torch.linalg.det(L))

    # reciprocal sum
    G = torch.as_tensor(Gbox, **f64)
    nonzero = torch.as_tensor(np.any(Gbox != 0, axis=1), device=device)
    Gcart = G @ recip.T
    Gsq = torch.sum(Gcart * Gcart, 1)
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
    return (sum_recip + sum_real) / 2


def energy_forces_ewald(lattice, charges, positions, eta=None, device="cuda"):
    """Energy and forces (reduced coordinates, -dE/dpositions), as float64
    tensors on `device`."""
    with torch.enable_grad():
        pos = torch.tensor(_host(positions), dtype=torch.float64, device=device,
                           requires_grad=True)
        E = energy_ewald(lattice, charges, pos, eta=eta, device=device)
        (grad,) = torch.autograd.grad(E, pos)
    return E.detach(), -grad


def ewald_position_gradient_np(lattice, charges, positions, eta=None,
                               Gbox=None, Rbox=None):
    """dE/dpositions (reduced coords) in numpy f64: the analytic twin of
    the autograd gradient of `energy_ewald`, chunked over the real-space
    images."""
    from scipy.special import erfc as np_erfc
    lattice = np.asarray(lattice, dtype=float)
    charges = np.asarray(charges, dtype=float)
    positions = np.asarray(positions, dtype=float)
    na = len(charges)
    if eta is None:
        eta = default_eta(lattice)
    if Gbox is None or Rbox is None:
        Gbox, Rbox = ewald_sum_bounds(lattice, positions, eta)
    recip = 2 * math.pi * np.linalg.inv(lattice.T)
    volume = abs(np.linalg.det(lattice))

    # reciprocal part: d|S|^2/dr_i = 4 pi q_i G (sin_sf cos(phi_i) - cos_sf sin(phi_i))
    G = np.asarray(Gbox, dtype=float)
    nonzero = np.any(Gbox != 0, axis=1)
    Gcart = G @ recip.T
    Gsq = np.sum(Gcart * Gcart, axis=1)
    w = np.where(nonzero, np.exp(-Gsq / (4 * eta ** 2))
                 / np.where(nonzero, Gsq, 1.0), 0.0)        # [ng]
    phase = 2 * math.pi * (G @ positions.T)                 # [ng, na]
    cos_sf = np.sum(charges * np.cos(phase), axis=1)
    sin_sf = np.sum(charges * np.sin(phase), axis=1)
    coef = w[:, None] * (sin_sf[:, None] * np.cos(phase)
                         - cos_sf[:, None] * np.sin(phase))  # [ng, na]
    grad = (4 * math.pi / volume) * 4 * math.pi \
        * np.einsum("ga,gd->ad", coef * charges[None, :], G) / 2

    # real-space part
    R = np.asarray(Rbox, dtype=float)
    ZiZj = charges[:, None] * charges[None, :]
    eye = np.eye(na, dtype=bool)
    for i0 in range(0, len(R), 64):
        Rc = R[i0:i0 + 64]
        disp = (positions[:, None, :] - positions[None, :, :])[None] \
            - Rc[:, None, None, :]                          # [nr, na, na, 3]
        dcart = np.einsum("ab,rijb->rija", lattice, disp)
        dsq = np.sum(dcart * dcart, axis=-1)
        self_pair = np.all(Rc == 0, axis=1)[:, None, None] & eye[None]
        d = np.sqrt(np.where(self_pair, 1.0, dsq))
        fp = -(2 * eta / math.sqrt(math.pi) * np.exp(-(eta * d) ** 2) / d
               + np_erfc(eta * d) / d ** 2)
        fp = np.where(self_pair, 0.0, fp)
        # dd/dr_i (reduced) = L^T dcart / d
        grad = grad + np.einsum("rij,rija,ab->ib", ZiZj[None] * fp / d, dcart, lattice)
    return grad


def energy_ewald_np(lattice, charges, positions, eta=None, Gbox=None, Rbox=None):
    """Ewald energy in numpy f64 (the twin of `energy_ewald`)."""
    from scipy.special import erfc as np_erfc
    lattice = np.asarray(lattice, dtype=float)
    charges = np.asarray(charges, dtype=float)
    positions = np.asarray(positions, dtype=float)
    if eta is None:
        eta = default_eta(lattice)
    if Gbox is None or Rbox is None:
        Gbox, Rbox = ewald_sum_bounds(lattice, positions, eta)
    recip = 2 * math.pi * np.linalg.inv(lattice.T)
    volume = abs(np.linalg.det(lattice))

    G = np.asarray(Gbox, dtype=float)
    nonzero = np.any(Gbox != 0, axis=1)
    Gcart = G @ recip.T
    Gsq = np.sum(Gcart * Gcart, axis=1)
    phase = 2 * math.pi * (G @ positions.T)
    sf2 = np.sum(charges * np.cos(phase), axis=1) ** 2 \
        + np.sum(charges * np.sin(phase), axis=1) ** 2
    rec = np.where(nonzero, sf2 * np.exp(-Gsq / (4 * eta ** 2))
                   / np.where(nonzero, Gsq, 1.0), 0.0)
    sum_recip = (np.sum(rec) - np.sum(charges) ** 2 / (4 * eta ** 2)) \
        * 4 * math.pi / volume

    R = np.asarray(Rbox, dtype=float)
    ZiZj = charges[:, None] * charges[None, :]
    eye = np.eye(len(charges), dtype=bool)
    sum_real = -2 * eta / math.sqrt(math.pi) * np.sum(charges ** 2)
    for i0 in range(0, len(R), 64):
        Rc = R[i0:i0 + 64]
        disp = (positions[:, None, :] - positions[None, :, :])[None] \
            - Rc[:, None, None, :]
        dcart = np.einsum("ab,rijb->rija", lattice, disp)
        dsq = np.sum(dcart * dcart, axis=-1)
        self_pair = np.all(Rc == 0, axis=1)[:, None, None] & eye[None]
        d = np.sqrt(np.where(self_pair, 1.0, dsq))
        sum_real += np.sum(np.where(self_pair, 0.0, ZiZj * np_erfc(eta * d) / d))
    return (sum_recip + sum_real) / 2
