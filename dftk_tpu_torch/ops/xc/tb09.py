"""The Tran-Blaha 2009 modified Becke-Johnson exchange potential (TB09, mBJ).

Port of `dftk_tpu/ops/xc/tb09.py`.  A potential-only meta-GGA (PRL 102,
226401 (2009)): there is no exchange energy, only the multiplicative

    V_x,s(r) = c V_x,s^BR(r) + (3c - 2) / pi sqrt(5/12) sqrt(2 tau_s / rho_s)

with c = ALPHA + BETA sqrt((1/V) int |grad rho| / rho) and the
Becke-Roussel potential (PRA 39, 3761 (1989))

    V^BR = -(1/b) (1 - e^{-x} - x e^{-x} / 2),   b^3 = x^3 e^{-x} / (8 pi rho_s),

where x solves x e^{-2x/3} / (x - 2) = y, y = (2/3) pi^{2/3} rho_s^{5/3} / Q,
Q = (lapl rho_s - 2 gamma D_s) / 6, D_s = 2 tau_s - |grad rho_s|^2 / (4 rho_s),
gamma = 0.8.  The solve is a branch-aware bisection of a fixed 80 steps on
the density's device, with no host synchronisation; gradients and the
Laplacian are spectral.

tau is 1/2 sum_n f_n |grad psi_n|^2 per spin channel
(`ops/density.py::compute_kinetic_energy_density`).  With no energy, TB09
total energies are not variational, and forces and stresses are undefined.
"""
import math

import torch

from ..density import density_gradients

ALPHA = -0.012
BETA = 1.023          # bohr^(1/2)
GAMMA_BR = 0.8

_RHO_FLOOR = 1e-12


def _g(x):
    return x * torch.exp(-2.0 * x / 3.0) / (x - 2.0)


def br89_x_solve(y, n_iter=80):
    """Solve x e^{-2x/3} / (x - 2) = y elementwise by bisection on the
    branch of y's sign: x in (0, 2) for y < 0, in (2, hi) for y > 0 (g is
    strictly decreasing on each)."""
    neg = y < 0
    hi_pos = 2.0 + 1.5 * torch.clamp(-torch.log(torch.abs(y) + 1e-300), min=0.0) + 60.0
    lo = torch.where(neg, torch.zeros_like(y), torch.full_like(y, 2.0))
    hi = torch.where(neg, torch.full_like(y, 2.0), hi_pos)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        go_right = _g(mid) > y
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    return 0.5 * (lo + hi)


def _br_potential_channel(rho_s, grad2_s, lapl_s, tau_s):
    """The Becke-Roussel V_x of one spin channel."""
    rho_s = torch.clamp(rho_s, min=_RHO_FLOOR)
    # the von Weizsaecker bound tau >= |grad rho|^2 / (8 rho) keeps D >= 0
    tau_w = grad2_s / (8.0 * rho_s)
    D = 2.0 * torch.maximum(tau_s, tau_w) - grad2_s / (4.0 * rho_s)
    Q = (lapl_s - 2.0 * GAMMA_BR * D) / 6.0
    # y stays finite where Q crosses zero (x -> inf there, V -> -(1/b) -> 0)
    Qsafe = torch.where(torch.abs(Q) < 1e-14,
                        torch.where(Q >= 0, torch.full_like(Q, 1e-14), torch.full_like(Q, -1e-14)),
                        Q)
    y = (2.0 / 3.0) * math.pi ** (2.0 / 3.0) * rho_s ** (5.0 / 3.0) / Qsafe
    x = br89_x_solve(y)
    b = torch.clamp((x ** 3 * torch.exp(-x) / (8.0 * math.pi * rho_s)) ** (1.0 / 3.0), min=1e-10)
    return -(1.0 / b) * (1.0 - torch.exp(-x) - 0.5 * x * torch.exp(-x))


def tb09_channel(rho_s, grad2_s, lapl_s, tau_s, c):
    """The mBJ potential of one spin channel from its ingredients."""
    v_br = _br_potential_channel(rho_s, grad2_s, lapl_s, tau_s)
    bj = torch.sqrt(torch.clamp(2.0 * tau_s / torch.clamp(rho_s, min=_RHO_FLOOR), min=0.0))
    return c * v_br + (3.0 * c - 2.0) / math.pi * math.sqrt(5.0 / 12.0) * bj


def tb09_potential(rho, G_cart, tau, c=None):
    """The mBJ potential [nspin, n1, n2, n3] from the spin densities rho and
    tau [nspin, n1, n2, n3] (unpolarised: the totals, halved per channel
    inside).  G_cart [n1, n2, n3, 3] includes the 2 pi.  c overrides the
    cell-averaged parameter (c = 1 is Becke-Johnson 2006)."""
    nspin = rho.shape[0]
    rho_tot = torch.sum(rho, dim=0)
    grads = density_gradients(rho, G_cart)                           # [nspin, grid, 3]
    Gsq = torch.sum(G_cart * G_cart, dim=-1)
    lapl = torch.fft.ifftn(-Gsq * torch.fft.fftn(rho, dim=(-3, -2, -1)), dim=(-3, -2, -1)).real

    if c is None:
        gtot = grads[0] if nspin == 1 else torch.sum(grads, dim=0)
        gnorm = torch.sqrt(torch.sum(gtot ** 2, dim=-1))
        c = ALPHA + BETA * torch.sqrt(torch.mean(gnorm / torch.clamp(rho_tot, min=_RHO_FLOOR)))

    half = 1.0 if nspin == 2 else 0.5         # a channel is rho / 2 unpolarised
    return torch.stack([tb09_channel(half * rho[s], half * half * torch.sum(grads[s] ** 2, dim=-1),
                                     half * lapl[s], half * tau[s], c)
                        for s in range(nspin)])
