"""Meta-GGA functionals as differentiable torch expressions: SCAN (Sun,
Ruzsinszky, Perdew, PRL 115, 036402 (2015)), r2SCAN (Furness, Kaplan,
Ning, Perdew, Sun, JPCL 11, 8208 (2020)) and TPSS (Tao, Perdew,
Staroverov, Scuseria, PRL 91, 146401 (2003)).

Port of `dftk_tpu/ops/xc/mgga.py`.  The tau potential (the coefficient of
the DivAgrad operator) and the density potential both come from
`torch.autograd` through the energy.  Signature: energy(rho, sigma, tau) ->
energy density per volume, rho and tau [nspin, ...], sigma [1 or 3, ...]
as for the GGA functionals.

The floors are the JAX package's, written as `torch.maximum` with a tensor
bound, whose gradient at a tie is split in half as `jnp.maximum`'s is: the
singular points (tau = 0, alpha = 1, rho and sigma at their floors) keep
finite gradients equal to the JAX package's.  r2SCAN's d eps_LSDA / d rs,
a forward-mode jvp in the JAX package, is the closed-form derivative of
PW92 here (`_pw_eps_drs`).
"""
import math

import torch

from .functionals import (_CX, _PBE_BETA, _PW_FERRO, _PW_PARA, _PW_STIFF, _FZ_DD0,
                          _den_floor, _f_zeta, _gga_c_pbe, _pw_eps, _rs_from_rho,
                          _safe_rho)


def _max(x, c):
    """jnp.maximum(x, c): at a tie the gradient is split in half."""
    return torch.maximum(x, torch.as_tensor(c, dtype=x.dtype, device=x.device))


def _min(x, c):
    return torch.minimum(x, torch.as_tensor(c, dtype=x.dtype, device=x.device))


def _clip(x, lo, hi):
    return _min(_max(x, lo), hi)


# ---- SCAN exchange constants ----------------------------------------------
_SX_K1 = 0.065
_SX_MU = 10.0 / 81.0
_SX_B2 = math.sqrt(5913.0 / 405000.0)
_SX_B1 = (511.0 / 13500.0) / (2.0 * _SX_B2)
_SX_B3 = 0.5
_SX_B4 = _SX_MU ** 2 / _SX_K1 - 1606.0 / 18225.0 - _SX_B1 ** 2
_SX_HX0 = 1.174
_SX_A1 = 4.9479
_SX_C1 = 0.667
_SX_C2 = 0.8
_SX_D = 1.24

# ---- SCAN correlation constants -------------------------------------------
_SC_B1C = 0.0285764
_SC_B2C = 0.0889
_SC_B3C = 0.125541
_SC_GAMMA = 0.031090690869654895034
_SC_CHI_INF = 0.12802585262625815
_SC_C1 = 0.64
_SC_C2 = 1.5
_SC_D = 0.7


def _interp_alpha(alpha, c1, c2, d):
    """SCAN's alpha interpolation f(alpha): exp(-c1 a / (1 - a)) below 1,
    -d exp(c2 / (1 - a)) above, 0 at 1; each branch's argument is kept
    finite where the other branch is taken."""
    a = _clip(alpha, 0.0, 1e10)
    da_lo = torch.where(a < 1.0, 1.0 - a, torch.ones_like(a))
    lo = torch.exp(-c1 * a / _max(da_lo, 1e-14))
    da_hi = torch.where(a > 1.0, 1.0 - a, -torch.ones_like(a))
    hi = -d * torch.exp(c2 / torch.where(a > 1.0, _min(da_hi, -1e-14), -torch.ones_like(a)))
    return torch.where(a < 1.0, lo, torch.where(a > 1.0, hi, torch.zeros_like(a)))


def _scan_fx_unpol(rho, sigma, tau):
    """SCAN exchange enhancement times LDA exchange, for one spin channel."""
    r = _safe_rho(rho)
    sig = _max(sigma, 1e-30)
    t = _max(tau, 0.0)

    kf = (3 * math.pi ** 2 * r) ** (1.0 / 3.0)
    s2 = sig / _den_floor((2 * kf * r) ** 2)
    tau_unif = 0.3 * (3 * math.pi ** 2) ** (2.0 / 3.0) * r ** (5.0 / 3.0)
    tau_w = sig / (8 * r)
    alpha = _max(t - tau_w, 0.0) / _max(tau_unif, 1e-30)

    oma = 1.0 - alpha
    x = (_SX_MU * s2 * (1 + (_SX_B4 * s2 / _SX_MU)
                        * torch.exp(-abs(_SX_B4) * s2 / _SX_MU))
         + (_SX_B1 * s2 + _SX_B2 * oma * torch.exp(-_SX_B3 * oma ** 2)) ** 2)
    h1x = 1 + _SX_K1 - _SX_K1 / (1 + x / _SX_K1)
    gx = 1 - torch.exp(-_SX_A1 / _max(s2, 1e-30) ** 0.25)
    fx = _interp_alpha(alpha, _SX_C1, _SX_C2, _SX_D)
    Fx = (h1x + fx * (_SX_HX0 - h1x)) * gx
    return _CX * r ** (4.0 / 3.0) * Fx


def _phi_dx_ds_gc(zeta):
    """phi, d_x, d_s of zeta and G_c (the SCAN spin-scaling functions)."""
    phi = ((1 + zeta) ** (2.0 / 3.0) + (1 - zeta) ** (2.0 / 3.0)) / 2
    dx_z = ((1 + zeta) ** (4.0 / 3.0) + (1 - zeta) ** (4.0 / 3.0)) / 2
    ds_z = ((1 + zeta) ** (5.0 / 3.0) + (1 - zeta) ** (5.0 / 3.0)) / 2
    Gc = (1 - 2.3631 * (dx_z - 1)) * (1 - zeta ** 12)
    return phi, dx_z, ds_z, Gc


def _scan_ec(rs, zeta, s2, alpha):
    """SCAN correlation energy per particle eps_c(rs, zeta, s2, alpha)."""
    phi, _, _, Gc = _phi_dx_ds_gc(zeta)

    # eps_c^0, the alpha -> 0 limit
    eclda0 = -_SC_B1C / (1 + _SC_B2C * torch.sqrt(rs) + _SC_B3C * rs)
    w0 = torch.expm1(-eclda0 / _SC_B1C)
    ginf = (1 + 4 * _SC_CHI_INF * s2) ** (-0.25)
    H0 = _SC_B1C * torch.log1p(w0 * (1 - ginf))
    ec0 = (eclda0 + H0) * Gc

    # eps_c^1 (alpha ~ 1): PBE-like with an rs-dependent beta
    eps_lsda = _pw_eps(rs, zeta)
    beta = 0.066725 * (1 + 0.1 * rs) / (1 + 0.1778 * rs)
    # t^2 = (3 pi^2 / 16)^{2/3} s^2 / (phi^2 rs)
    t2 = (3 * math.pi ** 2 / 16.0) ** (2.0 / 3.0) * s2 / _max(phi ** 2 * rs, 1e-30)
    w1 = torch.expm1(-eps_lsda / (_SC_GAMMA * phi ** 3))
    A = beta / (_SC_GAMMA * _max(w1, 1e-12))
    g_at2 = (1 + 4 * A * t2) ** (-0.25)
    H1 = _SC_GAMMA * phi ** 3 * torch.log1p(w1 * (1 - g_at2))
    ec1 = eps_lsda + H1

    fc = _interp_alpha(alpha, _SC_C1, _SC_C2, _SC_D)
    return ec1 + fc * (ec0 - ec1)


def _totals(rho, sigma, tau):
    """rho, sigma, tau of both spins together and zeta (0 unpolarised)."""
    if rho.shape[0] == 1:
        rho_tot = _safe_rho(rho[0])
        return (rho_tot, _max(sigma[0], 1e-30), _max(tau[0], 0.0),
                torch.zeros_like(rho_tot))
    rho_tot = _safe_rho(rho[0] + rho[1])
    return (rho_tot, _max(sigma[0] + 2 * sigma[1] + sigma[2], 1e-30),
            _max(tau[0] + tau[1], 0.0),
            _clip((rho[0] - rho[1]) / rho_tot, -1 + 1e-12, 1 - 1e-12))


def _spin_scaled(fx_unpol, rho, sigma, tau):
    """Exchange by exact spin scaling: Ex[ra, rb] = (Ex[2 ra] + Ex[2 rb]) / 2."""
    if rho.shape[0] == 1:
        return fx_unpol(rho[0], sigma[0], tau[0])
    return (fx_unpol(2 * rho[0], 4 * sigma[0], 2 * tau[0])
            + fx_unpol(2 * rho[1], 4 * sigma[2], 2 * tau[1])) / 2


def scan_energy(rho, sigma, tau):
    """SCAN exchange-correlation energy density per volume."""
    ex = _spin_scaled(_scan_fx_unpol, rho, sigma, tau)
    rho_tot, sig_tot, tau_tot, zeta = _totals(rho, sigma, tau)
    rs = _rs_from_rho(rho_tot)
    kf = (3 * math.pi ** 2 * rho_tot) ** (1.0 / 3.0)
    s2 = sig_tot / _den_floor((2 * kf * rho_tot) ** 2)
    tau_unif = 0.3 * (3 * math.pi ** 2) ** (2.0 / 3.0) * rho_tot ** (5.0 / 3.0)
    ds_z = _phi_dx_ds_gc(zeta)[2]
    tau_w = sig_tot / (8 * rho_tot)
    alpha = _max(tau_tot - tau_w, 0.0) / _max(ds_z * tau_unif, 1e-30)
    return ex + rho_tot * _scan_ec(rs, zeta, s2, alpha)


# ===========================================================================
# r2SCAN: alpha-bar = (tau - tauW) / (tauU + eta tauW), rSCAN's polynomial
# interpolation for 0 <= a <= 2.5, and damped terms restoring the
# second-order gradient expansion that the interpolation spoils
# ===========================================================================

_R2_ETA = 0.001
_R2_DP2 = 0.361
_R2_CETA = 20.0 / 27.0 + 5.0 * _R2_ETA / 3.0   # slope of (1 - alpha-bar) in p
# rSCAN interpolation polynomials f(a) = sum_i c_i a^i (f(1) = 0)
_R2_FX_POLY = (1.0, -0.667, -0.4445555, -0.663086601049, 1.451297044490,
               -0.887998041597, 0.234528941479, -0.023185843322)
_R2_FC_POLY = (1.0, -0.64, -0.4352, -1.535685604549, 3.061560252175,
               -1.915710236206, 0.516884468372, -0.051848879792)
_R2_DFX1 = sum(i * c for i, c in enumerate(_R2_FX_POLY))   # f_x'(1)
_R2_DFC1 = sum(i * c for i, c in enumerate(_R2_FC_POLY))   # f_c'(1)
_R2_C2X = (_SX_HX0 - 1.0) * _R2_DFX1


def _poly_interp(alpha, coeffs, c2, d):
    """r2SCAN interpolation: the polynomial below a = 2.5, the damped
    exponential above."""
    a = _clip(alpha, 0.0, 1e10)
    lo = sum(c * a ** i for i, c in enumerate(coeffs))
    da = torch.where(a > 2.5, 1.0 - a, -torch.ones_like(a))
    hi = -d * torch.exp(c2 / torch.where(a > 2.5, _min(da, -1e-14), -torch.ones_like(a)))
    return torch.where(a < 2.5, lo, hi)


def _r2scan_fx_unpol(rho, sigma, tau):
    """r2SCAN exchange enhancement times LDA exchange for one spin channel."""
    r = _safe_rho(rho)
    sig = _max(sigma, 1e-30)
    t = _max(tau, 0.0)

    kf = (3 * math.pi ** 2 * r) ** (1.0 / 3.0)
    p = sig / _den_floor((2 * kf * r) ** 2)
    tau_unif = 0.3 * (3 * math.pi ** 2) ** (2.0 / 3.0) * r ** (5.0 / 3.0)
    tau_w = sig / (8 * r)
    abar = _max(t - tau_w, 0.0) / _max(tau_unif + _R2_ETA * tau_w, 1e-30)

    damp = torch.exp(-p ** 2 / _R2_DP2 ** 4)
    x = (_R2_CETA * _R2_C2X * damp + _SX_MU) * p
    h1x = 1 + _SX_K1 - _SX_K1 / (1 + x / _SX_K1)
    gx = 1 - torch.exp(-_SX_A1 / _max(p, 1e-30) ** 0.25)
    fx = _poly_interp(abar, _R2_FX_POLY, _SX_C2, _SX_D)
    Fx = (h1x + fx * (_SX_HX0 - h1x)) * gx
    return _CX * r ** (4.0 / 3.0) * Fx


def _pw_G_drs(rs, A, a1, b1, b2, b3, b4):
    """d/drs of `functionals._pw_G` (p = 1)."""
    srs = torch.sqrt(rs)
    den = 2 * A * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs ** 2)
    dden = 2 * A * (b1 / (2 * srs) + b2 + 1.5 * b3 * srs + 2 * b4 * rs)
    return (-2 * A * a1 * torch.log1p(1.0 / den)
            + 2 * A * (1 + a1 * rs) * dden / (den * (den + 1)))


def _pw_eps_drs(rs, zeta):
    """d/drs of `functionals._pw_eps(rs, zeta)`."""
    dp, df = _pw_G_drs(rs, *_PW_PARA), _pw_G_drs(rs, *_PW_FERRO)
    dalpha = -_pw_G_drs(rs, *_PW_STIFF)
    fz = _f_zeta(zeta)
    z4 = zeta ** 4
    return dp + dalpha * fz / _FZ_DD0 * (1 - z4) + (df - dp) * fz * z4


def _r2scan_ec(rs, zeta, p, abar):
    """r2SCAN correlation energy per particle."""
    phi, _, ds_z, Gc = _phi_dx_ds_gc(zeta)

    # eps_c^0 (alpha -> 0), as SCAN's, with its rs-derivative
    den0 = 1 + _SC_B2C * torch.sqrt(rs) + _SC_B3C * rs
    eclda0 = -_SC_B1C / den0
    declda0 = _SC_B1C * (0.5 * _SC_B2C / torch.sqrt(rs) + _SC_B3C) / den0 ** 2
    w0 = torch.expm1(-eclda0 / _SC_B1C)
    ginf = (1 + 4 * _SC_CHI_INF * p) ** (-0.25)
    H0 = _SC_B1C * torch.log1p(w0 * (1 - ginf))
    ec0 = (eclda0 + H0) * Gc

    # eps_c^1 with the GE2-restoring Delta-y correction
    eps_lsda, deps_lsda = _pw_eps(rs, zeta), _pw_eps_drs(rs, zeta)
    beta = 0.066725 * (1 + 0.1 * rs) / (1 + 0.1778 * rs)
    t2 = (3 * math.pi ** 2 / 16.0) ** (2.0 / 3.0) * p / _max(phi ** 2 * rs, 1e-30)
    w1 = torch.expm1(-eps_lsda / (_SC_GAMMA * phi ** 3))
    w1s = torch.where(torch.abs(w1) > 1e-12, w1, torch.full_like(w1, 1e-12))
    y = beta / (_SC_GAMMA * w1s) * t2

    # Delta-y (paper eq. 25) cancels the O(p) term of fc(a)(ec0 - ec1) on
    # the slowly-varying manifold, damped like the exchange correction
    damp = torch.exp(-p ** 2 / _R2_DP2 ** 4)
    dy = _R2_DFC1 / (27 * _SC_GAMMA * ds_z * phi ** 3 * w1s) * (
        20 * rs * (Gc * declda0 - deps_lsda) - 45 * _R2_ETA * (ec0 - eps_lsda)) * p * damp

    g_y = _max(1 + 4 * (y - dy), 1e-6) ** (-0.25)
    H1 = _SC_GAMMA * phi ** 3 * torch.log1p(w1 * (1 - g_y))
    ec1 = eps_lsda + H1

    fc = _poly_interp(abar, _R2_FC_POLY, _SC_C2, _SC_D)
    return ec1 + fc * (ec0 - ec1)


def r2scan_energy(rho, sigma, tau):
    """r2SCAN exchange-correlation energy density per volume."""
    ex = _spin_scaled(_r2scan_fx_unpol, rho, sigma, tau)
    rho_tot, sig_tot, tau_tot, zeta = _totals(rho, sigma, tau)
    rs = _rs_from_rho(rho_tot)
    kf = (3 * math.pi ** 2 * rho_tot) ** (1.0 / 3.0)
    p = sig_tot / _den_floor((2 * kf * rho_tot) ** 2)
    tau_unif = 0.3 * (3 * math.pi ** 2) ** (2.0 / 3.0) * rho_tot ** (5.0 / 3.0)
    ds_z = _phi_dx_ds_gc(zeta)[2]
    tau_w = sig_tot / (8 * rho_tot)
    abar = _max(tau_tot - tau_w, 0.0) / _max(ds_z * tau_unif + _R2_ETA * tau_w, 1e-30)
    return ex + rho_tot * _r2scan_ec(rs, zeta, p, abar)


# ===========================================================================
# TPSS (the reference dispatches mgga_x_tpss / mgga_c_tpss to libxc)
# ===========================================================================

_TP_KAPPA = 0.804
_TP_B = 0.40
_TP_C = 1.59096
_TP_E = 1.537
_TP_MU = 0.21951
_TP_D = 2.8


def _tpss_fx_unpol(rho, sigma, tau):
    """TPSS exchange enhancement times LDA exchange for one spin channel."""
    r = _safe_rho(rho)
    sig = _max(sigma, 1e-30)
    t = _max(tau, 1e-30)

    kf = (3 * math.pi ** 2 * r) ** (1.0 / 3.0)
    p = sig / _den_floor((2 * kf * r) ** 2)
    tau_w = sig / (8 * r)
    tau_unif = 0.3 * (3 * math.pi ** 2) ** (2.0 / 3.0) * r ** (5.0 / 3.0)
    z = _clip(tau_w / torch.maximum(t, tau_w), 0.0, 1.0)        # tau >= tauW
    alpha = _max(t - tau_w, 0.0) / _max(tau_unif, 1e-30)

    # qtilde_b (paper eq. 7)
    qb = 0.45 * (alpha - 1.0) / torch.sqrt(1.0 + _TP_B * alpha * (alpha - 1.0)) + 2.0 * p / 3.0

    z2 = z * z
    mzs = (0.6 * z) ** 2                          # (3 z / 5)^2
    sqe = math.sqrt(_TP_E)
    x = ((10.0 / 81.0 + _TP_C * z2 / (1.0 + z2) ** 2) * p
         + 146.0 / 2025.0 * qb * qb
         - 73.0 / 405.0 * qb * torch.sqrt(0.5 * mzs ** 2 + 0.5 * p * p)
         + (10.0 / 81.0) ** 2 / _TP_KAPPA * p * p
         + 2.0 * sqe * (10.0 / 81.0) * mzs
         + _TP_E * _TP_MU * p ** 3) / (1.0 + sqe * p) ** 2
    Fx = 1.0 + _TP_KAPPA - _TP_KAPPA / (1.0 + x / _TP_KAPPA)
    return _CX * r ** (4.0 / 3.0) * Fx


def tpss_x_energy(rho, sigma, tau):
    """TPSS exchange energy density per volume (spin-scaled)."""
    return _spin_scaled(_tpss_fx_unpol, rho, sigma, tau)


def _pbe_eps_c(rho2, sigma3):
    """PBE correlation energy per particle of a [2, ...] spin pair."""
    return _gga_c_pbe(rho2, sigma3, _PBE_BETA) / _safe_rho(torch.sum(rho2, dim=0))


def tpss_c_energy(rho, sigma, tau):
    """TPSS correlation energy density per volume (revPKZB based)."""
    if rho.shape[0] == 1:
        rho_tot = _safe_rho(rho[0])
        sig_tot = _max(sigma[0], 1e-30)
        tau_tot = _max(tau[0], 1e-30)
        zeta = torch.zeros_like(rho_tot)
        xi2 = torch.zeros_like(rho_tot)
        ra = rb = rho_tot / 2
        siga = sigb = sigab = sig_tot / 4
    else:
        ra, rb = _safe_rho(rho[0]), _safe_rho(rho[1])
        rho_tot = ra + rb
        sig_tot = _max(sigma[0] + 2 * sigma[1] + sigma[2], 1e-30)
        tau_tot = _max(tau[0] + tau[1], 1e-30)
        zeta = _clip((rho[0] - rho[1]) / rho_tot, -1 + 1e-12, 1 - 1e-12)
        siga, sigb, sigab = sigma[0], sigma[2], sigma[1]
        # |grad zeta|^2 = 4 (rb^2 s_aa - 2 ra rb s_ab + ra^2 s_bb) / rho^4
        gz2 = 4.0 * _max(rb ** 2 * sigma[0] - 2 * ra * rb * sigma[1] + ra ** 2 * sigma[2],
                         0.0) / rho_tot ** 4
        kf2 = (3 * math.pi ** 2 * rho_tot) ** (2.0 / 3.0)
        xi2 = gz2 / _den_floor(4.0 * kf2)

    tau_w = sig_tot / (8 * rho_tot)
    z = _clip(tau_w / torch.maximum(tau_tot, tau_w), 0.0, 1.0)

    # C(zeta, xi) (paper eq. 13)
    z2_ = zeta * zeta
    C0 = 0.53 + 0.87 * z2_ + 0.50 * z2_ ** 2 + 2.26 * z2_ ** 3
    opz = _max(1 + zeta, 1e-12)
    omz = _max(1 - zeta, 1e-12)
    Cz = C0 / (1.0 + xi2 * (opz ** (-4.0 / 3.0) + omz ** (-4.0 / 3.0)) / 2.0) ** 4

    eps_pbe = _pbe_eps_c(torch.stack([ra, rb]), torch.stack([siga, sigab, sigb]))
    # per-spin fully polarised PBE pieces, floored by the full eps
    zero = torch.zeros_like(ra)
    eps_a = _pbe_eps_c(torch.stack([ra, zero]), torch.stack([_max(siga, 1e-30), zero, zero]))
    eps_b = _pbe_eps_c(torch.stack([rb, zero]), torch.stack([_max(sigb, 1e-30), zero, zero]))
    eps_a = torch.maximum(eps_a, eps_pbe)
    eps_b = torch.maximum(eps_b, eps_pbe)

    zz = z * z
    eps_rev = (eps_pbe * (1.0 + Cz * zz)
               - (1.0 + Cz) * zz * (ra / rho_tot * eps_a + rb / rho_tot * eps_b))
    return rho_tot * eps_rev * (1.0 + _TP_D * eps_rev * zz * z)


def tpss_energy(rho, sigma, tau):
    """Combined TPSS exchange-correlation energy density per volume."""
    return tpss_x_energy(rho, sigma, tau) + tpss_c_energy(rho, sigma, tau)
