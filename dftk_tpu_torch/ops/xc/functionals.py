"""Exchange-correlation functionals as differentiable torch expressions.

Port of `dftk_tpu/ops/xc/functionals.py` (names follow libxc): lda_x (Slater exchange), lda_c_vwn (VWN5), lda_c_pw (PW92),
lda_xc_teter93 (Teter's Pade fit of LDA exchange and correlation),
gga_x_pbe, gga_c_pbe, gga_x_pbe_sol and gga_c_pbe_sol, the HJS omega-PBE
short-range exchange gga_x_wpbeh of the HSE06 hybrid (`make_gga_x_wpbeh`),
the meta-GGAs
mgga_x_scan, mgga_x_r2scan, mgga_x_tpss and mgga_c_tpss (`ops/xc/mgga.py`),
the potential-only mgga_x_tb09 (`ops/xc/tb09.py`), and the sets LDA, PBE,
PBEsol, SCAN, r2SCAN, TPSS and TB09.  Potentials come from
`torch.autograd` through the energy (`ops/hamiltonian.py::total_potential`),
the GGA divergence term included, since the density gradient is taken
spectrally inside the graph; for a meta-GGA the gradient in tau is the
DivAgrad coefficient Vtau.

rho has shape [nspin, ...] with nspin in {1, 2}; sigma, the contracted
gradients, [1, ...] for nspin 1 and [3, ...] (aa, ab, bb) for nspin 2; tau
as rho; each functional returns an energy density per unit volume.

The floors keep autograd finite: densities under _RHO_EPS are clamped (no
gradient flows below it), zeta is clipped inside (-1, 1), and the squared
denominators of s^2 and t^2 have a floor whose inverse square stays finite
in the working dtype (`_den_floor`), so no branch sees sqrt(0), 0^(-1/3)
or 0/0.
"""
import dataclasses
import math
from typing import Callable

import torch

_RHO_EPS = 1e-14        # libxc-style density threshold


def _safe_rho(rho):
    return torch.clamp(rho, min=_RHO_EPS)


def _den_floor(x):
    """Floor of squared denominators such as (2 kF rho)^2: 1/floor^2 enters
    the gradient of sigma/denominator, so it must stay finite in the
    working dtype (1e-40 in float64; its square underflows in float32)."""
    return torch.clamp(x, min=1e-15 if torch.finfo(x.dtype).bits <= 32 else 1e-40)


def _rs_from_rho(rho):
    return (3 / (4 * math.pi * _safe_rho(rho))) ** (1 / 3)


_CX = -3 / 4 * (3 / math.pi) ** (1 / 3)


def lda_x_energy(rho, sigma=None):
    """sum_s 0.5 * e_x[2 rho_s] (exact spin scaling)."""
    if rho.shape[0] == 1:
        return _CX * _safe_rho(rho[0]) ** (4 / 3)
    ra, rb = _safe_rho(rho[0]), _safe_rho(rho[1])
    return _CX * ((2 * ra) ** (4 / 3) + (2 * rb) ** (4 / 3)) / 2


def _vwn_eps(rs, A, x0, b, c):
    x = torch.sqrt(rs)
    X = x * x + b * x + c
    X0 = x0 * x0 + b * x0 + c
    Q = math.sqrt(4 * c - b * b)
    atn = torch.atan2(torch.full_like(x, Q), 2 * x + b)
    return A * (torch.log(x * x / X) + 2 * b / Q * atn
                - b * x0 / X0 * (torch.log((x - x0) ** 2 / X)
                                 + 2 * (b + 2 * x0) / Q * atn))


_VWN_PARA = (0.0310907, -0.10498, 3.72744, 12.9352)
_VWN_FERRO = (0.01554535, -0.32500, 7.06042, 18.0578)
_VWN_STIFF = (-1 / (6 * math.pi ** 2), -0.0047584, 1.13107, 13.0045)
_FZ_DD0 = 8 / (9 * (2 ** (4 / 3) - 2))   # f''(0)


def _f_zeta(zeta):
    return (((1 + zeta) ** (4 / 3) + (1 - zeta) ** (4 / 3) - 2)
            / (2 ** (4 / 3) - 2))


def _zeta(rho, rho_tot):
    return torch.clamp((rho[0] - rho[1]) / rho_tot, -1 + 1e-15, 1 - 1e-15)


def lda_c_vwn_energy(rho, sigma=None):
    rho_tot = _safe_rho(torch.sum(rho, dim=0))
    rs = _rs_from_rho(rho_tot)
    eps_p = _vwn_eps(rs, *_VWN_PARA)
    if rho.shape[0] == 1:
        return rho_tot * eps_p
    zeta = _zeta(rho, rho_tot)
    eps_f = _vwn_eps(rs, *_VWN_FERRO)
    alpha = _vwn_eps(rs, *_VWN_STIFF)
    fz = _f_zeta(zeta)
    z4 = zeta ** 4
    return rho_tot * (eps_p + alpha * fz / _FZ_DD0 * (1 - z4)
                      + (eps_f - eps_p) * fz * z4)


def _pw_G(rs, A, a1, b1, b2, b3, b4, p=1.0):
    srs = torch.sqrt(rs)
    den = 2 * A * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs ** (p + 1))
    return -2 * A * (1 + a1 * rs) * torch.log1p(1.0 / den)


_PW_PARA = (0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
_PW_FERRO = (0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517)
_PW_STIFF = (0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671)


def _pw_eps(rs, zeta=None):
    """PW92 correlation energy per electron, unpolarised (zeta None) or at
    spin polarisation zeta."""
    eps_p = _pw_G(rs, *_PW_PARA)
    if zeta is None:
        return eps_p
    eps_f = _pw_G(rs, *_PW_FERRO)
    alpha = -_pw_G(rs, *_PW_STIFF)   # fit is for -alpha_c
    fz = _f_zeta(zeta)
    z4 = zeta ** 4
    return eps_p + alpha * fz / _FZ_DD0 * (1 - z4) + (eps_f - eps_p) * fz * z4


def lda_c_pw_energy(rho, sigma=None):
    rho_tot = _safe_rho(torch.sum(rho, dim=0))
    rs = _rs_from_rho(rho_tot)
    if rho.shape[0] == 1:
        return rho_tot * _pw_eps(rs)
    return rho_tot * _pw_eps(rs, _zeta(rho, rho_tot))


# Teter 93 combined XC (the Pade fit used alongside GTH psps; GTH96 appendix)
_T93_A = (0.4581652932831429, 2.217058676663745, 0.7405551735357053,
          0.01968227878617998)
_T93_DA = (0.119086804055547, 0.6157402568883345, 0.1574201515892867,
           0.003532336663397157)
_T93_B = (1.0, 4.504130959426697, 1.110667363742916, 0.02359291751427506)
_T93_DB = (0.0, 0.2673612973836267, 0.2052004607777787, 0.004200005045691381)


def lda_xc_teter93_energy(rho, sigma=None):
    rho_tot = _safe_rho(torch.sum(rho, dim=0))
    rs = _rs_from_rho(rho_tot)
    fz = 0.0 if rho.shape[0] == 1 else _f_zeta(_zeta(rho, rho_tot))
    a = [ai + fz * dai for ai, dai in zip(_T93_A, _T93_DA)]
    b = [bi + fz * dbi for bi, dbi in zip(_T93_B, _T93_DB)]
    num = a[0] + rs * (a[1] + rs * (a[2] + rs * a[3]))
    den = rs * (b[0] + rs * (b[1] + rs * (b[2] + rs * b[3])))
    return rho_tot * (-num / den)


# PBE exchange and correlation (Perdew-Burke-Ernzerhof 1996), and the
# PBEsol constants (2008)
_PBE_KAPPA = 0.8040
_PBE_MU = 0.2195149727645171          # beta * pi^2 / 3
_PBESOL_MU = 10 / 81
_PBE_BETA = 0.06672455060314922
_PBESOL_BETA = 0.046
_PBE_GAMMA = (1 - math.log(2.0)) / math.pi ** 2


def _pbe_x_unpol(rho, sigma, mu, kappa):
    r = _safe_rho(rho)
    kf = (3 * math.pi ** 2 * r) ** (1 / 3)
    s2 = sigma / _den_floor((2 * kf * r) ** 2)
    Fx = 1 + kappa - kappa / (1 + mu * s2 / kappa)
    return _CX * r ** (4 / 3) * Fx


def _gga_x_energy(rho, sigma, mu, kappa):
    if rho.shape[0] == 1:
        return _pbe_x_unpol(rho[0], sigma[0], mu, kappa)
    # exact spin scaling: E_x[ra, rb] = (E_x[2 ra] + E_x[2 rb]) / 2
    ea = _pbe_x_unpol(2 * rho[0], 4 * sigma[0], mu, kappa)
    eb = _pbe_x_unpol(2 * rho[1], 4 * sigma[2], mu, kappa)
    return (ea + eb) / 2


def gga_x_pbe_energy(rho, sigma):
    return _gga_x_energy(rho, sigma, _PBE_MU, _PBE_KAPPA)


def gga_x_pbe_sol_energy(rho, sigma):
    return _gga_x_energy(rho, sigma, _PBESOL_MU, _PBE_KAPPA)


def _gga_c_pbe(rho, sigma, beta):
    rho_tot = _safe_rho(torch.sum(rho, dim=0))
    rs = _rs_from_rho(rho_tot)
    if rho.shape[0] == 1:
        zeta = torch.zeros_like(rho_tot)
        sig = sigma[0]
        eps_lda = _pw_eps(rs)
    else:
        zeta = _zeta(rho, rho_tot)
        sig = sigma[0] + 2 * sigma[1] + sigma[2]
        eps_lda = _pw_eps(rs, zeta)
    phi = ((1 + zeta) ** (2 / 3) + (1 - zeta) ** (2 / 3)) / 2
    kf = (3 * math.pi ** 2 * rho_tot) ** (1 / 3)
    ks = torch.sqrt(4 * kf / math.pi)
    t2 = sig / _den_floor((2 * phi * ks * rho_tot) ** 2)
    phi3 = phi ** 3
    A = beta / _PBE_GAMMA / _den_floor(torch.exp(-eps_lda / (_PBE_GAMMA * phi3)) - 1)
    num = 1 + A * t2
    H = _PBE_GAMMA * phi3 * torch.log1p(beta / _PBE_GAMMA * t2 * num
                                        / (num + (A * t2) ** 2))
    return rho_tot * (eps_lda + H)


def gga_c_pbe_energy(rho, sigma):
    return _gga_c_pbe(rho, sigma, _PBE_BETA)


def gga_c_pbe_sol_energy(rho, sigma):
    return _gga_c_pbe(rho, sigma, _PBESOL_BETA)


# HJS omega-PBE short-range exchange (Henderson, Janesko, Scuseria, J. Chem.
# Phys. 128, 194105 (2008)): the erfc-screened exchange of a model PBE hole,
# the semilocal short-range part of HSE06 (reference src/standard_models.jl:
# 163-166).  The shape function H(s) is the JAX package's rational refit
# (its F(s, nu = 0) matches PBE to ~1e-5 for s in [0, 30]); the constants
# and the clamps (s at 50, zeta at 1e-30) are those of
# dftk_tpu/ops/xc/functionals.py:289-421, so autograd sees the same floors.
_HJS_A = 0.757211
_HJS_B = -0.106364
_HJS_C = -0.118649
_HJS_D = 0.609650
# zeta(s) = s^2 H(s), H(s) = (a1 s^2 + ... + a6 s^7)/(1 + b1 s + ... + b9 s^9)
_HJS_HA = (0.01539809, -0.03415762, 0.03319737, -0.01392621, -0.0003318682,
           0.002161391)
_HJS_HB = (-2.61897, 3.066503, -2.046006, 0.8732485, -0.2491473, 0.04988374,
           -0.003572147, -0.0001762652, 0.001713341)


def _hjs_fx_sr(s, nu):
    """HJS short-range enhancement factor F(s, nu), nu = omega / kF > 0."""
    s = torch.clamp(s, max=50.0)          # zeta is flat beyond s ~ 30
    num = sum(a * s ** (i + 4) for i, a in enumerate(_HJS_HA))
    den = 1.0 + sum(b * s ** (i + 1) for i, b in enumerate(_HJS_HB))
    zet = torch.clamp(num / den, min=1e-30)    # sqrt(zeta) needs zeta > 0
    eta = _HJS_A + zet
    lam = _HJS_D + zet
    F = 1.0 - s ** 2 / (27.0 * _HJS_C * (1.0 + s ** 2 / 4.0)) - zet / (2.0 * _HJS_C)
    EG = (-(2.0 / 5.0) * _HJS_C * F * lam
          - (4.0 / 15.0) * _HJS_B * lam ** 2
          - (6.0 / 5.0) * _HJS_A * lam ** 3
          - (4.0 / 5.0) * math.sqrt(math.pi) * lam ** 3.5
          - (12.0 / 5.0) * lam ** 3.5 * (torch.sqrt(zet) - torch.sqrt(eta)))
    nu2 = nu ** 2
    chi = nu / torch.sqrt(lam + nu2)
    szl = torch.sqrt(zet + nu2)
    sel = torch.sqrt(eta + nu2)
    sll = torch.sqrt(lam + nu2)
    return (_HJS_A
            - (4.0 / 9.0) * _HJS_B / lam * (1.0 - chi)
            - (4.0 / 9.0) * _HJS_C * F / lam ** 2 * (1.0 - 1.5 * chi + 0.5 * chi ** 3)
            - (8.0 / 9.0) * EG / lam ** 3
            * (1.0 - 1.875 * chi + 1.25 * chi ** 3 - 0.375 * chi ** 5)
            + 2.0 * nu * (szl - sel)
            + 2.0 * zet * torch.log((nu + szl) / (nu + sll))
            - 2.0 * eta * torch.log((nu + sel) / (nu + sll)))


def _wpbeh_unpol(rho, sigma, omega):
    r = _safe_rho(rho)
    kf = (3 * math.pi ** 2 * r) ** (1 / 3)
    s = torch.sqrt(torch.clamp(sigma, min=1e-30) / _den_floor((2 * kf * r) ** 2))
    return _CX * r ** (4 / 3) * _hjs_fx_sr(s, omega / kf)


@dataclasses.dataclass(frozen=True)
class Functional:
    name: str
    family: str                        # "lda" | "gga" | "mgga"
    energy: Callable = None            # (rho, sigma[, tau]) -> energy/volume
    # potential-only functionals (TB09, mBJ) have no energy: the
    # multiplicative V is evaluated directly
    potential: Callable = None         # (rho, G_cart, tau) -> V


def _mgga(name):
    """A meta-GGA energy of ops/xc/mgga.py, imported at first call."""
    def energy(rho, sigma, tau=None):
        from . import mgga
        return getattr(mgga, name)(rho, sigma, tau)
    return energy


def _tb09_potential(rho, G_cart, tau):
    from .tb09 import tb09_potential
    return tb09_potential(rho, G_cart, tau)


def make_gga_x_wpbeh(omega=0.11):
    """Short-range (erfc-screened) omega-PBE exchange functional."""
    if not omega > 0:
        raise ValueError("gga_x_wpbeh needs omega > 0 (use gga_x_pbe at 0)")

    def energy(rho, sigma):
        if rho.shape[0] == 1:
            return _wpbeh_unpol(rho[0], sigma[0], omega)
        # exact spin scaling, as for PBE exchange
        return (_wpbeh_unpol(2 * rho[0], 4 * sigma[0], omega)
                + _wpbeh_unpol(2 * rho[1], 4 * sigma[2], omega)) / 2
    return Functional(f"gga_x_wpbeh@{omega:g}", "gga", energy)


FUNCTIONALS = {
    "lda_x": Functional("lda_x", "lda", lda_x_energy),
    "lda_c_vwn": Functional("lda_c_vwn", "lda", lda_c_vwn_energy),
    "lda_c_pw": Functional("lda_c_pw", "lda", lda_c_pw_energy),
    "lda_xc_teter93": Functional("lda_xc_teter93", "lda", lda_xc_teter93_energy),
    "gga_x_pbe": Functional("gga_x_pbe", "gga", gga_x_pbe_energy),
    "gga_c_pbe": Functional("gga_c_pbe", "gga", gga_c_pbe_energy),
    "gga_x_pbe_sol": Functional("gga_x_pbe_sol", "gga", gga_x_pbe_sol_energy),
    "gga_c_pbe_sol": Functional("gga_c_pbe_sol", "gga", gga_c_pbe_sol_energy),
    "mgga_x_scan": Functional("mgga_x_scan", "mgga", _mgga("scan_energy")),
    "mgga_x_r2scan": Functional("mgga_x_r2scan", "mgga", _mgga("r2scan_energy")),
    "mgga_x_tpss": Functional("mgga_x_tpss", "mgga", _mgga("tpss_x_energy")),
    "mgga_c_tpss": Functional("mgga_c_tpss", "mgga", _mgga("tpss_c_energy")),
    "gga_x_wpbeh": make_gga_x_wpbeh(0.11),
    "mgga_x_tb09": Functional("mgga_x_tb09", "mgga", None, _tb09_potential),
}

# Named functional sets mirroring DFTK standard_models.jl:163-166
FUNCTIONAL_SETS = {
    "LDA": ("lda_x", "lda_c_pw"),
    "PBE": ("gga_x_pbe", "gga_c_pbe"),
    "PBEsol": ("gga_x_pbe_sol", "gga_c_pbe_sol"),
    # SCAN and r2SCAN exchange and correlation are one function (shared alpha)
    "SCAN": ("mgga_x_scan",),
    "r2SCAN": ("mgga_x_r2scan",),
    "TPSS": ("mgga_x_tpss", "mgga_c_tpss"),
    # potential-only mBJ exchange with LDA correlation (the reference's
    # silicon_TB09 ABINIT deck); its energies are not variational
    "TB09": ("mgga_x_tb09", "lda_c_pw"),
}


def resolve_functionals(functionals):
    """Accept a set name, names, or (name, scale) pairs; returns
    [(Functional, scale), ...]."""
    if isinstance(functionals, str):
        names = FUNCTIONAL_SETS.get(functionals, (functionals,))
    else:
        names = tuple(functionals)
    out = []
    for entry in names:
        name, scale = entry if isinstance(entry, (tuple, list)) else (entry, 1.0)
        if isinstance(name, Functional):
            fun = name
        elif name in FUNCTIONALS:
            fun = FUNCTIONALS[name]
        else:
            raise KeyError(f"unknown functional {name!r}; the port has "
                           f"{sorted(FUNCTIONALS)}")
        out.append((fun, float(scale)))
    return out
