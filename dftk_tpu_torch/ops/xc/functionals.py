"""LDA exchange-correlation functionals as differentiable torch expressions.

Port of the LDA set of `dftk_tpu/ops/xc/functionals.py` (names follow
libxc): lda_x (Slater exchange), lda_c_vwn (VWN5), lda_c_pw (PW92) and
lda_xc_teter93 (Teter's Pade fit of LDA exchange and correlation).
Potentials come from `torch.autograd` through the energy
(`ops/hamiltonian.py::total_potential`).  GGA and meta-GGA functionals come
with a later slice (ROADMAP Queue 1, item 8).

rho has shape [nspin, ...] with nspin in {1, 2}; each functional returns an
energy density per unit volume.
"""
import dataclasses
import math
from typing import Callable

import torch

_RHO_EPS = 1e-14        # libxc-style density threshold


def _safe_rho(rho):
    return torch.clamp(rho, min=_RHO_EPS)


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


def lda_c_pw_energy(rho, sigma=None):
    rho_tot = _safe_rho(torch.sum(rho, dim=0))
    rs = _rs_from_rho(rho_tot)
    eps_p = _pw_G(rs, *_PW_PARA)
    if rho.shape[0] == 1:
        return rho_tot * eps_p
    zeta = _zeta(rho, rho_tot)
    eps_f = _pw_G(rs, *_PW_FERRO)
    alpha = -_pw_G(rs, *_PW_STIFF)   # fit is for -alpha_c
    fz = _f_zeta(zeta)
    z4 = zeta ** 4
    return rho_tot * (eps_p + alpha * fz / _FZ_DD0 * (1 - z4)
                      + (eps_f - eps_p) * fz * z4)


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


@dataclasses.dataclass(frozen=True)
class Functional:
    name: str
    family: str                        # "lda" in this slice
    energy: Callable = None            # (rho, sigma) -> energy/volume


FUNCTIONALS = {
    "lda_x": Functional("lda_x", "lda", lda_x_energy),
    "lda_c_vwn": Functional("lda_c_vwn", "lda", lda_c_vwn_energy),
    "lda_c_pw": Functional("lda_c_pw", "lda", lda_c_pw_energy),
    "lda_xc_teter93": Functional("lda_xc_teter93", "lda", lda_xc_teter93_energy),
}

# Named functional sets mirroring DFTK standard_models.jl:163-166
FUNCTIONAL_SETS = {"LDA": ("lda_x", "lda_c_pw")}


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
            raise NotImplementedError(
                f"functional {name!r} is not ported yet; this slice has "
                f"{sorted(FUNCTIONALS)} (GGA and meta-GGA: ROADMAP Queue 1, "
                f"item 8)")
        out.append((fun, float(scale)))
    return out
