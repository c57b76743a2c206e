"""Analytic GTH/HGH norm-conserving pseudopotentials.

Port of `dftk_tpu/models/psp_hgh.py` (reference `src/pseudo/PspHgh.jl`):
the same published closed forms (GTH96 eq. (1)-(8), HGH98 eq. (1)-(15)),
evaluated in numpy on the host while the basis is set up, and as torch
functions of p^2 (`*_sq`) inside the stresses' graph.  UPF files are
`models/psp_upf.py`'s; `load_psp_hgh` hands a path ending in .upf to it.

Conventions:
  * `local_fourier(p)` is the Fourier transform of the local potential with
    the -Z/r tail's G=0 divergence removed (0 at p=0).  Hartree * bohr^3.
  * `projector_fourier_sq(i, l, p^2)` is the radial part of
    \\hat{proj}_{il}(p) with the 1/p^l factor divided out.
"""
import dataclasses
import math
import re
from typing import List

import numpy as np
import torch

from .psp_data import DEFAULT_Q_SEMICORE, HGH_PSP_TABLE


@dataclasses.dataclass(frozen=True)
class PspHgh:
    Zion: int                 # ionic charge (Z - n_core_electrons)
    rloc: float               # range of the local Gaussian charge
    cloc: tuple               # 4 coefficients of the local polynomial part
    rp: tuple                 # projector radius per angular-momentum channel
    h: tuple                  # per-l coupling matrices (tuple of 2D tuples)
    identifier: str = ""
    description: str = ""

    @property
    def lmax(self):
        return len(self.rp) - 1

    def n_proj_radial(self, l):
        """Number of radial projectors i for angular momentum l."""
        if l > self.lmax:
            return 0
        return len(self.h[l])

    def n_proj(self):
        """Total number of projectors Sum_l (2l+1) * nproj_l."""
        return sum((2 * l + 1) * self.n_proj_radial(l) for l in range(self.lmax + 1))

    def local_fourier(self, p):
        """V_loc(|p|) in Fourier space (GTH96 eq. (6)); p=0 -> 0."""
        return self.local_fourier_sq(np.asarray(p) ** 2)

    def local_fourier_sq(self, psq):
        """local_fourier as a function of p^2 (numpy array or torch tensor).

        The HGH forms are even in p; taking p^2 keeps a torch graph smooth
        at p = 0 (no sqrt), which the stresses need."""
        xp = _xp(psq)
        t2 = psq * self.rloc ** 2
        c1, c2, c3, c4 = self.cloc
        P = (c1
             + c2 * (3 - t2)
             + c3 * (15 - 10 * t2 + t2 * t2)
             + c4 * (105 - 105 * t2 + 21 * t2 * t2 - t2 * t2 * t2))
        pref = 4 * math.pi * self.rloc ** 2
        # a safe division at p = 0, whose value the last where replaces
        t2s = xp.where(t2 == 0, 1.0, t2)
        val = pref * (-self.Zion + math.sqrt(math.pi / 2) * self.rloc * t2 * P) \
            * xp.exp(-t2 / 2) / t2s
        return xp.where(t2 == 0, 0.0, val)

    def projector_fourier_sq(self, i, l, psq):
        """Radial Fourier projector \\hat{proj}_{il}(p) / p^l (HGH98 eq. 7-15)
        as a function of p^2 (numpy array or torch tensor; smooth at p = 0);
        i is 1-based as in the published tables."""
        rp = self.rp[l]
        t2 = psq * rp * rp
        common = (4 * math.pi ** (5 / 4) * math.sqrt(2.0 ** (l + 1) * rp ** 3)
                  * _xp(psq).exp(-t2 / 2))
        if l == 0:
            if i == 1:
                return common
            if i == 2:
                return common * 2 / math.sqrt(15.0) * (3 - t2)
            if i == 3:
                return common * 4 / (3 * math.sqrt(105.0)) * (15 - 10 * t2 + t2 * t2)
        if l == 1:
            if i == 1:
                return common / math.sqrt(3.0) * rp
            if i == 2:
                return common * 2 / math.sqrt(105.0) * rp * (5 - t2)
            if i == 3:
                return common * 4 / (3 * math.sqrt(1155.0)) * rp * (35 - 14 * t2 + t2 * t2)
        if l == 2:
            if i == 1:
                return common / math.sqrt(15.0) * rp ** 2
            if i == 2:
                return common * 2 / (3 * math.sqrt(105.0)) * rp ** 2 * (7 - t2)
        if l == 3 and i == 1:
            return common / math.sqrt(105.0) * rp ** 3
        raise NotImplementedError(f"HGH projector not implemented for l={l}, i={i}")

    def energy_correction(self):
        """DC-offset correction lim_{p->0} (V_loc(p) + 4 pi Z / p^2)
        (DFTK PspHgh.jl:173-184)."""
        coeffs = (1.0, 3.0, 15.0, 105.0)
        dc = (self.Zion * self.rloc ** 2 / 2
              + math.sqrt(math.pi / 2) * self.rloc ** 3
              * sum(c * cl for c, cl in zip(coeffs, self.cloc)))
        return 4 * math.pi * dc


def _xp(a):
    """The array module of `a`: torch for a tensor, else numpy."""
    return torch if torch.is_tensor(a) else np


_NUMS = re.compile(r"[-+]?[0-9]*\.?[0-9]+(?:[eEdD][-+]?[0-9]+)?")


def parse_hgh(text: str, identifier: str = "") -> PspHgh:
    """Parse the CP2K/ABINIT .hgh text format.

    Line 1 description; line 2 electrons per occupied AM shell; line 3
    rloc, nloc, cloc...; line 4 number of AM channels (lmax+1); then per
    channel rp nproj followed by the upper triangle of the coupling matrix h.
    """
    lines = text.splitlines()
    description = lines[0].strip()

    def nums(s):
        return [float(x.replace("D", "e").replace("d", "e"))
                for x in _NUMS.findall(s)]

    Zion = int(sum(int(v) for v in nums(lines[1])))
    loc = nums(lines[2])
    rloc = loc[0]
    nloc = int(loc[1])
    cloc = loc[2:2 + nloc]
    cloc = tuple(cloc + [0.0] * (4 - len(cloc)))
    lmax = int(nums(lines[3])[0]) - 1

    rp: List[float] = []
    h: List[tuple] = []
    cur = 4
    for l in range(lmax + 1):
        head = nums(lines[cur])
        rp.append(head[0])
        nproj = int(head[1])
        if nproj == 0:
            h.append(tuple())
            cur += 1
            continue
        hmat = np.zeros((nproj, nproj))
        row_vals = head[2:]
        for i in range(nproj):
            for j in range(i, nproj):
                hmat[i, j] = hmat[j, i] = row_vals[j - i]
            cur += 1
            if cur < len(lines) and i + 1 < nproj:
                row_vals = nums(lines[cur])
        h.append(tuple(tuple(row) for row in hmat))
    return PspHgh(Zion=Zion, rloc=rloc, cloc=cloc, rp=tuple(rp), h=tuple(h),
                  identifier=identifier, description=description)


def load_psp_hgh(key: str):
    """Load a built-in HGH psp by key, e.g. "lda/si-q4" or "Si" (semicore);
    a path ending in .upf or .UPF is loaded as a UPF file
    (`models/psp_upf.py::load_psp_upf`, as the JAX package's `load_psp`)."""
    if key.endswith(".upf") or key.endswith(".UPF"):
        from .psp_upf import load_psp_upf
        return load_psp_upf(key)
    if key.startswith("hgh/"):
        key = key[4:]
    if key in HGH_PSP_TABLE:
        return parse_hgh(HGH_PSP_TABLE[key], identifier=f"hgh/{key}")
    sym = key.capitalize() if len(key) <= 2 else key
    if sym in DEFAULT_Q_SEMICORE:
        k = f"lda/{sym.lower()}-q{DEFAULT_Q_SEMICORE[sym]}"
        return parse_hgh(HGH_PSP_TABLE[k], identifier=f"hgh/{k}")
    raise KeyError(f"Unknown built-in HGH pseudopotential: {key}")
