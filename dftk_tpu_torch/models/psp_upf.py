"""Numerical UPF (Unified Pseudopotential Format v2) pseudopotentials.

Port of `dftk_tpu/models/psp_upf.py` (reference `src/pseudo/PspUpf.jl`,
`common/hankel.jl`, `common/quadrature.jl`): radial-grid quantities (the
local potential, r^2-scaled Kleinman-Bylander projectors, pseudo-wave-
functions, valence and core densities, the core kinetic-energy density)
are Hankel-transformed to Fourier space with Simpson quadrature; the local
potential's Coulomb tail is regularised QE-style by subtracting
-Z erf(r)/r (whose transform -4 pi Z / p^2 e^{-p^2/4} is analytic).

The evaluators are numpy over |p| arrays, run on the host at the distinct
|p| only (`_unique_eval`), as in the JAX package.  `projector_fourier`
divides out p^l (the solid-harmonic convention shared with PspHgh).

The `*_sq` evaluators take p^2: a numpy array, or a torch tensor.  On a
tensor the values come from the same host evaluation, and where the tensor
carries a gradient (the stresses and the elastic response trace |G|^2
through the lattice) each derivative d^k / d(p^2)^k is evaluated on the
host too, when a backward asks for it (`radial_sq`; for a Hankel transform
of order l it is (-1/2)^k the order l+k transform of r^k f(r)).  So the
graph holds one tensor per evaluator and order, never a [|G|, r] table,
and its derivatives are exact to any order.

Supports norm-conserving UPF 2.0.x files (no spin-orbit, ultrasoft or PAW).
"""
import dataclasses
import math
import re
import xml.etree.ElementTree as ET

import numpy as np
import torch
from scipy.special import erf, spherical_jn

_CHUNK = 4e6        # entries of one [p, r] block of a host Hankel transform


def simpson_weights(r):
    """Quadrature weights w with  integral f ~= sum_i w_i f(r_i): composite
    Simpson on uniform or nonuniform grids (the reference's simpson and
    simpson_nonuniform, quadrature.jl)."""
    r = np.asarray(r, dtype=float)
    n = len(r)
    w = np.zeros(n)
    if n < 5:
        if n == 1:
            return w
        w[0] = (r[1] - r[0]) / 2
        w[-1] = (r[-1] - r[-2]) / 2
        for i in range(1, n - 1):
            w[i] = (r[i + 1] - r[i - 1]) / 2
        return w

    dx0 = r[1] - r[0]
    if abs((r[2] - r[1]) - dx0) < 1e-10 * abs(dx0):
        odd = (n - 1) % 2 == 1
        jstop = n - 3 if odd else n - 2     # last regular interior point
        w[0] = dx0 / 3
        for j in range(1, jstop + 1):
            w[j] = (4 / 3 if j % 2 == 1 else 2 / 3) * dx0
        if odd:
            # the last interval by the 3-point end correction (quadrature.jl)
            w[n - 1] += 5 / 12 * dx0
            w[n - 2] += dx0
            w[n - 3] += -1 / 12 * dx0
        else:
            w[n - 1] = dx0 / 3
        return w

    # nonuniform composite Simpson over pairs of intervals
    n_int = n - 1
    i = 0
    while i + 2 <= n_int:
        h0 = r[i + 1] - r[i]
        h1 = r[i + 2] - r[i + 1]
        hsum = h0 + h1
        w[i] += hsum / 6 * (2 - h1 / h0)
        w[i + 1] += hsum ** 3 / (6 * h0 * h1)
        w[i + 2] += hsum / 6 * (2 - h0 / h1)
        i += 2
    if i < n_int:  # one leftover interval: a corrected trapezoid
        h0 = r[-1] - r[-2]
        h1 = r[-2] - r[-3]
        w[-1] += h0 * (2 * h0 + 3 * h1) / (6 * (h0 + h1))
        w[-2] += h0 * (h0 + 3 * h1) / (6 * h1)
        w[-3] -= h0 ** 3 / (6 * h1 * (h0 + h1))
    return w


def _sph_jl_over_xl(l, x):
    """j_l(x) / x^l, stable at x = 0."""
    x = np.asarray(x, dtype=float)
    small = np.abs(x) < 1e-3
    xs = np.where(small, 1.0, x)
    dfact = float(math.prod(range(1, 2 * l + 2, 2)))           # (2l + 1)!!
    x2 = x * x
    series = (1 - x2 / (2 * (2 * l + 3))
              + x2 * x2 / (8 * (2 * l + 3) * (2 * l + 5))) / dfact
    return np.where(small, series, spherical_jn(l, xs) / xs ** l)


def _unique_eval(fn, p):
    """fn on the distinct values of p (any shape, rounded to 12 decimals),
    scattered back."""
    p = np.asarray(p, dtype=float)
    uniq, inv = np.unique(np.round(p.reshape(-1), 12), return_inverse=True)
    return fn(uniq)[inv].reshape(p.shape)


def _chunked(fn, pf, n_r):
    """fn(p_chunk) over chunks of the 1-D pf bounding the [p, r] blocks."""
    out = np.empty(pf.shape)
    chunk = max(1, int(_CHUNK // max(n_r, 1)))
    for i in range(0, len(pf), chunk):
        out[i:i + chunk] = fn(pf[i:i + chunk])
    return out


def hankel(r, r2_f, l, p, weights=None):
    """The modified Hankel transform 4 pi / p^l  int f(r) j_l(pr) r^2 dr
    (r2_f = r^2 f on the grid r) at p of any shape."""
    r = np.asarray(r, dtype=float)
    if weights is None:
        weights = simpson_weights(r)
    wf = weights * np.asarray(r2_f, dtype=float)
    rl = r ** l

    def eval_flat(pf):
        # j_l(pr) / (pr)^l * r^l divides out p^l
        return _chunked(lambda pc: 4 * math.pi * np.sum(
            wf[None, :] * _sph_jl_over_xl(l, pc[:, None] * r[None, :]) * rl[None, :],
            axis=1), pf, len(r))

    return _unique_eval(eval_flat, p)


def hankel_derivative(r, r2_f, l, k, p, weights=None):
    """d^k hankel(r, r2_f, l, p) / d(p^2)^k = (-1/2)^k hankel(r, r^k r2_f,
    l + k, p) (from d/dx [j_l(x) / x^l] = -x j_{l+1}(x) / x^{l+1})."""
    r = np.asarray(r, dtype=float)
    return (-0.5) ** k * hankel(r, r ** k * np.asarray(r2_f, dtype=float), l + k, p, weights)


def _host_eval(deriv, k, psq):
    p = np.sqrt(np.maximum(psq.detach().cpu().numpy(), 0.0))
    return torch.as_tensor(deriv(k, p), dtype=psq.dtype, device=psq.device)


class _RadialSq(torch.autograd.Function):
    """deriv(k, .) of a p^2 tensor, evaluated on the host; its backward is
    the order k + 1, itself differentiable."""

    @staticmethod
    def forward(ctx, psq, deriv, k):
        ctx.save_for_backward(psq)
        ctx.deriv, ctx.k, ctx.next_order = deriv, k, {}
        return _host_eval(deriv, k, psq)

    @staticmethod
    def backward(ctx, grad):
        # the next order depends on psq alone: one host evaluation per grad
        # mode, however many backward passes (a Hessian's rows) reach it
        (psq,) = ctx.saved_tensors
        mode = torch.is_grad_enabled()
        if mode not in ctx.next_order:
            ctx.next_order[mode] = radial_sq(ctx.deriv, psq, ctx.k + 1)
        return grad * ctx.next_order[mode], None, None


def radial_sq(deriv, psq, k=0):
    """A radial function of |p| as a function of psq = p^2.

    deriv(k, p) is the numpy d^k value / d(p^2)^k at p >= 0.  On a numpy
    psq: deriv(k, sqrt(psq)).  On a torch tensor: the host values on psq's
    device and dtype; where psq carries a gradient, each backward through
    them evaluates the next order (module docstring)."""
    if not torch.is_tensor(psq):
        return deriv(k, np.sqrt(np.maximum(psq, 0.0)))
    if psq.requires_grad and torch.is_grad_enabled():
        return _RadialSq.apply(psq, deriv, k)
    return _host_eval(deriv, k, psq)


@dataclasses.dataclass(frozen=True, eq=False)
class PspUpf:
    Zion: int
    lmax: int
    rgrid: tuple
    vloc: tuple                     # local potential on rgrid (Ha)
    r2_projs: tuple                 # [l][i] -> r^2 beta on the (cut) grid
    h: tuple                        # coupling blocks per l (Ha)
    r2_pswfcs: tuple                # [l][i] -> r^2 chi
    pswfc_occs: tuple
    pswfc_labels: tuple
    r2_rho_ion: tuple
    r2_rho_core: tuple
    r2_tau_core: tuple = ()         # the NLCC core kinetic-energy density (meta-GGA)
    identifier: str = ""
    description: str = ""

    def __hash__(self):
        return hash(self.identifier)

    def __eq__(self, other):
        return self is other or (isinstance(other, PspUpf)
                                 and self.identifier == other.identifier)

    @property
    def _r(self):
        return np.asarray(self.rgrid)

    @property
    def _w(self):
        if "_w_cache" not in self.__dict__:
            object.__setattr__(self, "_w_cache", simpson_weights(self._r))
        return self._w_cache

    def n_proj_radial(self, l):
        return len(self.r2_projs[l]) if l <= self.lmax else 0

    def n_proj(self):
        return sum((2 * l + 1) * self.n_proj_radial(l) for l in range(self.lmax + 1))

    def n_pswfc_radial(self, l):
        return len(self.r2_pswfcs[l]) if l < len(self.r2_pswfcs) else 0

    def n_pswfc(self):
        return sum((2 * l + 1) * self.n_pswfc_radial(l) for l in range(len(self.r2_pswfcs)))

    # -- the local potential ---------------------------------------------------
    def _local_wf(self):
        r = self._r
        return self._w * (r * np.asarray(self.vloc) + self.Zion * erf(r))

    def local_fourier(self, p):
        """The QE-style tail-corrected Hankel transform of the local
        potential; 0 at p = 0."""
        r, wf, Z = self._r, self._local_wf(), self.Zion

        def block(pc):
            I = np.sum(wf[None, :] * np.sin(pc[:, None] * r[None, :]), axis=1) / pc
            return 4 * math.pi * (I - Z / pc ** 2 * np.exp(-pc ** 2 / 4))

        def eval_flat(pf):
            ps = np.where(pf == 0, 1.0, pf)
            return np.where(pf == 0, 0.0, _chunked(block, ps, len(r)))

        return _unique_eval(eval_flat, p)

    def _local_derivative(self, k, p):
        """d^k local_fourier / d(p^2)^k; 0 at p = 0, where G = 0 stays
        under strain.  The integral part 4 pi int w (r V + Z erf r) sin(pr)
        / p is the order-0 Hankel transform of r (r V + Z erf r); the tail
        -4 pi Z e^{-q/4} / q (q = p^2) is differentiated by Leibniz."""
        if k == 0:
            return self.local_fourier(p)
        r, Z = self._r, self.Zion
        g = r * np.asarray(self.vloc) + Z * erf(r)
        integral = hankel_derivative(r, r * g, 0, k, p, weights=self._w)
        p = np.asarray(p, dtype=float)
        q = np.where(p == 0, 1.0, p * p)
        tail = sum(math.comb(k, j) * (-0.25) ** (k - j) * (-1) ** j * math.factorial(j)
                   * q ** (-1.0 - j) for j in range(k + 1))
        return np.where(p == 0, 0.0,
                        integral - 4 * math.pi * Z * np.exp(-q / 4) * tail)

    def local_fourier_sq(self, psq):
        return radial_sq(self._local_derivative, psq)

    def local_real(self, r):
        return np.interp(r, self._r, np.asarray(self.vloc))

    def energy_correction(self):
        r = self._r
        return float(4 * math.pi * np.sum(self._w * r * (r * np.asarray(self.vloc)
                                                          + self.Zion)))

    # -- Hankel-transformed radial quantities ------------------------------------
    def _radial(self, r2f, l):
        """deriv(k, p) of the order-l Hankel transform of r2f on the first
        len(r2f) grid points (k = 0: the transform)."""
        r2f = np.asarray(r2f, dtype=float)
        n = len(r2f)
        r = self._r[:n]
        w = self._w if n == len(self.rgrid) else simpson_weights(r)
        return lambda k, p: hankel_derivative(r, r2f, l, k, p, weights=w)

    def projector_fourier(self, i, l, p):
        return self._radial(self.r2_projs[l][i - 1], l)(0, p)

    def projector_fourier_sq(self, i, l, psq):
        return radial_sq(self._radial(self.r2_projs[l][i - 1], l), psq)

    def pswfc_fourier(self, i, l, p):
        return self._radial(self.r2_pswfcs[l][i - 1], l)(0, p)

    def valence_density_fourier(self, p):
        return self._radial(self.r2_rho_ion, 0)(0, p)

    def core_density_fourier(self, p):
        return self._radial(self.r2_rho_core, 0)(0, p)

    def core_density_fourier_sq(self, psq):
        return radial_sq(self._radial(self.r2_rho_core, 0), psq)

    def core_tau_fourier(self, p):
        """The l = 0 Hankel transform of the core kinetic-energy density
        (reference eval_psp_core_kinetic_energy_density_fourier,
        src/pseudo/PspUpf.jl:302-306), for meta-GGA with NLCC."""
        return self._radial(self.r2_tau_core, 0)(0, p)

    def core_tau_fourier_sq(self, psq):
        return radial_sq(self._radial(self.r2_tau_core, 0), psq)

    def has_valence_density(self):
        return any(v != 0 for v in self.r2_rho_ion)

    def has_core_density(self):
        return any(v != 0 for v in self.r2_rho_core)

    def has_core_tau(self):
        """A core kinetic-energy density is present (reference
        has_core_kinetic_energy_density, src/pseudo/PspUpf.jl:180)."""
        return any(v != 0 for v in self.r2_tau_core)


def _floats(text):
    return np.array([float(x) for x in text.split()], dtype=float)


def parse_upf(path_or_text, identifier=None) -> PspUpf:
    """Parse a UPF v2 XML file (a path or the raw text)."""
    if "\n" in str(path_or_text) or "<UPF" in str(path_or_text):
        text = path_or_text
        identifier = identifier or "upf"
    else:
        with open(path_or_text) as f:
            text = f.read()
        identifier = identifier or str(path_or_text)
    # some files hold bare '&' characters, which break XML parsing
    text = re.sub(r"&(?![a-zA-Z]+;)", "&amp;", text)
    root = ET.fromstring(text)
    if root.tag != "UPF":
        raise ValueError("Not a UPF v2 file")

    header = root.find("PP_HEADER").attrib
    if header.get("pseudo_type", "NC") not in ("NC", "SL"):
        raise NotImplementedError(f"Unsupported pseudo type {header.get('pseudo_type')}")
    if header.get("has_so", "F").upper().startswith("T"):
        raise NotImplementedError("Spin-orbit UPF not supported")

    Zion = int(float(header["z_valence"]))
    lmax = int(header["l_max"])
    r = _floats(root.find("PP_MESH").find("PP_R").text)
    vloc = _floats(root.find("PP_LOCAL").text) / 2                # Ry -> Ha

    nonlocal_ = root.find("PP_NONLOCAL")
    betas = []
    for el in nonlocal_:
        if el.tag.startswith("PP_BETA"):
            l = int(el.attrib["angular_momentum"])
            icut = int(el.attrib.get("cutoff_radius_index", len(_floats(el.text))))
            rb = _floats(el.text)[:icut] / 2                      # Ry -> Ha
            betas.append((l, r[:len(rb)] * rb))                   # r beta -> r^2 beta
    dij = (_floats(nonlocal_.find("PP_DIJ").text) * 2).reshape(len(betas), len(betas))

    r2_projs, h = [], []
    for l in range(lmax + 1):
        idx = [i for i, (bl, _) in enumerate(betas) if bl == l]
        r2_projs.append(tuple(tuple(betas[i][1]) for i in idx))
        h.append(tuple(map(tuple, dij[np.ix_(idx, idx)])))

    r2_pswfcs = [[] for _ in range(lmax + 1)]
    occs = [[] for _ in range(lmax + 1)]
    labels = [[] for _ in range(lmax + 1)]
    pswfc = root.find("PP_PSWFC")
    if pswfc is not None:
        for el in pswfc:
            if el.tag.startswith("PP_CHI"):
                l = int(el.attrib["l"])
                while len(r2_pswfcs) <= l:
                    r2_pswfcs.append([])
                    occs.append([])
                    labels.append([])
                chi = _floats(el.text)
                r2_pswfcs[l].append(tuple(r[:len(chi)] * chi))    # r chi -> r^2 chi
                occs[l].append(float(el.attrib.get("occupation", 0)))
                labels[l].append(el.attrib.get("label", ""))

    rhoatom = root.find("PP_RHOATOM")
    r2_rho_ion = (_floats(rhoatom.text) / (4 * math.pi) if rhoatom is not None
                  else np.zeros(len(r)))
    nlcc = root.find("PP_NLCC")
    r2_rho_core = r ** 2 * _floats(nlcc.text) if nlcc is not None else np.zeros(len(r))
    # the core kinetic-energy density of meta-GGA NLCC files, r^2-scaled as
    # the reference does (src/pseudo/PspUpf.jl:158)
    taumod = root.find("PP_TAUMOD")
    r2_tau_core = r ** 2 * _floats(taumod.text) if taumod is not None else np.zeros(len(r))

    return PspUpf(
        Zion=Zion, lmax=lmax, rgrid=tuple(r), vloc=tuple(vloc),
        r2_projs=tuple(r2_projs), h=tuple(h),
        r2_pswfcs=tuple(tuple(x) for x in r2_pswfcs),
        pswfc_occs=tuple(tuple(x) for x in occs),
        pswfc_labels=tuple(tuple(x) for x in labels),
        r2_rho_ion=tuple(r2_rho_ion), r2_rho_core=tuple(r2_rho_core),
        r2_tau_core=tuple(r2_tau_core), identifier=identifier,
        description=header.get("comment", ""))


def load_psp_upf(path) -> PspUpf:
    return parse_upf(path)
