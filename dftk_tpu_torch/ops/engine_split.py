"""The split SCF's entry points, computed on complex tensors.

Port of `dftk_tpu/ops/engine_split.py`.  The JAX package runs this SCF in
a realified space because its TPU backend has no complex arithmetic; the
port keeps the API and the results and computes on complex tensors
(ROADMAP, "What carries over").  Where the reference takes or returns
realified orbitals U [nk, nb, 2nG] (a row [x; y] per complex band
x + iy), the port does too, at the boundary only; inside, orbitals are
complex X [nk, nb, nG].

The production path is `self_consistent_field_split(eigensolver="chefsi")`
with the compact-cube-resident Chebyshev filter (`compact_filter_ops`):
the filter's H applies stay on the compact cube, where the local part is
the hand-written kernels A -> B -> A (`kernels/local_apply.py`), and the
default `filter_precision="mixed"` runs bf16 filter cycles while the
density residual is far out and exact ones to finish;
`filter_precision="default"` runs every filter cycle in bf16 (Rayleigh-
Ritz stays exact, so the result carries the bf16 filter's residual floor).

Metals and magnets run here too: finite-temperature occupations with the
Entropy term, Kerker mixing by default at T > 0, collinear spin (each k row
applies its own spin's potential), GGA functionals, and AdaptiveBands,
which grows the band block with random orthonormalised vectors while the
top computed band is occupied.

Meta-GGA models carry tau (`compute_tau_split`, from the von Weizsaecker
tau of the first density; tau follows the orbitals without mixing), and
their H adds the DivAgrad term (`ops/hamiltonian.py::apply_divagrad`: one
more local apply of 3 nb bands through kernels A -> B -> A).  As in the
JAX package, such a run, and any run with `compact_filter=False`, filters
with the sphere apply (`sphere_filter_ops`): `apply_H_split` at
'default' for the bf16 cycles, the exact apply for the others.

Hybrids and DFT+U run here too.  The exchange (compressed by ACE with
`use_ace`, else the bare operator) and the +U potential of the orbitals
and occupations that enter the step join H as extra applies; with extra
applies the filter leaves the compact cube, as in the JAX package: every
Chebyshev step applies the full-precision H on the sphere plus the extra
terms (`sphere_filter_ops`' exact apply).

The kinetic blow-ups enter through the explicit kinetic (the H apply, the
filters and LOBPCG's preconditioner read it).  A blow-up stretches H's
spectrum to max(kin) (1.95e6 Ha at Si54, Ecut 10, against ~10 bare), over
which a Chebyshev filter of degree 10 damps nothing (the filter's gain on
a wanted eigenvalue a distance d below its lower bound is ~1 + m^2 d / e,
e half the filter's interval); so CheFSI with a blown-up kinetic takes
LOBPCG steps instead, whose TPA preconditioner divides the kinetic out: on
the bf16 sphere apply (kernels A -> B -> A in bf16, tolerance floor 1e-3)
in the bf16 cycles of "mixed", before its exact latch, and on the exact
apply everywhere else, so that every other setting keeps an exact
Rayleigh-Ritz.  The External*
potentials enter through the static local potential, and a
PairwisePotential's energy joins the constant energies, as in the complex
loop (the JAX split SCF leaves it out of its energies while its split
forces add it).  The JAX package's split data carry no vector potential
and its split potential no nonlinearity, and its split SCF drops the
Anyonic term: `prepare_split_data` raises for a Magnetic,
LocalNonlinearity or Anyonic model and names `self_consistent_field` (or
`direct_minimization`).

The reference's split-engine transforms are here too, on complex tensors
behind the realified `[..., 2]` layout they take and return:
`scatter_cube_split`/`gather_cube_split`, the pruned sphere <-> real-space
transforms `sphere_to_real_pruned`/`real_to_sphere_pruned` (the reversed
(z, y, x) spatial layout), and the sandwich form of the local apply,
`build_sandwich`/`apply_local_sandwich`, which folds G3, V and B1 into one
[2 m1, 2 m1] matrix per (z, y) column (library code: torch.einsum and
matmul, as the JAX package's XLA einsums; the SCF's local apply stays on
kernels A -> B -> A).  `build_pruned_fft` is `ops/pruned.py`'s.

Under a k-point (x band) mesh (`mesh=`, or a basis distributed by
`parallel/mesh.py`) each rank iterates its own k rows; the band axis
splits every H apply and Chebyshev filter over its ranks and gathers the
block for the Gram, Rayleigh-Ritz and orthogonalisation steps
(`parallel/mesh.py::KComm`).  The realified band representations
("paired", csplit) are TPU workarounds (ROADMAP, "Not to port") and raise
NotImplementedError.
"""
import dataclasses
import math
import time
import types
from typing import Any, NamedTuple

import numpy as np
import torch

from ..basis import BasisData, real_dtype
from ..kernels.local_apply import LocalFactors, local_apply, round_bf16
from ..parallel.mesh import kgather, kmax, shard_basis
from ..scf.anderson import AndersonAcceleration
from ..scf.driver import aufbau_occupation, constant_energies
from ..scf.mixing import DielectricMixing, KerkerMixing
from . import fft as fftops
from . import hamiltonian as hamops
from .density import (compute_density, compute_kinetic_energy_density, guess_density,
                      make_symmetrizer, von_weizsaecker_tau)
from .eigen.chefsi import chefsi_step
from .eigen.lobpcg import lobpcg, ortho_qr
from .exx_ace import apply_ace, build_ace
from .hubbard import HubbardSetup
from .occupation import compute_occupation, entropy_energy
from .pruned import PrunedFFT, build_pruned_fft, compact_to_sphere, sphere_to_compact  # noqa: F401
from .terms import refuse_anyonic, refuse_terms
from .xc.tb09 import tb09_potential

KTF = 0.8            # Thomas-Fermi screening wavevector of Kerker/dielectric


def realify_orbitals(psi):
    """Complex psi [nk, nb, nG] -> real U [nk, 2nb, 2nG]: each band
    contributes its two real partners (x; y) and (-y; x)."""
    x, y = psi.real, psi.imag
    return torch.cat([torch.cat([x, y], -1), torch.cat([-y, x], -1)], dim=1)


def _realified(X):
    """Complex bands [nk, nb, nG] -> rows [x; y]: [nk, nb, 2nG]."""
    return torch.cat([X.real, X.imag], dim=-1)


def _complex(U):
    """Rows [x; y] [nk, nb, 2nG] -> complex bands [nk, nb, nG]."""
    nG = U.shape[-1] // 2
    return torch.complex(U[..., :nG], U[..., nG:])


def _from_pairs(xy):
    """Realified [..., 2] -> complex [...] (a view where xy is contiguous)."""
    return torch.view_as_complex(xy.contiguous())


def _exact(precision, what):
    if precision not in (None, "highest"):
        raise NotImplementedError(
            f"{what}: precision {precision!r}; the port computes these transforms exactly "
            f"(the bf16 mode is the kernels' own, kernels/local_apply.py)")


def scatter_cube_split(xy, Gidx, mask, fft_size):
    """Split coefficients [nk, nb, nG, 2] -> cube [nk, nb, n1, n2, n3, 2]."""
    return torch.view_as_real(fftops.scatter_to_cube(_from_pairs(xy), Gidx, mask, fft_size))


def gather_cube_split(cube, Gidx, mask):
    """Split cube [nk, nb, n1, n2, n3, 2] -> coefficients [nk, nb, nG, 2]."""
    return torch.view_as_real(fftops.gather_from_cube(_from_pairs(cube), Gidx, mask))


def sphere_to_real_pruned(xy, pf: PrunedFFT, mask, precision=None):
    """coeffs [nk, nb, nG, 2] -> the unnormalised backward transform on the
    real-space grid in the reversed spatial layout [nk, nb, n3, n2, n1, 2]
    (the transpose of the reference's dft3(scatter_cube_split(...), +1))."""
    _exact(precision, "sphere_to_real_pruned")
    F1, F2, F3 = pf.factors.fwd
    x = sphere_to_compact(_from_pairs(xy) * mask[:, None, :], pf)      # [k, b, m1, m2, m3]
    x = torch.einsum("kbxyz,zc->kbcxy", x, F3)
    x = torch.einsum("kbcxy,yd->kbcdx", x, F2)
    return torch.view_as_real(torch.einsum("kbcdx,xa->kbcda", x, F1).contiguous())


def real_to_sphere_pruned(cube_rev, pf: PrunedFFT, mask, fft_size, precision=None):
    """Reversed-layout grid values [nk, nb, n3, n2, n1, 2] -> sphere coeffs
    [nk, nb, nG, 2] (the reference's gather(dft3(cube, -1)) / N; the 1/n_a
    ride in the backward factors)."""
    _exact(precision, "real_to_sphere_pruned")
    B1, B2, B3 = pf.factors.bwd
    x = torch.einsum("kbcda,ax->kbcdx", _from_pairs(cube_rev), B1)
    x = torch.einsum("kbcdx,dy->kbcxy", x, B2)
    x = torch.einsum("kbcxy,cz->kbxyz", x, B3)
    return torch.view_as_real(compact_to_sphere(x, pf, mask))


def _realify_matrix(C):
    """Complex C [..., m, n] -> the real [..., 2m, 2n] with x @ R the
    realified x @ C for rows x = (re, im) interleaved per entry (the
    reference's realified factor layout, kernels/dft_matmul.py:87-102)."""
    re, im = C.real, C.imag
    R = torch.stack([torch.stack([re, im], -1), torch.stack([-im, re], -1)], -3)
    return R.reshape(C.shape[:-2] + (2 * C.shape[-2], 2 * C.shape[-1]))


def build_sandwich(pf: PrunedFFT, V, precision=None):
    """Per-column sandwich matrices M(z, y) = F1 diag(V(., y, z)) B1 of the
    local apply: its middle (G3 m1 -> n1, the pointwise V, B1 n1 -> m1) as
    one [2 m1, 2 m1] real matrix per (z, y) column, so that

        out[.., z, y, :] = in[.., z, y, :] @ M[z, y]

    for the realified compact rows.  V [nspin, n1, n2, n3] real; returns M
    [nspin, n3, n2, 2 m1, 2 m1] (the reference's layout), built from the
    complex product in V's precision."""
    _exact(precision, "build_sandwich")
    F1, B1 = pf.factors.fwd[0], pf.factors.bwd[0]               # [m1, n1], [n1, m1]
    cdt = torch.complex128 if V.dtype == torch.float64 else torch.complex64
    S = torch.einsum("mx,sxyz,xp->szymp", F1.to(cdt), V.to(cdt), B1.to(cdt))
    return _realify_matrix(S)


def _sandwich_complex(M):
    """The complex [.., m1, m1] of a realified sandwich [.., 2 m1, 2 m1]."""
    m1 = M.shape[-1] // 2
    R = M.reshape(M.shape[:-2] + (m1, 2, m1, 2))
    return torch.complex(R[..., :, 0, :, 0], R[..., :, 0, :, 1])


def apply_local_sandwich(x, pf: PrunedFFT, M, kspin, precision=None):
    """The local-potential apply on compact cubes through the sandwich: x
    [nk, nb, m1, m2, m3, 2] -> the same shape, M from `build_sandwich`;
    kspin [nk] picks each k row's spin channel.  The chain is F3, F2, the
    sandwich per (z, y) column, then B2, B3: the n1-resolved cube never
    exists, and its largest intermediate is [nk, nb, n3, n2, m1]."""
    _exact(precision, "apply_local_sandwich")
    F2, F3 = pf.factors.fwd[1:]
    B2, B3 = pf.factors.bwd[1:]
    S = _sandwich_complex(M)[kspin]                           # [k, n3, n2, m1, m1]
    t = torch.einsum("kbxyz,zc->kbcxy", _from_pairs(x), F3)
    t = torch.einsum("kbcxy,yd->kbcdx", t, F2)                  # [k, b, n3, n2, m1]
    mid = torch.einsum("kbcdx,kcdxp->kbcdp", t, S)
    y = torch.einsum("kbcdp,dy->kbcpy", mid, B2)
    return torch.view_as_real(torch.einsum("kbcpy,cz->kbpyz", y, B3).contiguous())


class SplitTermsData(NamedTuple):
    """The basis' and terms' tensors in the SCF's dtype."""
    basis_data: BasisData
    terms: object             # ops.terms.Terms with its data in the SCF dtype
    pruned: PrunedFFT
    comm: Any = None          # parallel/mesh.py::KComm of a distributed basis


def prepare_split_data(basis, dtype=None):
    """basis.data (its Cartesian k+G among them, for meta-GGA),
    basis.terms (the NLCC core densities among them) and basis.pruned cast
    to the complex `dtype` (default: the basis' own) and its real
    counterpart.  Raises for the terms the JAX package's split path drops
    (module docstring)."""
    refuse_anyonic(basis.model, "the split SCF")
    refuse_terms(basis.model, "the split SCF", ["Magnetic", "LocalNonlinearity"],
                 "the JAX package's split data carry no vector potential and its split "
                 "potential no nonlinearity (dftk_tpu/ops/engine_split.py:736-781,"
                 "881-932); use self_consistent_field")
    dtype = basis.dtype if dtype is None else dtype
    if dtype == basis.dtype:
        return SplitTermsData(basis.data, basis.terms, basis.pruned, basis.comm)
    rdt = real_dtype(dtype)

    def cast(t):
        if t.is_complex():
            return t.to(dtype)
        return t.to(rdt) if t.is_floating_point() else t

    bd = BasisData(*[cast(t) for t in basis.data])
    td = basis.terms.data._replace(**{
        f: cast(getattr(basis.terms.data, f))
        for f in ("vloc_static", "hartree_coeffs", "P", "D", "Gsq_cart", "G_cart",
                  "rho_core", "tau_core", "exx_kernel", "kin")
        if getattr(basis.terms.data, f) is not None})
    pf = basis.pruned._replace(factors=LocalFactors(
        fwd=tuple(f.to(dtype) for f in basis.pruned.factors.fwd),
        bwd=tuple(f.to(dtype) for f in basis.pruned.factors.bwd)))
    return SplitTermsData(bd, dataclasses.replace(basis.terms, data=td), pf, basis.comm)


def make_split_ham(sd: SplitTermsData, V, Vtau=None):
    return hamops.build_ham(sd.basis_data, sd.terms.data, V, sd.pruned, Vtau=Vtau)


def default_ham(ham, base=None):
    """ham as the complex64 Ham of the bf16 ('default') sphere apply: the
    factors in complex64, the projectors rounded to bf16 once (as
    `place_compact` rounds them), every real tensor in float32.  base, an
    earlier result, supplies the part that does not depend on the
    potentials, so the split SCF rounds P once per run."""
    def f32(t):
        return None if t is None else t.to(torch.float32)

    if base is None:
        pf = ham.pruned
        base = ham._replace(
            kin=f32(ham.kin), mask=f32(ham.mask), D=f32(ham.D), Gpk=f32(ham.Gpk),
            P=round_bf16(ham.P.to(torch.complex64)),
            pruned=pf._replace(factors=LocalFactors(
                fwd=tuple(f.to(torch.complex64) for f in pf.factors.fwd),
                bwd=tuple(f.to(torch.complex64) for f in pf.factors.bwd))))
    return base._replace(V_zxy=f32(ham.V_zxy), Vtau_zxy=f32(ham.Vtau_zxy),
                         Gpk=f32(ham.Gpk) if base.Gpk is None else base.Gpk)


def _apply_chunked(fn, X, band_chunk):
    nb = X.shape[1]
    if band_chunk is None or band_chunk >= nb:
        return fn(X)
    return torch.cat([fn(X[:, i:i + band_chunk]) for i in range(0, nb, band_chunk)],
                     dim=1)


def apply_H_split(ham, U, fft_size, volume, band_chunk=None, precision=None):
    """H applied to realified orbitals U [nk, nb, 2nG] -> [nk, nb, 2nG] in
    U's dtype: an adapter over `ops/hamiltonian.apply_H` (fft_size and
    volume are implied by `ham`), the DivAgrad term included where ham
    carries Vtau.  precision None or "highest" is the exact apply in ham's
    dtype; "default" the bf16 one-pass apply on complex64 (`default_ham`).
    band_chunk bounds the bands applied at once."""
    apply = sphere_filter_ops(ham, ("highest" if precision is None else precision,),
                              band_chunk)[0]
    return _realified(apply(_complex(U))).to(U.dtype)


def sphere_filter_ops(ham, precisions, band_chunk=None, base=None):
    """[apply per precision]: H on the sphere, X [nk, nb, nG] complex ->
    H X, for the Chebyshev filter when it leaves the compact cube (a
    meta-GGA's Vtau, or compact_filter=False).  "highest" applies in ham's
    dtype; "default" is the bf16 one-pass apply on `default_ham(ham,
    base)`.  Each apply casts its input to its dtype and carries it as
    `apply.dtype`."""
    out = []
    for prec in precisions:
        if prec not in ("highest", "default"):
            raise NotImplementedError(
                f"filter precision {prec!r}: the port has 'highest' and 'default' "
                f"('tensor32' is a TPU workaround, ROADMAP 'Not to port')")
        h = ham if prec == "highest" else default_ham(ham, base)

        def apply(X, h=h, prec=prec):
            return _apply_chunked(lambda x: hamops.apply_H(h, x, prec),
                                  X.to(h.P.dtype), band_chunk)

        apply.dtype = h.P.dtype
        out.append(apply)
    return out


def compute_density_split(sd: SplitTermsData, U, occupation, fft_size, volume,
                          n_spin, band_chunk=None):
    """rho [nspin, n1, n2, n3] from realified orbitals U [nk, nb, 2nG] and
    occupations per band [nk, nb]."""
    X = _complex(U).to(sd.terms.data.P.dtype)
    return compute_density(sd.basis_data, X, occupation, fft_size, volume,
                           n_spin, band_chunk, comm=sd.comm)


def compute_tau_split(sd: SplitTermsData, U, occupation, fft_size, volume, n_spin,
                      band_chunk=None):
    """The kinetic-energy density tau [nspin, n1, n2, n3] =
    1/2 sum w f |grad psi|^2 from realified orbitals U [nk, nb, 2nG] and
    occupations per band [nk, nb]."""
    X = _complex(U).to(sd.terms.data.P.dtype)
    return compute_kinetic_energy_density(sd.basis_data, X, occupation, fft_size, volume,
                                          n_spin, band_chunk, comm=sd.comm)


def total_potential_split(terms, sd: SplitTermsData, rho, volume, tau=None):
    """Fused local potential V [nspin, grid] and the rho-dependent energies,
    with `terms`' functionals on the data of `sd`: (V, Vtau, energies), Vtau
    None unless tau is given (meta-GGA)."""
    return hamops.total_potential(dataclasses.replace(terms, data=sd.terms.data),
                                  rho, volume, tau=tau)


def _psi_energies(sd: SplitTermsData, X, occupation):
    ham = hamops.build_ham(sd.basis_data, sd.terms.data, None, sd.pruned)
    return hamops.psi_energies(ham, X, occupation, sd.basis_data.kweights, sd.comm)


def von_weizsaecker_tau_split(rho, G_cart):
    """tau_W = |grad rho|^2 / (8 rho), the meta-GGA SCF's first tau
    (`ops/density.py::von_weizsaecker_tau`)."""
    return von_weizsaecker_tau(rho, G_cart)


def tb09_potential_split(rho, G_cart, tau):
    """The mBJ potential [nspin, n1, n2, n3] with the cell-averaged
    parameter (`ops/xc/tb09.py::tb09_potential`)."""
    return tb09_potential(rho, G_cart.to(rho.dtype), tau)


def xc_energy_split(functionals, rho, G_cart, volume, scaling=1.0, tau=None):
    """XC energy with spectral gradients (`ops/hamiltonian.py::xc_energy`)."""
    return hamops.xc_energy(functionals, rho, volume, scaling, G_cart=G_cart, tau=tau)


def psi_energies_split(sd: SplitTermsData, U, occupation):
    """Kinetic and nonlocal energies from realified orbitals."""
    return _psi_energies(sd, _complex(U).to(sd.terms.data.P.dtype), occupation)


def kerker_mix_split(delta_F, Gsq, kTF=KTF):
    """Kerker preconditioner (total channel only), on torch.fft."""
    return KerkerMixing(kTF).mix_density(delta_F, Gsq)


def dielectric_mix(delta_F, eps_r, Gsq, kTF=KTF):
    """Model-dielectric preconditioner: the total channel screened by
    1 / eps(G) = (kTF^2 + G^2) / (eps_r kTF^2 + G^2) (`DielectricMixing`)."""
    return DielectricMixing(eps_r, kTF).mix_density(delta_F, Gsq)


def make_mix_step(mixer, m_hist):
    """The mixing update of the split SCF loop: preconditioner, Anderson
    acceleration over the last m_hist pairs (`scf/anderson.py`) and the
    residual norm,

        rho_new, drho = mix_step(rho, rho_out, damping, mix_param)

    The step holds its Anderson history itself: the reference carries it
    through the loop as fixed-shape arrays because jit needs static shapes."""
    anderson = AndersonAcceleration(m_hist)

    def mix_step(rho, rho_out, damping, mix_param):
        delta_F = rho_out - rho
        f = mixer(delta_F, mix_param) if mixer is not None else delta_F
        return anderson(rho, f, damping), torch.linalg.vector_norm(delta_F)

    return mix_step


class CompactPlacement(NamedTuple):
    """What a compact filter apply in one precision needs besides V."""
    dtype: torch.dtype        # the apply's data dtype
    factors: LocalFactors
    kin: torch.Tensor         # [nk, 1, m1, m2, m3] real
    mask: torch.Tensor        # [nk, 1, m1, m2, m3] real, 1 inside the sphere
    P: torch.Tensor           # [nk, Ncomp, nproj], rounded to bf16 at 'default'
    DT: torch.Tensor          # D^T [nproj, nproj]


def place_compact(ham, precisions):
    """{precision: CompactPlacement}: the kinetic, the sphere mask and the
    projectors placed on the compact cells once, in each precision's dtype.
    None of it depends on V, so the split SCF builds it once per run."""
    pf = ham.pruned
    nk, nG = ham.kin.shape
    cdt = pf.factors.fwd[0].dtype
    shape = (nk, 1) + pf.m_shape
    live = pf.inv_idx < nG                                  # [nk, Ncomp]

    def place(t):
        """Rows of t [nk, nG, ...] on the compact cells (zero outside)."""
        padded = torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
        idx = pf.inv_idx.reshape(pf.inv_idx.shape + (1,) * (t.dim() - 2))
        return torch.gather(padded, 1, idx.expand((-1, -1) + t.shape[2:]))

    kin_c = place(ham.kin) * live
    P_c = place(ham.P) * live[:, :, None]
    out = {}
    for prec in precisions:
        if prec not in ("highest", "default"):
            raise NotImplementedError(
                f"filter precision {prec!r}: the port has 'highest' and "
                f"'default' ('tensor32' is a TPU workaround, ROADMAP 'Not to port')")
        dt = torch.complex64 if prec == "default" else cdt
        rdt = real_dtype(dt)
        out[prec] = CompactPlacement(
            dtype=dt,
            factors=LocalFactors(fwd=tuple(f.to(dt) for f in pf.factors.fwd),
                                 bwd=tuple(f.to(dt) for f in pf.factors.bwd)),
            kin=kin_c.to(rdt).reshape(shape), mask=live.to(rdt).reshape(shape),
            P=round_bf16(P_c.to(dt)) if prec == "default" else P_c.to(dt),
            DT=ham.D.to(dt).T)
    return out


def compact_filter_ops(ham, volume, precision="highest", filter_precisions=None,
                       placement=None):
    """(enter, leave, apply_c) for a compact-cube-resident Chebyshev filter.

    A degree-d filter applies H d times to the same vectors, so they stay
    in the compact cube [nk, nb, m1, m2, m3] for the whole recurrence:
    `enter` gathers sphere -> cube once, `leave` gathers back once, and
    each `apply_c` is

        kin_c * x  +  local_apply(x)  +  P_c D P_c^dag x,   masked by mask_c

    with kin_c, P_c (the projectors placed on compact rows) and mask_c (the
    cells inside the sphere; the others are G-vectors outside it) from
    `place_compact` (pass its result as `placement` to reuse it across
    potentials), and local_apply the kernels A -> B -> A with no gather.

    precision: "highest" applies in ham's own dtype; "default" is the
    one-pass bf16 mode: complex64 data, the bf16 kernels, and the nonlocal
    GEMMs on operands rounded to bf16 (`_nl`/`_pdag_psi` at 'default' in
    the JAX package).  Each apply carries its data dtype as
    `apply_c.dtype`; `ops/eigen/chefsi.chebyshev_filter` casts the entered
    block to it once per filter.

    filter_precisions: a tuple of precisions; returns (enter, leave,
    [apply per precision]) over the one shared layout.

    The compact apply has no DivAgrad term: a meta-GGA Ham filters with
    `sphere_filter_ops`.
    """
    if ham.Vtau_zxy is not None:
        raise ValueError("compact_filter_ops: a meta-GGA Ham (Vtau) filters on the "
                         "sphere (sphere_filter_ops)")
    pf = ham.pruned
    precs = filter_precisions if filter_precisions is not None else (precision,)
    if placement is None:
        placement = place_compact(ham, precs)

    def enter(X):
        return sphere_to_compact(X, pf)

    def leave(xc):
        return compact_to_sphere(xc, pf, ham.mask)

    def make_apply(prec):
        pl = placement[prec]
        r = round_bf16 if prec == "default" else (lambda a: a)
        V = ham.V_zxy.to(real_dtype(pl.dtype))

        def apply_c(xc):
            out = local_apply(xc, V, pl.factors, precision=prec) + pl.kin * xc
            flat = xc.reshape(xc.shape[:2] + (-1,))
            DPd = (r(flat) @ pl.P.conj()) @ pl.DT               # [nk, nb, nproj]
            out = out + (r(DPd) @ pl.P.transpose(1, 2)).reshape(xc.shape)
            return out * pl.mask

        apply_c.dtype = pl.dtype
        return apply_c

    applies = [make_apply(p) for p in precs]
    return enter, leave, applies if filter_precisions is not None else applies[0]


def make_symmetrizer_split(basis, dtype=None):
    """The split API's density symmetrizer (reference
    `make_symmetrizer_split`): the complex `make_symmetrizer`, which works in
    the density's own dtype (dtype is taken for the reference's
    signature), or None where the basis has the identity only."""
    return make_symmetrizer(basis)


def _penn_eps_r(eigenvalues, n_electrons, filled, volume):
    """Penn-model eps_r ~ 1 + omega_p^2 / (mean direct gap)^2, clamped to
    the semiconductor range [2, 16] (from the first SCF spectrum)."""
    ev = np.sort(eigenvalues.cpu().numpy(), axis=1)
    n_occ = max(1, int(round(n_electrons / filled)))
    mean_gap = max(float(np.mean(ev[:, n_occ] - ev[:, n_occ - 1])), 1e-3)
    omega_p2 = 4 * math.pi * n_electrons / volume
    return float(np.clip(1 + omega_p2 / mean_gap ** 2, 2.0, 16.0))


@torch.no_grad()
def self_consistent_field_split(basis, tol=2e-5, maxiter=60, n_bands=None,
                                n_extra_bands=None, damping=0.8,
                                anderson_depth=10, eigensolver_maxiter=60,
                                diagtol_max=5e-3, diagtol_min=3e-5,
                                use_kerker=None, symmetrize=True, dtype=None, seed=42,
                                callback=None, is_converged="energy",
                                eigensolver="lobpcg", chebyshev_degree=10,
                                chefsi_cycles=1, mixing_eps_r=None,
                                band_chunk=None, filter_precision="mixed",
                                mesh=None, band_repr="complex", rho0=None,
                                U0=None, adaptive_bands=None, occupation_threshold=1e-6,
                                compact_filter=True, use_ace=True, stall_patience=None):
    """The split SCF loop (reference `self_consistent_field_split`), on
    complex tensors in `dtype` (complex128 or complex64; default the
    basis' dtype) on the basis' device.

    eigensolver: "lobpcg" (the port's complex LOBPCG) or "chefsi"
    (`chebyshev_degree`, `chefsi_cycles`; the cycle count deepens by 2, up
    to +4, when the density residual stalls over 3 iterations).

    filter_precision (CheFSI): "mixed" (default) runs bf16 filter cycles
    until the density residual first drops below 5e-3 and exact cycles
    from then on (a latch); "highest" runs every cycle exact (the SCF's
    dtype; None is the reference's spelling of it); "default" runs every
    cycle in bf16, so the result keeps the bf16 filter's residual floor.
    Rayleigh-Ritz and residuals are always exact.

    compact_filter: apply H on the compact cube inside the filter
    (`compact_filter_ops`); False, or a meta-GGA model, filters with the
    sphere apply (`sphere_filter_ops`, the DivAgrad term included).  A
    model with exact exchange or Hubbard filters with the exact sphere
    apply plus those terms, in every cycle.

    use_ace: exact exchange enters H as its ACE compression, built once per
    step from the orbitals and occupations that enter it (the aufbau
    occupations at the first step); False applies the bare operator.

    Meta-GGA models carry tau: the potential takes tau_in, tau_out comes
    from the new orbitals, and tau follows the orbitals without mixing
    (with rho in the best-iterate tracking), from the von Weizsaecker tau
    of the first density.

    symmetrize: symmetrize each output density over the basis' symmetries
    (`make_symmetrizer_split`; no-op for the identity alone).

    mixing_eps_r: a model-dielectric eps_r, "auto" (the Penn model from the
    first spectrum; also the default for insulators of 12 atoms or more),
    or None.  damping backs off (x0.7, floor 0.2) after two energy rises in
    a row.  rho0/U0 warm-start (U0 realified, [nk, nb, 2nG]).

    adaptive_bands (default: on at T > 0): while the top computed band is
    occupied above occupation_threshold on some k row, the block grows by
    max(3, nb / 8) random orthonormalised bands drawn from the run's
    generator; an iteration that grows cannot count as converged, and
    neither it nor its residual enters the best-iterate or stall tracking.

    stall_patience: exit with the best iterate (stalled=True) once the best
    density residual since the last depth boost or filter latch has not
    improved for this many iterations, unless the residual fell over the
    last three.

    is_converged: "density", "energy", or a callable of the iteration's
    info dict (E, drho, n_iter, and the iterate as partial_scfres: basis,
    complex psi, occupation, rho, tau), such as `scf/driver.py`'s
    ScfConvergence* criteria.

    mesh: a ("kpts"[, "bands"]) DeviceMesh (`parallel/mesh.py`); None takes
    the basis' own (`distribute`).  A basis not yet distributed is sharded
    over the mesh here, in place (its k-point count a multiple of the
    "kpts" axis: `pad_basis_kpoints` first).  Each rank iterates its own k
    rows; a "bands" axis splits every H apply and Chebyshev filter, and the
    band block is rounded up to a multiple of it.  The random start (and
    every band growth) is drawn at every k-point and sliced, so a mesh run
    equals the single-process run at the same seed.

    Returns a dict: energies, eigenvalues (numpy, sorted; every k-point),
    U (realified), rho, tau (None but for meta-GGA), epsF, converged,
    stalled, occupation, n_iter, history [(E, drho)], basis, runtime_s; U
    and occupation are this rank's k rows on a mesh.
    """
    t0 = time.time()
    model = basis.model
    if mesh is None:
        mesh = basis.mesh
    elif basis.mesh is None:
        shard_basis(basis, mesh)
    elif basis.mesh is not mesh:
        raise ValueError("self_consistent_field_split: the basis is distributed over "
                         "another mesh")
    comm = basis.comm
    if band_repr != "complex":
        raise NotImplementedError(
            f"band_repr={band_repr!r}: the realified band representations are "
            f"TPU workarounds the port does not carry (ROADMAP, 'Not to port')")
    if eigensolver not in ("lobpcg", "chefsi"):
        raise ValueError(f"eigensolver must be 'lobpcg' or 'chefsi', got {eigensolver!r}")
    if not callable(is_converged) and is_converged not in ("density", "energy"):
        raise ValueError(f"is_converged must be 'density', 'energy' or a callable, "
                         f"got {is_converged!r}")
    if filter_precision is None:
        filter_precision = "highest"
    if filter_precision not in ("mixed", "highest", "default"):
        raise NotImplementedError(
            f"filter_precision={filter_precision!r}: the port has 'mixed', "
            f"'highest' and 'default'; 'tensor32' is a TPU workaround (ROADMAP "
            f"'Not to port')")

    sd = prepare_split_data(basis, dtype)
    symmetrizer = make_symmetrizer_split(basis, dtype) if symmetrize else None
    bd = sd.basis_data
    cdt = sd.terms.data.P.dtype
    fft_size = basis.fft_size
    volume = model.unit_cell_volume
    nspin = model.n_spin_components
    dvol = basis.dvol
    device = basis.device

    if n_bands is None:
        n_bands = model.default_n_bands()
    if n_extra_bands is None:
        n_extra_bands = max(3, n_bands // 10)
    if adaptive_bands is None:
        # metals need the safety net: too few bands silently under-converge
        # the occupations; insulators keep a fixed window
        adaptive_bands = model.temperature > 0
    nbr = n_bands + n_extra_bands
    if comm is not None:       # an even split of the block over "bands"
        nbr = comm.round_bands(nbr)
    mask = bd.mask

    generator = torch.Generator(device=device).manual_seed(seed)

    def draw(n):
        """n random bands at every k-point, this rank's rows."""
        X = torch.randn((basis.n_kpoints, n, basis.nG_max), dtype=cdt, device=device,
                        generator=generator)
        return X if comm is None else comm.rows(X)

    if U0 is not None:
        X = _complex(torch.as_tensor(U0, device=device)).to(cdt)
        if comm is not None and X.shape[0] != mask.shape[0]:
            X = comm.rows(X)                  # every k-point given: this rank's rows
        if X.shape[1] < nbr:           # grow with random extra bands
            X = torch.cat([X, draw(nbr - X.shape[1])], dim=1)
        X = ortho_qr(X[:, :nbr] * mask[:, None, :])
    else:
        X = ortho_qr(draw(nbr) * mask[:, None, :])
    rho = (torch.as_tensor(rho0, device=device) if rho0 is not None
           else guess_density(basis)).to(bd.kin.dtype)

    filled = model.filled_occupation
    E_const = constant_energies(sd.terms)
    mixed = filter_precision == "mixed"
    # the filter's precisions: bf16 cycles, then exact ones, under "mixed"
    filter_precs = {"mixed": ("default", "highest"), "highest": ("highest",),
                    "default": ("default",)}[filter_precision]
    needs_tau = sd.terms.needs_tau
    # the filter leaves the compact cube for the sphere apply where H has
    # the DivAgrad term, or where the caller asks
    sphere_filter = needs_tau or not compact_filter
    placement = None         # the V-independent filter layout, built once
    td = sd.terms.data
    has_exx = td.exx_kernel is not None
    # the JAX package's split ACE jitter: complex64 needs a larger ridge
    ace_jitter = max(1e-12, 50 * torch.finfo(bd.kin.dtype).eps)
    hub = HubbardSetup(basis, bd) if sd.terms.hubbard_manifolds is not None else None
    # a kinetic blow-up stretches H's spectrum to max(kin) (1.95e6 Ha at
    # Si54, Ecut 10), over which no Chebyshev filter of a usable degree damps
    # anything: CheFSI then takes LOBPCG steps, whose preconditioner divides
    # the blow-up out, on the bf16 sphere apply in the bf16 cycles of
    # "mixed" (before its exact latch) and on the exact apply otherwise
    blown = eigensolver == "chefsi" and td.kin is not None

    def scf_step(rho_in, X_in, diagtol, n_cycles, n_exact, tau_in, occ_in):
        nonlocal placement
        V, Vtau, _ = hamops.total_potential(sd.terms, rho_in, volume, tau=tau_in)
        ham = make_split_ham(sd, V, Vtau)
        extra = []
        if has_exx:
            exx = hamops.make_exchange(bd, td, X_in, occ_in, filled, volume, comm)
            if use_ace:
                xi = build_ace(exx, ace_jitter)
                extra.append(lambda x: apply_ace(xi, x))
            else:
                extra.append(lambda x: hamops.apply_exchange(exx, x))
        if hub is not None:
            extra.append(hub.potential_apply(X_in, occ_in))

        def A(x):
            out = _apply_chunked(lambda y: hamops.apply_H(ham, y), x, band_chunk)
            for f in extra:
                out = out + f(x) * mask[:, None, :]
            return out

        if blown and mixed and n_exact == 0:
            # the bf16 cycles: LOBPCG on the bf16 apply, to its noise floor
            if placement is None:
                placement = default_ham(ham)
            apply_d = sphere_filter_ops(ham, ("default",), band_chunk, base=placement)[0]

            def A_d(x):
                out = apply_d(x).to(x.dtype)
                for f in extra:
                    out = out + f(x) * mask[:, None, :]
                return out

            res = lobpcg(A_d, X_in, ham.kin, mask, tol=max(diagtol, 1e-3),
                         maxiter=eigensolver_maxiter, n_conv=n_bands, comm=comm)
        elif eigensolver == "lobpcg" or blown:
            res = lobpcg(A, X_in, ham.kin, mask, tol=diagtol,
                         maxiter=eigensolver_maxiter, n_conv=n_bands, comm=comm)
        elif eigensolver == "chefsi" and extra:
            # every filter step on the exact sphere apply plus the extra terms
            res = chefsi_step(A, X_in, mask, degree=chebyshev_degree, n_conv=n_bands,
                              cycles=n_cycles, band_chunk=band_chunk, comm=comm)
        elif eigensolver == "chefsi" and sphere_filter:
            if placement is None and "default" in filter_precs:
                placement = default_ham(ham)
            applies = [A if p == "highest" else
                       sphere_filter_ops(ham, (p,), band_chunk, base=placement)[0]
                       for p in filter_precs]
            res = chefsi_step(A, X_in, mask, degree=chebyshev_degree, n_conv=n_bands,
                              cycles=n_cycles, apply_filter=applies[0],
                              apply_filter_last=applies[-1], n_exact_last=n_exact,
                              band_chunk=band_chunk, comm=comm)
        elif eigensolver == "chefsi":
            # compact-cube-resident filter: the sphere <-> cube placement
            # once per filter, not once per apply
            if placement is None:
                placement = place_compact(ham, filter_precs)
            enter, leave, applies = compact_filter_ops(
                ham, volume, filter_precisions=filter_precs, placement=placement)
            res = chefsi_step(A, X_in, mask, degree=chebyshev_degree, n_conv=n_bands,
                              cycles=n_cycles, apply_filter=applies[0],
                              apply_filter_last=applies[-1], n_exact_last=n_exact,
                              band_chunk=band_chunk, filter_wrap=(enter, leave), comm=comm)
        occ, epsF = compute_occupation(res.eigenvalues, bd.kweights, model.n_electrons,
                                       filled, model.temperature, model.smearing, comm)
        rho_out = compute_density(bd, res.X, occ, fft_size, volume, nspin, band_chunk,
                                  symmetrizer=symmetrizer, comm=comm)
        tau_out = None
        if needs_tau:
            tau_out = compute_kinetic_energy_density(bd, res.X, occ, fft_size, volume, nspin,
                                                     band_chunk, symmetrizer=symmetrizer,
                                                     comm=comm)
        _, _, energies = hamops.total_potential(sd.terms, rho_out, volume, tau=tau_out)
        energies.update(hamops.psi_energies(ham, res.X, occ, bd.kweights, comm))
        if has_exx:
            energies["ExactExchange"] = hamops.exchange_energy(
                hamops.make_exchange(bd, td, res.X, occ, filled, volume, comm), res.X, occ,
                bd.kweights, comm)
        if hub is not None:
            energies["Hubbard"] = hub.energy(res.X, occ)
        if sd.terms.has_entropy:
            energies["Entropy"] = entropy_energy(res.eigenvalues, bd.kweights, epsF,
                                                 model.temperature, model.smearing,
                                                 filled, comm)
        return rho_out, res.X, res.eigenvalues, occ, epsF, energies, tau_out

    if use_kerker is None:
        use_kerker = model.temperature > 0
    auto_eps = (mixing_eps_r == "auto"
                or (mixing_eps_r is None and not use_kerker and len(model.atoms) >= 12))
    if auto_eps:
        mixing_eps_r = 1.0   # placeholder until the first spectrum arrives
    Gsq = sd.terms.data.Gsq_cart
    if mixing_eps_r is not None:
        mixer = lambda delta_F, eps_r: dielectric_mix(delta_F, eps_r, Gsq)
    elif use_kerker:
        mixer = lambda delta_F, _p: kerker_mix_split(delta_F, Gsq)
    else:
        mixer = None
    mix_step = make_mix_step(mixer, anderson_depth)

    E_prev, converged, diagtol = None, False, diagtol_max
    history = []
    best_info, best_drho, best_X = None, np.inf, None
    stalled = False
    # stall reference: the best residual since the last accuracy-ceiling
    # event (depth boost, exact-filter latch), not the global best
    stall_best, stall_it = np.inf, -1
    damping_cur = float(damping)
    eps_r_cur = float(mixing_eps_r) if mixing_eps_r is not None else 0.0
    n_E_up = 0
    cycles_cur = chefsi_cycles
    mixed_exact_latch = False
    tau = von_weizsaecker_tau(rho, sd.terms.data.G_cart) if needs_tau else None
    # exchange and Hubbard take the occupations of the orbitals that enter
    # the step: the aufbau guess at the first
    occ_x = aufbau_occupation(basis, nbr).to(bd.kin.dtype) if has_exx or hub is not None \
        else None
    for it in range(maxiter):
        # CheFSI finisher: drho stalling across 3 iterations means the
        # filter depth is the accuracy ceiling -- deepen it
        if (eigensolver == "chefsi" and it >= 3 and cycles_cur < chefsi_cycles + 4):
            d3 = [h[1] for h in history[-3:]]
            if d3[2] > 0.7 * d3[0]:
                cycles_cur += 2
                stall_best, stall_it = np.inf, it
        # mixed filter: all-bf16 cycles while the residual is far out, all
        # exact from its first drop below 5e-3 on (a latch: alternating
        # filter qualities feeds Anderson residuals of two noise floors)
        if mixed:
            if history and history[-1][1] < 5e-3 and not mixed_exact_latch:
                mixed_exact_latch = True
                stall_best, stall_it = np.inf, it
            n_exact_cur = cycles_cur if mixed_exact_latch else 0
        else:
            n_exact_cur = 1
        rho_out, X, eigvals, occ, epsF, energies, tau_out = scf_step(
            rho, X, diagtol, cycles_cur, n_exact_cur, tau, occ_x)
        occ_x = occ
        if auto_eps and it == 0:
            eps_r_cur = _penn_eps_r(kgather(eigvals, comm), model.n_electrons, filled, volume)
        rho_mixed, drho_dev = mix_step(rho, rho_out, damping_cur, eps_r_cur)
        E_total = float(sum(float(v) for v in energies.values()) + sum(E_const.values()))
        drho = float(drho_dev) * math.sqrt(dvol)
        history.append((E_total, drho))
        if callback:
            callback(dict(n_iter=it + 1, E=E_total, drho=drho, damping=damping_cur,
                          eps_r=eps_r_cur))
        if callable(is_converged):
            # the iterate for criteria that evaluate it (ScfConvergenceForce)
            partial = types.SimpleNamespace(basis=basis, psi=X, occupation=occ, rho=rho_out,
                                            tau=tau_out)
            converged = bool(is_converged(dict(E=E_total, drho=drho, n_iter=it + 1,
                                               partial_scfres=partial)))
        elif is_converged == "density":
            converged = drho < tol
        else:
            converged = E_prev is not None and abs(E_total - E_prev) < tol
        # damping backoff: repeated energy increases signal overshooting
        if E_prev is not None and E_total > E_prev + 1e-10:
            n_E_up += 1
            if n_E_up >= 2:
                damping_cur = max(0.2, 0.7 * damping_cur)
                n_E_up = 0
        else:
            n_E_up = 0
        E_prev = E_total
        info = (rho_out, tau_out, eigvals, occ, epsF, energies)
        # AdaptiveBands (reference src/scf/nbands_algorithm.jl:20-90): an
        # occupied top band means the window is too small; a window that
        # small can reach a self-consistent but wrong state, so the growth
        # gates convergence too
        grew_bands = (adaptive_bands
                      and kmax(comm, occ[:, -1].max()) >= occupation_threshold)
        if grew_bands:
            converged = False
        # near the noise floor drho oscillates: keep the lowest-residual state
        if not grew_bands and (best_info is None or drho < best_drho):
            best_drho, best_info, best_X = drho, info, X
        if not grew_bands and drho < stall_best:
            stall_best, stall_it = drho, it
        if converged:
            break
        dlast3 = [h[1] for h in history[-3:]]
        descending = len(dlast3) == 3 and dlast3[2] < dlast3[1] < dlast3[0]
        if (stall_patience is not None and not grew_bands and not descending
                and it - stall_it >= stall_patience):
            stalled = True
            if callback:
                callback(dict(n_iter=it + 1, stalled_at_floor=stall_best))
            break
        rho = rho_mixed
        tau = tau_out            # tau follows the orbitals (no mixing)
        diagtol = min(diagtol, max(0.2 * drho, diagtol_min))
        if grew_bands:
            add = max(3, nbr // 8)
            if comm is not None:
                add = comm.round_bands(nbr + add) - nbr
            X = ortho_qr(torch.cat([X, draw(add) * mask[:, None, :]], dim=1))
            occ_x = torch.nn.functional.pad(occ_x, (0, add))   # grown bands start empty
            nbr, n_bands = nbr + add, n_bands + add
            stall_best, stall_it = np.inf, it
            if callback:
                callback(dict(n_iter=it + 1, adaptive_bands=nbr))

    if not converged and best_info is not None:
        info, X = best_info, best_X
    rho_out, tau_out, eigvals, occ, epsF, energies = info
    energies_out = {k: float(v) for k, v in energies.items()}
    energies_out.update(E_const)
    energies_out["total"] = float(sum(energies_out.values()))
    return dict(energies=energies_out,
                eigenvalues=np.sort(kgather(eigvals, comm).cpu().numpy(), axis=1),
                U=_realified(X), rho=rho_out, tau=tau_out, epsF=float(epsF),
                converged=converged, stalled=stalled, occupation=occ,
                n_iter=it + 1, history=history, basis=basis,
                runtime_s=time.time() - t0)
