"""Density-density response: chi0 applied through Sternheimer equations.

Port of `dftk_tpu/response/chi0.py` (reference `src/response/chi0.jl`):
  * `sternheimer_solver` (chi0.jl:115-283): for every occupied band the
    projected system P_c (H_k - eps_n) P_c dpsi_n = -P_c (dV psi_n), solved
    by one preconditioned CG batched over all (k, band) pairs; the computed
    unoccupied bands enter through the exact Schur complement of the
    projected operator (chi0.jl:136-227), and each band may stop at its own
    tolerance;
  * `apply_chi0` (chi0.jl:440-555): drho from dV, with the metallic terms at
    T > 0 (the occupation response with the Fermi-level shift that keeps
    the electron count, and the band pairs among partially occupied bands
    with the stable divided-difference coefficients, chi0.jl:284-310);
  * `balanced_band_tolerances` (chi0.jl:560-663, arxiv 2505.02319).

The JAX package's `lax.while_loop` is a Python loop here: each CG step
reads the residual norms back once to test for convergence (one host read
per step of an apply of H).  `counts` keeps the steps and the reads of the
response's CG loops (this module's and `response/hessian.py`'s Omega + K
solve).  Every apply of H, and the product dV psi itself, goes through
`ops/hamiltonian.py::apply_local`: kernels A -> B -> A on a CUDA tensor
(the pruned transforms give the full-cube product on the sphere); the
complex dV_q psi of the phonons at q (`apply_dV_q`) is two such applies.
"""
import math
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.local_apply import local_apply
from ..models.smearing import NoSmearing, occupation_divided_difference
from ..ops import hamiltonian as hamops
from ..ops.density import compute_density, compute_density_derivative
from ..ops.pruned import compact_to_sphere, sphere_to_compact
from ..ops.terms import refuse_anyonic
from ..parallel.mesh import refuse_distributed


class CGCounts:
    """The Sternheimer solves (one per chi0 apply: a GMRES matvec of the
    Dyson solve or of Chi0Mixing), the steps of the response CG loops, by
    loop, and the host reads of their residual norms."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.solves = 0
        self.steps = {"sternheimer": 0, "omega_plus_k": 0}
        self.host_reads = 0


counts = CGCounts()


def _project_out(x, psi):
    """x - sum_n |psi_n><psi_n|x_m> over the band axis of psi; zero rows
    of psi (masked bands) project onto nothing."""
    ov = torch.einsum("kng,kmg->knm", psi.conj(), x)
    return x - torch.einsum("knm,kng->kmg", ov, psi)


def _band_dots(a, b):
    """Re <a_kn|b_kn> [nk, nb]."""
    return torch.einsum("kng,kng->kn", a.conj(), b).real


def sternheimer_solver(apply_H, psi_occ, eps_occ, rhs, kin, mask, tol=1e-9, maxiter=200,
                       psi_extra=None, eps_extra=None, extra_mask=None, tol_bands=None):
    """Solve P_c (H - eps_n) P_c dpsi_n = -P_c rhs_n for all (k, n) at once.

    psi_occ [nk, no, nG]; eps_occ [nk, no]; rhs [nk, no, nG].  psi_extra
    [nk, ne, nG] (optional): computed unoccupied bands, whose subspace is
    inverted exactly from their Rayleigh quotients eps_extra (validity
    extra_mask) instead of by CG iterations.  tol_bands [nk, no] (optional)
    replaces the scalar tol per band.  Returns dpsi [nk, no, nG] orthogonal
    to the occupied space."""
    counts.solves += 1
    mask3 = mask[:, None, :]
    use_schur = psi_extra is not None and psi_extra.shape[1] > 0

    def Q(x):
        return _project_out(x, psi_occ) * mask3

    if use_schur:
        em = extra_mask if extra_mask is not None else torch.ones(
            psi_extra.shape[:2], dtype=torch.bool, device=psi_extra.device)
        psi_ex = psi_extra * em[:, :, None]
        H_psi_ex = apply_H(psi_ex) * em[:, :, None]
        # inv[k, m, n] = 1 / (eps_extra_m - eps_n) on the valid extra bands;
        # the Schur block is diagonal because the extra bands are Ritz vectors
        diff = eps_extra[:, :, None] - eps_occ[:, None, :]
        tiny = torch.full_like(diff, 1e-10)
        diff = torch.where(diff.abs() > 1e-10, diff, torch.where(diff >= 0, tiny, -tiny))
        inv = torch.where(em[:, :, None], 1.0 / diff, 0.0).to(psi_occ.dtype)

        def R(x):
            return _project_out(_project_out(x, psi_occ), psi_ex) * mask3

        def Hshift(x):
            return apply_H(x) - eps_occ[:, :, None] * x

        def A(x):
            y = R(x)
            s = torch.einsum("kmg,kng->kmn", H_psi_ex.conj(), y)
            return R(Hshift(y) - torch.einsum("kmg,kmn->kng", H_psi_ex, inv * s))

        b = -Q(rhs)
        sb = torch.einsum("kmg,kng->kmn", psi_ex.conj(), b)
        bb = R(b - torch.einsum("kmg,kmn->kng", H_psi_ex, inv * sb))
        proj = R
    else:
        def A(x):
            return Q(apply_H(x) - eps_occ[:, :, None] * x)

        b = -Q(rhs)
        bb = b
        proj = Q

    # TPA-style preconditioner, shifted per band
    mean_kin = torch.clamp(torch.einsum("kng,kg,kng->kn", psi_occ.conj(), kin.to(psi_occ.dtype),
                                        psi_occ).real, min=1e-12)
    precond = mean_kin[:, :, None] / (mean_kin[:, :, None] + kin[:, None, :] + 1e-20)

    def M(x):
        return proj(x * precond)

    tol_b = tol_bands if tol_bands is not None else torch.full_like(eps_occ, tol)
    x = torch.zeros_like(bb)
    r = bb
    z = M(r)
    p = z
    rz = _band_dots(r, z)
    for _ in range(maxiter):
        counts.host_reads += 1
        if not bool((torch.linalg.vector_norm(r, dim=-1) > tol_b).any()):
            break
        counts.steps["sternheimer"] += 1
        Ap = A(p)
        pAp = _band_dots(p, Ap)
        alpha = torch.where(pAp.abs() > 1e-30, rz / pAp, 0.0)[:, :, None]
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _band_dots(r, z)
        beta = torch.where(rz.abs() > 1e-30, rz_new / rz, 0.0)[:, :, None]
        p = z + beta * p
        rz = rz_new
    dpsiR = proj(x)

    if use_schur:
        # the extra-band component:
        # alpha[m, n] = inv[m, n] <psi_ex_m | (b - (H - eps_n) dpsiR)_n>
        s = torch.einsum("kmg,kng->kmn", psi_ex.conj(), b - Hshift(dpsiR))
        return (dpsiR + torch.einsum("kmg,kmn->kng", psi_ex, inv * s)) * mask3
    return dpsiR


def balanced_band_tolerances(basis, occ_w, occ_mask, density_tol, tol_min=1e-14, tol_max=1e-2):
    """BandtolBalanced (reference chi0.jl:588-663):
    tol_n = density_tol Omega / (sqrt(Ng) Nocc_k 2 f_n Nk w_k), clamped;
    occ_w [nk, nb] the occupations (0 where masked)."""
    vol = basis.model.unit_cell_volume
    Ng = float(np.prod(basis.fft_size))
    nk = basis.n_kpoints
    w = basis.data.kweights[:, None]
    nocc_k = torch.clamp(occ_mask.sum(dim=1, keepdim=True), min=1).to(occ_w.dtype)
    fac = vol / (math.sqrt(Ng) * nocc_k * 2.0 * torch.clamp(occ_w, min=1e-8) * nk * w)
    tols = torch.clamp(density_tol * fac, tol_min, tol_max)
    return torch.where(occ_mask, tols, tol_max)


class Chi0Context(NamedTuple):
    """The fixed SCF state chi0 is applied at."""
    ham: hamops.Ham
    psi: torch.Tensor           # [nk, nb, nG]
    occupation: torch.Tensor    # [nk, nb]
    eigenvalues: torch.Tensor   # [nk, nb]
    epsF: torch.Tensor          # 0-d


def make_chi0_context(scfres, basis=None):
    """The Chi0Context of an SCF result (or of any state with psi, rho,
    occupation, eigenvalues and epsF, numpy or tensors): H at its density,
    its orbitals, occupations, eigenvalues and Fermi level on the basis'
    device."""
    refuse_distributed(basis or scfres.basis, "make_chi0_context")
    basis = basis or scfres.basis
    refuse_anyonic(basis.model, "the response")

    def real(a):
        return torch.as_tensor(a, dtype=basis.rdtype, device=basis.device)

    V, _, _ = hamops.total_potential(basis.terms, real(scfres.rho), basis.model.unit_cell_volume)
    return Chi0Context(ham=hamops.build_ham(basis.data, basis.terms.data, V, basis.pruned),
                       psi=torch.as_tensor(scfres.psi, dtype=basis.dtype, device=basis.device),
                       occupation=real(scfres.occupation), eigenvalues=real(scfres.eigenvalues),
                       epsF=real(float(scfres.epsF)))


def apply_dV(ham, psi, delta_V, kspin):
    """dV psi on the sphere for a local potential dV [nspin, n1, n2, n3]
    (each k row takes its spin's channel), through the Hamiltonian's local
    apply (kernels A -> B -> A on a CUDA tensor)."""
    return hamops.apply_local(ham, psi, V_zxy=hamops.to_zxy(delta_V.to(psi.real.dtype), kspin))


def apply_dV_q(ham, psi, dv, kspin, perm, phase):
    """(e^{2 pi i q.x} dv) psi_k on the sphere of each row's k+q partner
    k_perm = k + q - G0, for psi [nk, nb, nG] on the k spheres, dv [nspin,
    n1, n2, n3] complex (the periodic part at +q; each k row takes its
    spin's channel), perm [nk] int64 and phase [nk, n1, n2, n3] = e^{2 pi i
    G0_k.x}.  Kernel B takes a real potential, so the sector phase is folded
    into V'_k = dv e^{2 pi i G0_k.x}, and Re V' and Im V' are applied to the
    same compact cube as two local applies (kernels A -> B -> A on a CUDA
    tensor); the result is gathered on k_perm's sphere.  The compact cube
    holds the occupied indices of every k-point, so the k+q spheres of an
    unfolded basis lie inside it, and the phase is integral on the grid:
    the product is the full-cube one."""
    Vq = (dv[kspin] * phase).permute(0, 3, 1, 2)
    xc = sphere_to_compact(psi, ham.pruned)
    y_re = local_apply(xc, Vq.real.contiguous(), ham.pruned.factors)
    y_im = local_apply(xc, Vq.imag.contiguous(), ham.pruned.factors)
    pq = ham.pruned._replace(Gidx_c=ham.pruned.Gidx_c[perm])
    return compact_to_sphere(y_re + 1j * y_im, pq, ham.mask[perm])


def apply_chi0(ctx: Chi0Context, basis, delta_V, tol=1e-9, occupation_threshold=1e-8,
               use_schur=True, density_tol=None):
    """drho = chi0 dV, the adiabatic density response to delta_V [nspin, n1,
    n2, n3] (real); drho of the same shape.  T > 0 adds the occupation and
    Fermi-level response and the divided-difference band pairs.  use_schur
    takes the computed unoccupied bands as an exact Schur complement in
    the Sternheimer solve; density_tol switches to per-band balanced
    tolerances aiming at that density accuracy."""
    refuse_distributed(basis, "apply_chi0")
    dVpsi = apply_dV(ctx.ham, ctx.psi, delta_V, basis.data.kspin)
    return apply_chi0_generic(ctx, basis, dVpsi, tol=tol,
                              occupation_threshold=occupation_threshold,
                              use_schur=use_schur, density_tol=density_tol)


def apply_chi0_generic(ctx: Chi0Context, basis, dVpsi, tol=1e-9, occupation_threshold=1e-8,
                       use_schur=True, density_tol=None, with_detail=False):
    """chi0 response to a general Hermitian perturbation given as dVpsi =
    dH psi [nk, nb, nG].  Returns drho; with_detail=True returns (drho,
    dpsi, df, depsF) (the second derivatives of metals need them)."""
    refuse_distributed(basis, "apply_chi0_generic")
    model = basis.model
    bd = basis.data
    fft_size = basis.fft_size
    vol = model.unit_cell_volume
    nspin = model.n_spin_components
    filled = model.filled_occupation
    T = model.temperature

    psi, occ, eps = ctx.psi, ctx.occupation, ctx.eigenvalues
    nb = psi.shape[1]

    # "occupied": the bands whose response is solved (f > threshold); the
    # other computed bands are the Schur/deflation space
    occ_mask = occ > occupation_threshold
    occ_w = torch.where(occ_mask, occ, 0.0)
    m3 = occ_mask[:, :, None]
    extra_mask = ~occ_mask
    tol_bands = None
    if density_tol is not None:
        tol_bands = balanced_band_tolerances(basis, occ_w, occ_mask, density_tol)

    dpsi = sternheimer_solver(
        lambda p: hamops.apply_H(ctx.ham, p), psi * m3, eps, dVpsi * m3, ctx.ham.kin, bd.mask,
        tol=tol, psi_extra=psi * extra_mask[:, :, None] if use_schur else None,
        eps_extra=eps if use_schur else None, extra_mask=extra_mask if use_schur else None,
        tol_bands=tol_bands) * m3

    # band pairs among partially occupied bands (metals, reference
    # chi0.jl:399-412): the projector removes their response; it comes back
    # with the stable alpha_mn coefficients
    smearing = model.smearing
    if T > 0 and smearing is not None and not isinstance(smearing, NoSmearing):
        em = eps[:, :, None].expand(-1, -1, nb)
        en = eps[:, None, :].expand(-1, nb, -1)
        ratio = occupation_divided_difference(smearing, em, en, ctx.epsF, T) * filled
        fm, fn = occ[:, :, None], occ[:, None, :]
        alpha = ratio * fn / torch.clamp(fn ** 2 + fm ** 2, min=1e-30)
        eye = torch.eye(nb, dtype=torch.bool, device=occ.device)
        pair_mask = occ_mask[:, :, None] & occ_mask[:, None, :] & ~eye[None]
        alpha = torch.where(pair_mask, alpha, 0.0)
        dots = torch.einsum("kmg,kng->kmn", psi.conj(), dVpsi)
        dpsi = dpsi + torch.einsum("kmn,kmg->kng", alpha.to(dots.dtype) * dots, psi) * m3

    # drho from the orbital response: sum 2 w f Re(conj(psi) dpsi)(r)
    drho = compute_density_derivative(bd, psi, dpsi, occ_w, fft_size, vol, nspin)

    # occupation response of metals, with the Fermi-level shift that keeps
    # the electron count: sum_kn w filled f' (dV_nn - depsF) = 0
    df = torch.zeros_like(occ)
    depsF = torch.zeros((), dtype=occ.dtype, device=occ.device)
    if T > 0:
        fprime = smearing.occupation_derivative((eps - ctx.epsF) / T) / T
        dVnn = _band_dots(psi, dVpsi)
        wf = bd.kweights[:, None] * filled * fprime
        den, num = wf.sum(), (wf * dVnn).sum()
        depsF = torch.where(den.abs() > 1e-14, num / den, 0.0)
        df = filled * fprime * (dVnn - depsF)
        drho = drho + compute_density(bd, psi, df, fft_size, vol, nspin)
    if with_detail:
        return drho, dpsi, df, depsF
    return drho
