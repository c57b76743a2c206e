"""Batched LOBPCG block eigensolver over all k-points at once.

Port of `dftk_tpu/ops/eigen/lobpcg.py` (the reference's `lobpcg_hyper`,
eigen/lobpcg_hyper_impl.jl).  All k-points iterate together as one batched
[nk, nb, nG] problem.  A Python loop replaces `lax.while_loop`; the
iteration, its robustness scheme and its exits are unchanged:

  * the [X | W | P] subspace is orthonormalised by canonical
    orthogonalisation (eigendecomposition of the Gram matrix with relative
    filtering); rank-deficient directions are deflated by a diagonal shift
    in the reduced Rayleigh-Ritz problem;
  * one H apply per iteration on the nb new directions (implicit product
    updates), or two at low precision where they drift;
  * soft locking of residuals at the noise floor, a no-progress exit, and
    the best iterate seen is returned.
"""
from typing import Callable, NamedTuple, Optional

import torch

from ...parallel.mesh import band_apply, kmax


class LobpcgResult(NamedTuple):
    X: torch.Tensor              # [nk, nb, nG] eigenvectors
    eigenvalues: torch.Tensor    # [nk, nb]
    residual_norms: torch.Tensor  # [nk, nb]
    n_iter: int
    n_matvec: int                # counts band-vectors applied
    converged: bool


def _inner(a, b):
    """<a_i | b_j> over the G axis: [nk, na, nG] x [nk, nb, nG] -> [nk, na, nb]."""
    return a.conj() @ b.transpose(-1, -2)


def _rotate(coeff, S):
    """X_j = sum_a coeff[a, j] S_a : [nk, na, nb] x [nk, na, nG] -> [nk, nb, nG]."""
    return coeff.transpose(-1, -2) @ S


def ortho_qr(X, passes=2):
    """Orthonormalise the rows of X (CholeskyQR2), falling back to canonical
    orthogonalisation of the block if a Cholesky factorisation fails."""
    meps = torch.finfo(X.real.dtype).eps
    eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    for _ in range(passes):
        O = _inner(X, X)
        eps = 10 * meps * torch.diagonal(O, dim1=-2, dim2=-1).real.sum(-1)
        L, info = torch.linalg.cholesky_ex(O + eps[:, None, None] * eye)
        # <X_a|X_b> = L L^H  =>  rows orthonormalise via conj(L)^-1 X
        Y = torch.linalg.solve_triangular(L.conj(), X, upper=False)
        if bool(info.any()) or bool(torch.isnan(Y).any()):
            Y = _ortho_canonical_rows(X)
        X = Y
    return X


def _ortho_canonical_rows(X):
    s, U = torch.linalg.eigh(_inner(X, X))
    good = s > 1e-10 * torch.clamp(s[..., -1:], min=1e-300)
    scale = torch.where(good, 1.0 / torch.sqrt(torch.where(good, s, 1.0)), 0.0)
    C = U * scale[:, None, :]
    return C.conj().transpose(-1, -2) @ X


def lobpcg(apply_A: Callable, X0, kin, mask, tol=1e-6, maxiter=100,
           n_conv: Optional[int] = None, comm=None):
    """Lowest-nb eigenpairs of the Hermitian operator apply_A.

    apply_A: [nk, nb, nG] -> [nk, nb, nG]
    X0:      [nk, nb, nG] initial guess (need not be orthonormal)
    kin:     [nk, nG] kinetic energies (TPA preconditioner diagonal)
    mask:    [nk, nG] 1/0 validity
    n_conv:  number of lowest bands whose residuals gate convergence
    comm:    `parallel/mesh.py::KComm` of a distributed basis: the rows are
             this rank's k rows, the stopping rules take the maximum over
             "kpts", and apply_A runs on this rank's band slice
    """
    apply_A = band_apply(apply_A, comm)
    nk, nb, nG = X0.shape
    if n_conv is None:
        n_conv = nb
    gram_eps = torch.finfo(X0.real.dtype).eps
    gram_rtol = 300 * gram_eps
    # implicit product updates drift too fast at f32: recompute A X there
    refresh_products = gram_eps > 1e-12

    def precond(X, R):
        # Teter-Payne-Allan: R_n * t_n / (t_n + kin), t_n = <X_n|kin|X_n>
        mean_kin = torch.sum((X.real ** 2 + X.imag ** 2) * kin[:, None, :], -1)
        mean_kin = torch.clamp(mean_kin, min=1e-12)[:, :, None]
        return R * (mean_kin / (mean_kin + kin[:, None, :] + 1e-20))

    def rayleigh_ritz(S, AS):
        s, U = torch.linalg.eigh(_inner(S, S))
        good = s > gram_rtol * torch.clamp(s[..., -1:], min=1e-300)
        scale = torch.where(good, 1.0 / torch.sqrt(torch.where(good, s, 1.0)), 0.0)
        C = U * scale[:, None, :]
        Ht = C.conj().transpose(-1, -2) @ _inner(S, AS) @ C
        # deflate rank-deficient directions (their rows/cols are zero) by a
        # diagonal shift just above the spectrum
        dmax = torch.diagonal(Ht, dim1=-2, dim2=-1).abs().amax(-1, keepdim=True)
        Ht = Ht + torch.diag_embed(torch.where(good, 0.0, 2 * dmax + 10.0)).to(Ht.dtype)
        Ht = (Ht + Ht.conj().transpose(-1, -2)) / 2
        theta, Y = torch.linalg.eigh(Ht)
        return theta[..., :nb], C @ Y[..., :nb]

    def project_out(Y, X):
        """Remove the X components of the rows of Y."""
        return Y - _rotate(_inner(X, Y), X)

    def row_normalize(Y):
        return Y / torch.clamp(torch.linalg.vector_norm(Y, dim=-1, keepdim=True), min=1e-30)

    def rayleigh(X, AX):
        return torch.sum(X.conj() * AX, -1).real

    X = ortho_qr(X0 * mask[:, None, :])
    AX = apply_A(X)
    lam = rayleigh(X, AX)
    P = torch.zeros_like(X)
    AP = torch.zeros_like(X)
    res = torch.full((nk, nb), float("inf"), dtype=lam.dtype, device=lam.device)
    it, nmv, stalled = 0, nk * nb, False
    best, no_improve = float("inf"), 0
    Xb, resb = X, res

    while (it < maxiter and (it < 1 or kmax(comm, res[:, :n_conv].max()) >= tol)
           and not stalled):
        if refresh_products:
            X = ortho_qr(X)
            AX = apply_A(X)
            lam = rayleigh(X, AX)
        R = AX - lam[:, :, None] * X
        res = torch.linalg.vector_norm(R, dim=-1)
        W = precond(X, R) * mask[:, None, :]
        # soft locking: residuals at the round-off floor carry no information
        noise_floor = torch.clamp(30 * gram_eps * (1.0 + lam.abs()), min=0.1 * tol)
        active = (res > noise_floor)[:, :, None]
        W = row_normalize(project_out(W * active, X)) * active
        AW = apply_A(W)
        # project P against X and W as a linear map, applying the same
        # combination to AP so that (P, AP) stay consistent
        cXP = _inner(X, P)
        P1 = P - _rotate(cXP, X)
        AP1 = AP - _rotate(cXP, AX)
        cWP = _inner(W, P1)
        P2 = P1 - _rotate(cWP, W)
        AP2 = AP1 - _rotate(cWP, AW)
        pn = torch.clamp(torch.linalg.vector_norm(P2, dim=-1, keepdim=True), min=1e-30)
        P, AP = P2 / pn, AP2 / pn

        S = torch.cat([X, W, P], dim=1)
        AS = torch.cat([AX, AW, AP], dim=1)
        lam_new, coeff = rayleigh_ritz(S, AS)
        coeff_p = coeff.clone()
        coeff_p[:, :nb, :] = 0          # new search directions: W/P part only

        # no-progress detection on the max residual of the gated bands
        cur, any_active, not_ok = kmax(comm, res[:, :n_conv].max(), active.any(),
                                       ~torch.isfinite(lam_new).all())
        if cur < best:
            Xb, resb = X, res
        no_improve = 0 if cur < 0.99 * best else no_improve + 1
        best = min(best, cur)
        ok = not not_ok
        stalled = (not any_active) or (not ok) or no_improve >= 6
        if ok:      # keep the previous iterate if the update went non-finite
            X, AX = _rotate(coeff, S), _rotate(coeff, AS)
            P, AP = _rotate(coeff_p, S), _rotate(coeff_p, AS)
            lam = lam_new
        it += 1
        nmv += nk * nb * (2 if refresh_products else 1)

    # return the best iterate seen, with exactly recomputed residuals
    res_last, res_best = kmax(comm, res[:, :n_conv].max(), resb[:, :n_conv].max())
    use_last = res_last <= res_best
    Xf = ortho_qr(X if use_last else Xb)
    AXf = apply_A(Xf)
    lamf = rayleigh(Xf, AXf)
    resf = torch.linalg.vector_norm(AXf - lamf[:, :, None] * Xf, dim=-1)
    return LobpcgResult(X=Xf, eigenvalues=lamf, residual_norms=resf,
                        n_iter=it, n_matvec=nmv + nk * nb,
                        converged=kmax(comm, resf[:, :n_conv].max()) < tol)
