"""Self-consistent response: the Dyson equation, the SCF Hessian and GMRES.

Port of `dftk_tpu/response/hessian.py` (reference
`src/response/hessian.jl`):
  * `gmres`: restarted GMRES with the Arnoldi loop on the host, and the
    inexact mode of the reference's inexact_gmres.jl (Simoncini-Szyld),
    which relaxes each matvec's tolerance as the outer residual shrinks;
  * `apply_kernel`: K drho = d(V_H + V_xc + V_nl)/drho . drho, exactly:
    the Hartree part is linear, the XC part the Hessian of the XC energy
    applied to drho (`ops/hamiltonian.py::xc_potential_derivative`), and a
    LocalNonlinearity's part the Hessian of its energy
    (`nonlinearity_potential_derivative`), as the JAX package's jvp of
    `total_potential` carries all three;
  * `solve_dyson` ((1 - chi0 K) drho = chi0 dV_ext by GMRES) and
    `compute_polarizability`;
  * `make_omega_plus_k`, `eigen_omega_plus_k`, `solve_omega_plus_k`: the
    SCF Jacobian Omega + K on the tangent space of the occupied orbitals,
    its lowest eigenvalues and its preconditioned CG solve.  K's density
    change is the linear 2 sum w f Re(conj(psi) dpsi)
    (`ops/density.py::compute_density_derivative`), and dV psi goes
    through the Hamiltonian's local apply (kernels A -> B -> A on a CUDA
    tensor), as every apply of H does.
The LDOS mixings also solve their model dielectric equation with `gmres`
(`scf/mixing.py`).
"""
import numpy as np
import torch

from ..ops import hamiltonian as hamops
from ..ops.density import compute_density, compute_density_derivative
from ..ops.terms import refuse_anyonic
from .chi0 import _project_out, apply_chi0, apply_dV, counts, make_chi0_context
from ..parallel.mesh import refuse_distributed


def apply_kernel(basis, rho0, drho):
    """K drho [nspin, grid]: the derivative of the Hartree + XC (+
    LocalNonlinearity) potential at rho0 along drho (reference
    terms/Hamiltonian.jl:127).  Functionals of rho alone: TB09 and the
    meta-GGAs raise."""
    terms = basis.terms
    vol = basis.model.unit_cell_volume
    drho_tot = torch.sum(drho, dim=0)
    dVH = torch.fft.ifftn(terms.data.hartree_coeffs * torch.fft.fftn(drho_tot)).real
    dV = dVH[None] + hamops.xc_potential_derivative(terms, rho0, drho, vol)
    if terms.local_nonlinearity is not None:
        dV = dV + hamops.nonlinearity_potential_derivative(terms, rho0, drho, vol)
    return dV


def solve_dyson(scfres, dV_ext, basis=None, tol=1e-7, maxiter=60, sternheimer_tol=1e-10,
                verbose=False, inexact=False):
    """The self-consistent drho for an external potential perturbation
    dV_ext [nspin, n1, n2, n3].  Returns (drho, dV_total).  inexact=True
    relaxes the Sternheimer tolerance per GMRES iteration (`gmres`)."""
    refuse_distributed(basis or scfres.basis, "solve_dyson")
    basis = basis or scfres.basis
    ctx = make_chi0_context(scfres, basis)
    rho0 = torch.as_tensor(scfres.rho, dtype=basis.rdtype, device=basis.device)

    def chi0(dv, t):
        return apply_chi0(ctx, basis, dv, tol=t)

    def kernel(dr):
        return apply_kernel(basis, rho0, dr)

    def matvec(drho, mtol=sternheimer_tol):
        return drho - chi0(kernel(drho), mtol)

    drho = gmres(matvec, chi0(dV_ext, sternheimer_tol), tol=tol, maxiter=maxiter,
                 verbose=verbose, inexact=inexact)
    return drho, dV_ext + kernel(drho)


def gmres(matvec, b, tol=1e-7, maxiter=60, restart=30, verbose=False, inexact=False,
          matvec_tol_bounds=(1e-12, 1e-5), safety=0.1):
    """Restarted GMRES: the matvecs on b's device, the Arnoldi loop on the
    host in b's precision (each matvec's result is copied back once).

    inexact=True is the reference's inexact GMRES (response/
    inexact_gmres.jl, after Simoncini-Szyld): each matvec gets the
    tolerance eta = safety tol / (relative residual), clipped to
    matvec_tol_bounds, so the early matvecs are tight and the later ones
    cheap; matvec then takes (v, eta)."""
    shape, device, dtype = b.shape, b.device, b.dtype
    bflat = b.detach().cpu().numpy().reshape(-1)
    bnorm = np.linalg.norm(bflat)
    if bnorm == 0:
        return torch.zeros_like(b)
    rel_resid = [1.0]

    def mv(v):
        v = torch.as_tensor(v.reshape(shape), device=device, dtype=dtype)
        if inexact:
            lo, hi = matvec_tol_bounds
            out = matvec(v, float(np.clip(safety * tol / max(rel_resid[0], tol), lo, hi)))
        else:
            out = matvec(v)
        return out.detach().cpu().numpy().reshape(-1)

    x = np.zeros_like(bflat)
    n_matvec = 0
    while n_matvec < maxiter:
        r = bflat - mv(x)
        n_matvec += 1
        beta = np.linalg.norm(r)
        if beta / bnorm < tol:
            break
        rel_resid[0] = beta / bnorm
        m = min(restart, maxiter - n_matvec)
        Q = [r / beta]
        H = np.zeros((m + 1, m), dtype=bflat.dtype)
        for j in range(m):
            w = mv(Q[j])
            n_matvec += 1
            for i in range(j + 1):
                H[i, j] = np.vdot(Q[i], w)
                w = w - H[i, j] * Q[i]
            H[j + 1, j] = np.linalg.norm(w)
            e1 = np.zeros(j + 2, dtype=bflat.dtype)
            e1[0] = beta
            y, *_ = np.linalg.lstsq(H[:j + 2, :j + 1], e1, rcond=None)
            resid = np.linalg.norm(H[:j + 2, :j + 1] @ y - e1)
            rel_resid[0] = resid / bnorm
            if verbose:
                print(f"  gmres it {n_matvec}: rel resid {resid / bnorm:.2e}")
            if resid / bnorm < tol or H[j + 1, j] < 1e-14:
                x = x + np.stack(Q[:j + 1], axis=1) @ y
                break
            Q.append(w / H[j + 1, j])
        else:
            x = x + np.stack(Q[:m], axis=1) @ y
            continue
        if resid / bnorm < tol:
            break
    return torch.as_tensor(x.reshape(shape), device=device, dtype=dtype)


def compute_polarizability(scfres, direction=2, basis=None, **kwargs):
    """The dipole polarizability alpha = d mu / d E of a molecule in a box:
    the self-consistent response to dV_ext = -E . r (a decoupled molecule
    in a large cell, measured from the cell's centre), alpha = integral of
    r drho / E along `direction`."""
    refuse_distributed(basis or scfres.basis, "compute_polarizability")
    basis = basis or scfres.basis
    model = basis.model
    axes = [np.arange(n) / n for n in basis.fft_size]
    r_cube = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
    r_cart = np.einsum("ab,xyzb->xyza", model.lattice, r_cube)
    center = model.lattice @ np.array([0.5, 0.5, 0.5])
    ra = basis.tensor(r_cart[..., direction] - center[direction])
    dV = ra.expand((model.n_spin_components,) + tuple(basis.fft_size))
    drho, _ = solve_dyson(scfres, -dV, basis=basis, **kwargs)
    return float(torch.sum(ra * torch.sum(drho, dim=0)) * basis.dvol)


def make_omega_plus_k(basis, psi, occupation, rho=None, include_K=True):
    """(OmegaK, Pc, M): the SCF Jacobian on the tangent space at psi [nk,
    n_occ, nG], the projector onto the occupied space's complement and the
    TPA preconditioner (reference hessian.jl apply_Omega, apply_K);
    include_K=False gives the bare Omega = P_c (H - eps_n) P_c."""
    refuse_distributed(basis, "make_omega_plus_k")
    model = basis.model
    refuse_anyonic(model, "the SCF Hessian")
    psi = torch.as_tensor(psi, device=basis.device, dtype=basis.dtype)
    occupation = torch.as_tensor(occupation, device=basis.device, dtype=basis.rdtype)
    if rho is None:
        rho = compute_density(basis.data, psi, occupation, basis.fft_size,
                              model.unit_cell_volume, model.n_spin_components)
    V0, _, _ = hamops.total_potential(basis.terms, rho, model.unit_cell_volume)
    ham0 = hamops.build_ham(basis.data, basis.terms.data, V0, basis.pruned)
    lam = torch.einsum("kng,kmg->knm", psi.conj(), hamops.apply_H(ham0, psi))
    return omega_plus_k_operators(basis, ham0, psi, occupation, rho,
                                  torch.diagonal(lam, dim1=-2, dim2=-1).real, include_K)


def omega_plus_k_operators(basis, ham, psi, occupation, rho, eps_n, include_K=True,
                           symmetrizer=None):
    """(OmegaK, Pc, M) of `make_omega_plus_k` from H at rho (`ham`) and the
    Rayleigh quotients eps_n [nk, n_occ] of psi; K's density change goes
    through `symmetrizer` where one is given (Newton's symmetrized
    functional)."""
    model = basis.model
    bd = basis.data

    def Pc(x):
        return _project_out(x, psi)

    def Kpart(dpsi):
        drho = compute_density_derivative(bd, psi, dpsi, occupation, basis.fft_size,
                                          model.unit_cell_volume, model.n_spin_components,
                                          symmetrizer=symmetrizer)
        return Pc(apply_dV(ham, psi, apply_kernel(basis, rho, drho), bd.kspin))

    def OmegaK(dpsi):
        d = Pc(dpsi)
        out = Pc(hamops.apply_H(ham, d) - eps_n[:, :, None] * d)
        return out + Kpart(d) if include_K else out

    kin = ham.kin
    mean_kin = torch.clamp(torch.einsum("kng,kg,kng->kn", psi.conj(), kin.to(psi.dtype),
                                        psi).real, min=1e-12)
    precond = mean_kin[:, :, None] / (mean_kin[:, :, None] + kin[:, None, :] + 1e-20)

    def M(x):
        return x * precond

    return OmegaK, Pc, M


def eigen_omega_plus_k(basis, psi, occupation, n_eigs=3, tol=1e-7, maxiter=200,
                       include_K=True, rho=None, seed=0):
    """The smallest eigenvalues of the SCF Jacobian Omega (+ K) on the
    tangent space (reference test/compute_jacobian_eigen.jl): block LOBPCG
    with the TPA preconditioner, the Rayleigh-Ritz steps on the host.  At
    a stable insulating ground state the spectrum is positive; the bare
    Omega's smallest eigenvalue is the HOMO-LUMO gap.  The random start
    comes from a torch.Generator on the basis' device seeded with `seed`.

    Returns (eigenvalues [n_eigs] numpy, eigenvectors: a list of n_eigs
    tensors [nk, n_occ, nG])."""
    refuse_distributed(basis, "eigen_omega_plus_k")
    A, Pc, M = make_omega_plus_k(basis, psi, occupation, rho=rho, include_K=include_K)
    generator = torch.Generator(device=basis.device).manual_seed(seed)
    m = n_eigs
    shp = tuple(psi.shape)
    mask = basis.data.mask[:, None, :]

    def rand_tangent():
        re, im = (torch.randn(shp, dtype=basis.rdtype, device=basis.device, generator=generator)
                  for _ in range(2))
        return Pc(torch.complex(re, im) * mask)

    def rr(S):
        """Rayleigh-Ritz on span(S): (theta, vectors)."""
        AS = [A(s) for s in S]
        Sf = torch.stack([s.reshape(-1) for s in S])
        ASf = torch.stack([a.reshape(-1) for a in AS])
        G = (Sf.conj() @ Sf.T).cpu().numpy()
        H = (Sf.conj() @ ASf.T).cpu().numpy()
        # whiten (dropping near-null directions), solve the projected problem
        w, U = np.linalg.eigh((G + G.conj().T) / 2)
        keep = w > 1e-10 * w.max()
        W = U[:, keep] / np.sqrt(w[keep])
        th, Y = np.linalg.eigh(W.conj().T @ ((H + H.conj().T) / 2) @ W)
        C = torch.as_tensor(W @ Y, device=basis.device, dtype=basis.dtype)
        vecs = (C.T @ Sf).reshape((C.shape[1],) + shp)
        return th, list(vecs)

    th, X = rr([rand_tangent() for _ in range(m)])
    th, X = th[:m], X[:m]
    P = []
    for _ in range(maxiter):
        R = [A(x) - float(t) * x for t, x in zip(th, X)]
        if max(float(torch.linalg.vector_norm(r)) for r in R) < tol:
            break
        th_all, vecs = rr(X + [Pc(M(r)) for r in R] + P)
        X, th, P = vecs[:m], th_all[:m], vecs[m:2 * m]
    return np.asarray(th[:m]), X


def solve_omega_plus_k(basis, psi, occupation, rhs, rho=None, cg_tol=1e-9, cg_maxiter=200):
    """Solve (Omega + K) dpsi = -P_c rhs for the orbital response
    (reference hessian.jl solve_OmegaplusK): psi [nk, n_occ, nG] the
    occupied orbitals of a converged insulator, rhs [nk, n_occ, nG] a
    perturbation applied to them (dH psi).  Returns dpsi orthogonal to the
    occupied space.  The CG reads its residual norm back once a step."""
    refuse_distributed(basis, "solve_omega_plus_k")
    OmegaK, Pc, M = make_omega_plus_k(basis, psi, occupation, rho=rho, include_K=True)
    return Pc(preconditioned_cg(OmegaK, M, -Pc(torch.as_tensor(rhs, device=basis.device,
                                                               dtype=basis.dtype)),
                                cg_tol, cg_maxiter))


def preconditioned_cg(A, M, b, tol, maxiter):
    """x with A x = b by CG preconditioned with M, from x = 0, until the
    residual norm is below tol or after maxiter steps (the Omega + K
    solves of `solve_omega_plus_k` and `scf/newton.py`)."""
    def dot(a, c):
        return torch.sum(a.conj() * c).real

    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = dot(r, z)
    for _ in range(maxiter):
        counts.host_reads += 1
        if not float(torch.linalg.vector_norm(r)) > tol:
            break
        counts.steps["omega_plus_k"] += 1
        Ap = A(p)
        alpha = rz / torch.clamp(dot(p, Ap), min=1e-300)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        p = z + (rz_new / torch.clamp(rz, min=1e-300)) * p
        rz = rz_new
    return x
