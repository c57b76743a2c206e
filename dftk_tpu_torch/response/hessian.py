"""Krylov solver of the response equations.

The port's own copy of `dftk_tpu/response/hessian.py::gmres`; the rest of
that module (Dyson equation, polarizability) comes with ROADMAP Queue 1
item 10.  The LDOS-based mixings solve their model dielectric equation
with it (`scf/mixing.py`).
"""
import numpy as np
import torch


def gmres(matvec, b, tol=1e-7, maxiter=60, restart=30):
    """Restarted GMRES: the matvecs on b's device, the Arnoldi loop on the
    host in float64 (each matvec's result is copied back once).  The JAX
    package's inexact mode, which relaxes a Sternheimer matvec's tolerance,
    comes with the response solvers."""
    shape, device, dtype = b.shape, b.device, b.dtype
    bflat = b.detach().cpu().numpy().reshape(-1)
    bnorm = np.linalg.norm(bflat)
    if bnorm == 0:
        return torch.zeros_like(b)

    def mv(v):
        out = matvec(torch.as_tensor(v.reshape(shape), device=device, dtype=dtype))
        return out.detach().cpu().numpy().reshape(-1)

    x = np.zeros_like(bflat)
    n_matvec = 0
    while n_matvec < maxiter:
        r = bflat - mv(x)
        n_matvec += 1
        beta = np.linalg.norm(r)
        if beta / bnorm < tol:
            break
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
