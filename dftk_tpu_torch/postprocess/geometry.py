"""Geometry optimization on autodiff forces.

Port of `dftk_tpu/postprocess/geometry.py` (the reference's
GeometryOptimization.jl integration, DFTK ext/: `minimize_energy!`): relax
atomic positions (fixed cell) with scipy's L-BFGS-B on the host over the
total energy, gradient = -forces from `compute_forces`.  Each
energy/gradient evaluation is one SCF on the basis' device, warm-started
from the previous density (where its grid fits) and orbitals.
"""
import numpy as np


def optimize_geometry(model_builder, positions0, Ecut, kgrid=(1, 1, 1),
                      tol_force=1e-4, maxiter=30, scf_kwargs=None,
                      basis_kwargs=None, verbose=False, device="cuda"):
    """Relax fractional positions.  Returns dict(positions, energy, forces,
    scfres, converged, n_scf, trajectory).

    model_builder(positions) -> Model  (lattice and species fixed inside).
    tol_force: max |force| (Ha/bohr, Cartesian) termination criterion.
    device: where each basis is built (`PlaneWaveBasis`'s default, the
    CUDA card; basis_kwargs may name it too).
    """
    from scipy.optimize import minimize
    from ..basis import PlaneWaveBasis
    from ..scf.driver import self_consistent_field
    from .forces import compute_forces, compute_forces_cart

    scf_kwargs = dict(scf_kwargs or {})
    scf_kwargs.setdefault("tol", 1e-9)
    basis_kwargs = dict(basis_kwargs or {})
    basis_kwargs.setdefault("device", device)
    na = len(positions0)
    state = {"rho": None, "psi": None, "n_scf": 0, "last": None,
             "trajectory": []}

    def eval_at(x):
        positions = [np.asarray(p) for p in x.reshape(na, 3)]
        model = model_builder(positions)
        basis = PlaneWaveBasis(model, Ecut=Ecut, kgrid=kgrid, **basis_kwargs)
        kw = dict(scf_kwargs)
        if state["rho"] is not None and \
                tuple(state["rho"].shape[1:]) == basis.fft_size:
            kw["rho"] = state["rho"]
        if state["psi"] is not None:
            kw["psi"] = state["psi"]
        res = self_consistent_field(basis, **kw)
        state["rho"], state["psi"] = res.rho, res.psi
        state["n_scf"] += 1
        f_red = compute_forces(res).cpu().numpy()
        f_cart = compute_forces_cart(res).cpu().numpy()
        state["last"] = (positions, res, f_cart)
        state["trajectory"].append((res.energies["total"],
                                    float(np.abs(f_cart).max())))
        if verbose:
            print(f"  geoopt scf {state['n_scf']}: "
                  f"E={res.energies['total']:.8f} "
                  f"max|F|={np.abs(f_cart).max():.2e}")
        # dE/dx for fractional positions = -f_red
        return res.energies["total"], (-f_red).reshape(-1)

    x0 = np.stack([np.asarray(p, dtype=float) for p in positions0]).reshape(-1)
    result = minimize(eval_at, x0, jac=True, method="L-BFGS-B",
                      options=dict(maxiter=maxiter, ftol=1e-12, gtol=1e-12))
    positions, res, f_cart = state["last"]
    converged = float(np.abs(f_cart).max()) < tol_force
    return dict(positions=[np.mod(p, 1.0) for p in result.x.reshape(na, 3)],
                energy=res.energies["total"], forces=f_cart, scfres=res,
                converged=converged, n_scf=state["n_scf"],
                trajectory=state["trajectory"])
