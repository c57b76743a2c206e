"""The ground-state solvers' convergence on a silicon cell (LDA with HGH
lda/si-q4, Gamma, Ecut 10, no symmetry): Si8, the conventional cubic
cell, or Si54, bench.py's 3^3 fcc supercell (chip_smoke.py's phase 4 and
m1 basis):

    python -m dftk_tpu_torch.tools.solver_floor [--device cuda|cpu]
        [--cell si8|si54] [--only potential] [--iters 40] [--seeds 42 ...]

runs the density-mixing LOBPCG SCF to 1e-10, then `scf_potential_mixing`
(tol 1e-9, --iters iterations; its history of energy, residual and step
length, once per seed of its random start), `direct_minimization` (tol
1e-11, at most 500 iterations), `newton` (tol 1e-10) and the SCF with
`Chi0Mixing` (tol 1e-8), printing each one's iterations, convergence,
wall seconds and energy against the first SCF's.  --only potential runs
potential mixing alone and measures its energy against Si54's E_ref
(tests/data/torch_port_si54.json) where the cell is Si54.  On the CPU
torch runs at two threads unless TORCH_THREADS says otherwise.
tests/data/make_torch_port_response.py's `si8_potential_mixing` entry runs
the JAX package's potential mixing on Si8.
"""
import argparse
import json
import os
import time

import numpy as np
import torch

A_SI = 5.131570667152971     # the fcc primitive cell's a / 2 (bohr)
SI54_REF = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "data",
                        "torch_port_si54.json")


def si8_basis(device):
    import dftk_tpu_torch as dt
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    base = [np.zeros(3), np.array([0, 0.5, 0.5]), np.array([0.5, 0, 0.5]),
            np.array([0.5, 0.5, 0])]
    model = dt.model_DFT(np.eye(3) * 2 * A_SI, [Si] * 8, base + [b + 0.25 for b in base],
                         functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    return dt.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1), device=device)


def potential_mixing_history(basis, iters, seed, E_ref=None):
    """scf_potential_mixing to 1e-9 for at most iters iterations from the
    random start of seed, printing each iteration's energy, residual and
    step length; returns the result."""
    from dftk_tpu_torch.scf.potential_mixing import scf_potential_mixing
    sync = torch.cuda.synchronize if basis.device.type == "cuda" else (lambda: None)
    t0 = time.time()
    res = scf_potential_mixing(basis, tol=1e-9, maxiter=iters, seed=seed, callback=lambda i: print(
        f"  seed {seed} it={i['n_iter']:3d} E={i['E']:.12f} dV={i['dV']:.3e} "
        f"alpha={i['alpha']:.3f}", flush=True))
    sync()
    wall = time.time() - t0
    dE = "" if E_ref is None else f", E - E_ref = {res.total_energy - E_ref:.3e}"
    print(f"potential mixing, seed {seed}: {res.n_iter} iterations, converged {res.converged}, "
          f"{wall:.1f} s, residual {res.history_Drho[-1]:.3e} (least "
          f"{min(res.history_Drho):.3e} at iteration "
          f"{int(np.argmin(res.history_Drho)) + 1}){dE}", flush=True)
    return res


def main(argv=None):
    import dftk_tpu_torch as dt
    from dftk_tpu_torch.scf.newton import newton
    from dftk_tpu_torch.tools.run_si_big import build_bench_basis
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--cell", default="si8", choices=("si8", "si54"))
    p.add_argument("--only", choices=("potential",))
    p.add_argument("--iters", type=int, default=40)
    p.add_argument("--seeds", type=int, nargs="+", default=[42])
    args = p.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(int(os.environ.get("TORCH_THREADS", "2")))
    basis = (si8_basis(args.device) if args.cell == "si8"
             else build_bench_basis(3, 10.0, args.device))
    print(basis, flush=True)
    if args.only == "potential":
        E_ref = None
        if args.cell == "si54":
            with open(SI54_REF) as f:
                E_ref = json.load(f)["total_energy"]
        for seed in args.seeds:
            potential_mixing_history(basis, args.iters, seed, E_ref)
        return
    ref = dt.self_consistent_field(basis, tol=1e-10)
    print(f"density mixing: {ref.n_iter} iterations, E = {ref.total_energy:.12f}", flush=True)
    for seed in args.seeds:
        potential_mixing_history(basis, args.iters, seed, ref.total_energy)
    runs = (("direct minimization", lambda: dt.direct_minimization(basis, tol=1e-11, maxiter=500)),
            ("newton", lambda: newton(basis, tol=1e-10)),
            ("Chi0Mixing", lambda: dt.self_consistent_field(basis, tol=1e-8,
                                                            mixing=dt.Chi0Mixing())))
    for name, run in runs:
        t0 = time.time()
        res = run()
        print(f"{name}: {res.n_iter} iterations, converged {res.converged}, "
              f"{time.time() - t0:.1f} s, E - E_SCF = {res.total_energy - ref.total_energy:.3e}",
              flush=True)


if __name__ == "__main__":
    main()
