"""Si-N supercell Gamma-point SCF on one CUDA card: the split CheFSI SCF.

Port of `tools/run_si_big.py` (the north-star configuration family of
BASELINE.json; Si256 is `4 4 2 10.0`).  One process on the card: the
split SCF in complex128 with the "mixed" Chebyshev filter (bf16 cycles,
then exact ones) to a density tolerance, then `refine_split_energy`, the
energy of the returned state evaluated on the same card.  The JAX package
needs a second, CPU float64 process for that refine; the port does not.

    python -m dftk_tpu_torch.tools.run_si_big [cells_x cells_y cells_z] [Ecut]

Environment (defaults in brackets): DFTK_FILTER_PRECISION [mixed],
DFTK_CHEB_DEGREE [10], DFTK_CHEB_CYCLES [2], DFTK_MAXITER [40],
DFTK_TOL_DRHO [2e-6], DFTK_STALL_PATIENCE [8; 0 disables the stall exit,
a negative value is an error].
"""
import os
import sys
import time

import numpy as np
import torch

A_CONV = 10.263141334305942       # conventional cubic Si lattice (bohr)
A_PRIM = A_CONV / 2               # fcc primitive lattice parameter
CONV_POSITIONS = [[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5],
                  [.25, .25, .25], [.75, .75, .25], [.75, .25, .75], [.25, .75, .75]]
BAND_CHUNK = 256


def build_basis(cells=(2, 2, 2), Ecut=10.0, device="cuda"):
    """The Si supercell of `cells` conventional cubic cells (LDA, HGH
    lda/si-q4, Gamma, no symmetry)."""
    import dftk_tpu_torch as dt
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    sc = dt.create_supercell(np.eye(3) * A_CONV, [Si] * 8,
                             [np.array(p, dtype=float) for p in CONV_POSITIONS], cells)
    model = dt.model_DFT(sc["lattice"], sc["atoms"], sc["positions"],
                         functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    return dt.PlaneWaveBasis(model, Ecut=Ecut, kgrid=(1, 1, 1), device=device)


def build_bench_basis(n_rep=3, Ecut=10.0, device="cuda"):
    """The Si supercell of bench.py::build_problem: n_rep^3 fcc primitive
    cells (Si54 at n_rep 3), Gamma point, LDA, HGH lda/si-q4, no symmetry."""
    import dftk_tpu_torch as dt
    lattice = np.array([[0.0, A_PRIM, A_PRIM], [A_PRIM, 0.0, A_PRIM],
                        [A_PRIM, A_PRIM, 0.0]]) * n_rep
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    base = [np.ones(3) / 8, -np.ones(3) / 8]
    positions = [(b + np.array([i, j, k])) / n_rep for i in range(n_rep)
                 for j in range(n_rep) for k in range(n_rep) for b in base]
    model = dt.model_DFT(lattice, [Si] * len(positions), positions,
                         functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    return dt.PlaneWaveBasis(model, Ecut=Ecut, kgrid=(1, 1, 1), device=device)


def scf_options(environ):
    """The SCF's settings from the environment (see the module docstring)."""
    patience = int(environ.get("DFTK_STALL_PATIENCE", "8"))
    if patience < 0:
        raise ValueError(f"DFTK_STALL_PATIENCE must be >= 0 (0 disables the "
                         f"stall exit), got {patience}")
    return dict(filter_precision=environ.get("DFTK_FILTER_PRECISION") or "mixed",
                chebyshev_degree=int(environ.get("DFTK_CHEB_DEGREE", "10")),
                chefsi_cycles=int(environ.get("DFTK_CHEB_CYCLES", "2")),
                maxiter=int(environ.get("DFTK_MAXITER", "40")),
                tol=float(environ.get("DFTK_TOL_DRHO", "2e-6")),
                stall_patience=patience or None)


def n_bands_of(natoms):
    """(occupied, total) bands: 2 per Si atom, plus max(8, natoms/4) extra."""
    return natoms * 2, natoms * 2 + max(8, natoms // 4)


def main(argv=None):
    from dftk_tpu_torch import refine_split_energy, self_consistent_field_split
    argv = sys.argv[1:] if argv is None else argv
    cells = tuple(int(x) for x in argv[:3]) if len(argv) > 2 else (2, 2, 2)
    Ecut = float(argv[3]) if len(argv) > 3 else 10.0
    opts = scf_options(os.environ)

    t0 = time.time()
    basis = build_basis(cells, Ecut)
    natoms = len(basis.model.atoms)
    print(f"Si{natoms}: {natoms * 4} electrons, cells={cells}, Ecut={Ecut}, "
          f"device={torch.cuda.get_device_name(basis.device)}", flush=True)
    print(f"basis: fft={basis.fft_size} nG={basis.nG_max} "
          f"compact={basis.pruned.m_shape} (setup {time.time() - t0:.0f}s)", flush=True)

    def show(i):
        if "E" in i:
            print(f"  it={i['n_iter']} E={i['E']:.6f} drho={i['drho']:.2e} "
                  f"[{time.time() - t0:.0f}s]", flush=True)
        else:
            print(f"  it={i['n_iter']} {dict(list(i.items())[1:])} "
                  f"[{time.time() - t0:.0f}s]", flush=True)

    n_occ, nb = n_bands_of(natoms)
    torch.cuda.reset_peak_memory_stats(basis.device)
    res = self_consistent_field_split(
        basis, n_bands=n_occ, n_extra_bands=nb - n_occ, eigensolver="chefsi",
        band_chunk=BAND_CHUNK, is_converged="density", callback=show, **opts)
    torch.cuda.synchronize(basis.device)
    E = res["energies"]["total"]
    print(f"FINAL Si{natoms}: E = {E:.6f} Ha ({E / natoms:.6f} Ha/atom), "
          f"converged={res['converged']}, wall = {time.time() - t0:.0f}s", flush=True)

    t1 = time.time()
    E = refine_split_energy(basis, res, band_chunk=BAND_CHUNK)["total"]
    torch.cuda.synchronize(basis.device)
    print(f"REFINED Si{natoms}: E = {E:.10f} Ha ({E / natoms:.10f} Ha/atom)", flush=True)
    print(f"refinement wall: {time.time() - t1:.0f}s; peak device memory "
          f"{torch.cuda.max_memory_allocated(basis.device) / 2 ** 30:.1f} GiB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
