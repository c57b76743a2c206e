#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dftk_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. check that a CUDA device exists; print the card's name and power limit
  2. build the hand-written CUDA kernels from dftk_tpu_torch/csrc
  3. hold each kernel, and the composed local apply, against its plain
     PyTorch version at the Si54 shapes (compact cube 32^3, grid 64^3,
     128 bands, Gamma) in complex128 (bar 1e-11 of max|out|) and complex64
     (bar 1e-5); time kernel, plain version and a torch.fft local apply
     with CUDA events
  4. run self_consistent_field in float64 on the GPU on the bench.py Si54
     problem (LDA, HGH lda/si-q4, Ecut 10, Gamma, no symmetry) to a density
     tolerance of 1e-8, and require convergence, |E - E_ref| < 1e-7 Ha
     against the JAX package's CPU float64 energy
     (tests/data/torch_port_si54.json), kernel launches > 0 and no call of a
     plain version on the way
  5. print the kernels' JSON line, then the result line.
This script imports neither jax nor the JAX package.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
A_SI = 5.131570667152971
N_BANDS_KERNEL = 128
E_TOL = 1e-7
BARS = {"complex128": 1e-11, "complex64": 1e-5}
SOURCES = {
    "pruned_axis_dft": ("dftk_tpu_torch/csrc/pruned_axis_dft.cu",
                        "dftk_tpu/kernels/fused_local.py:138"),
    "local_plane": ("dftk_tpu_torch/csrc/local_plane.cu",
                    "dftk_tpu/kernels/fused_filter.py:190"),
}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def si_supercell(dt, device, n_rep=3, Ecut=10.0):
    """The Si supercell of bench.py::build_problem, Gamma point."""
    lattice = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]]) * n_rep
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    base = [np.ones(3) / 8, -np.ones(3) / 8]
    positions = [(b + np.array([i, j, k])) / n_rep for i in range(n_rep)
                 for j in range(n_rep) for k in range(n_rep) for b in base]
    model = dt.model_DFT(lattice, [Si] * len(positions), positions,
                         functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    return dt.PlaneWaveBasis(model, Ecut=Ecut, kgrid=(1, 1, 1), device=device)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def fft_local_apply(xc, V_full, live, grid_idx, fft_size):
    """The same operator through torch.fft on the full grid (comparison):
    the live compact cells `live` sit at the flat grid points `grid_idx`."""
    import torch
    nk, nb = xc.shape[:2]
    N = int(np.prod(fft_size))
    full = torch.zeros((nk, nb, N), dtype=xc.dtype, device=xc.device)
    full[:, :, grid_idx] = xc.reshape(nk, nb, -1)[:, :, live]
    psir = torch.fft.ifftn(full.reshape((nk, nb) + fft_size), dim=(-3, -2, -1)) * N
    back = torch.fft.fftn(psir * V_full[:, None], dim=(-3, -2, -1)) / N
    out = torch.zeros_like(xc).reshape(nk, nb, -1)
    out[:, :, live] = back.reshape(nk, nb, N)[:, :, grid_idx]
    return out.reshape(xc.shape)


def kernel_phase(la, basis, device):
    """Phase 3: kernels vs plain versions at the main path's shapes."""
    import torch
    pf = basis.pruned
    m, n = pf.m_shape, basis.fft_size
    print(f"[3] shapes: compact cube m={m}, grid n={n}, bands={N_BANDS_KERNEL}, "
          f"k-points={basis.n_kpoints}", flush=True)
    # compact cells that hold an occupied frequency on every axis (the pad
    # cells of ops/pruned.py do not); inputs are zero elsewhere so that the
    # torch.fft comparison sees the same data
    sels = [np.unique(np.unravel_index(basis.Gidx_np, n)[a]) for a in range(3)]
    live3 = np.zeros(m, dtype=bool)
    live3[:len(sels[0]), :len(sels[1]), :len(sels[2])] = True
    grid = (sels[0][:, None, None] * n[1] + sels[1][None, :, None]) * n[2] \
        + sels[2][None, None, :]
    live = torch.as_tensor(np.flatnonzero(live3), device=device)
    grid_idx = torch.as_tensor(grid.ravel(), device=device)

    rng = np.random.default_rng(20261016)
    shape = (basis.n_kpoints, N_BANDS_KERNEL) + m
    xc_np = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * live3
    V_np = rng.normal(size=(basis.n_kpoints, n[2], n[0], n[1]))
    results = {}
    for dtype in (torch.complex128, torch.complex64):
        tag = str(dtype).split(".")[-1]
        rdt = torch.float64 if dtype == torch.complex128 else torch.float32
        fac = la.LocalFactors(fwd=tuple(f.to(dtype) for f in pf.factors.fwd),
                              bwd=tuple(f.to(dtype) for f in pf.factors.bwd))
        xc = torch.as_tensor(xc_np, device=device).to(dtype)
        V = torch.as_tensor(V_np, device=device).to(rdt)
        t_ref = la.pruned_axis_dft_plain(xc, fac.fwd[2], True).contiguous()
        cases = {
            "pruned_axis_dft": (lambda: la.pruned_axis_dft(xc, fac.fwd[2], True),
                                lambda: la.pruned_axis_dft_plain(xc, fac.fwd[2], True)),
            "local_plane": (lambda: la.local_plane(t_ref, V, fac),
                            lambda: la.local_plane_plain(t_ref, V, fac)),
            "local_plane[strip=16]": (lambda: la.local_plane(t_ref, V, fac, strip=16),
                                      lambda: la.local_plane_plain(t_ref, V, fac)),
            "local_apply": (lambda: la.local_apply(xc, V, fac),
                            lambda: la.local_apply_plain(xc, V, fac)),
        }
        for name, (kern, plain) in cases.items():
            out, ref = kern(), plain()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            print(f"[3] {name} {tag}: max_abs_err={err:.3e} max|out|={scale:.3e} "
                  f"rel={err / scale:.3e} bar={BARS[tag]:.0e}", flush=True)
            check(err <= BARS[tag] * scale, f"{name} {tag} within {BARS[tag]}")
            if tag == "complex128":
                results[name] = dict(max_abs_err=err, ms=cuda_ms(kern),
                                     plain_ms=cuda_ms(plain))
        # the same operator through torch.fft, as a comparison
        V_full = V.permute(0, 2, 3, 1).contiguous()
        ffted = fft_local_apply(xc, V_full, live, grid_idx, n)
        ref = la.local_apply_plain(xc, V, fac)
        err = float((ffted - ref).abs().max())
        print(f"[3] torch.fft local apply {tag}: max_abs_err vs plain={err:.3e}",
              flush=True)
        check(err <= BARS[tag] * float(ref.abs().max()), f"torch.fft apply {tag}")
        if tag == "complex128":
            results["torch.fft"] = dict(ms=cuda_ms(
                lambda: fft_local_apply(xc, V_full, live, grid_idx, n)))
    for name, r in results.items():
        print(f"[3] time complex128 {name}: " + ", ".join(
            f"{k}={v:.4f}" for k, v in r.items() if k != "max_abs_err"), flush=True)
    return results


def main():
    import torch
    # ---- 1. the card ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[1] nvidia-smi: {smi}", flush=True)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    sys.path.insert(0, HERE)
    import dftk_tpu_torch as dt
    from dftk_tpu_torch.kernels import local_apply as la
    with open(os.path.join(HERE, "tests", "data", "torch_port_si54.json")) as f:
        E_ref = json.load(f)["total_energy"]
    device = torch.device("cuda", 0)

    # ---- 2. build ---------------------------------------------------------
    lib = la.library()
    print(f"[2] built {os.path.relpath(lib.path, HERE)} in "
          f"{lib.build_seconds:.1f} s", flush=True)
    for line in lib.log.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(f"[2] ptxas: {line.strip()}", flush=True)

    # ---- 3. kernels against their plain versions ---------------------------
    t0 = time.time()
    basis = si_supercell(dt, device)
    print(f"[3] {basis} set up in {time.time() - t0:.1f} s", flush=True)
    timings = kernel_phase(la, basis, device)

    # ---- 4. the SCF on the GPU ---------------------------------------------
    def show(info):
        print(f"[4] it={info['n_iter']:3d} E={info['E']:.12f} "
              f"drho={info['drho']:.3e} eig_it={info['eig_iters']} "
              f"t={time.time() - t0:.1f}s", flush=True)

    la.counts.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    res = dt.self_consistent_field(basis, tol=1e-8, is_converged="density",
                                   callback=show)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, plain = dict(la.counts.launches), dict(la.counts.plain)
    dE = res.total_energy - E_ref
    print(f"[4] SCF converged={res.converged} n_iter={res.n_iter} wall={wall:.2f} s "
          f"E={res.total_energy:.12f} E_ref={E_ref:.12f} dE={dE:.3e} "
          f"launches={launches} plain_calls={plain}", flush=True)
    check(res.converged, "SCF converged")
    check(np.isfinite(res.total_energy) and abs(dE) < E_TOL, f"|E - E_ref| < {E_TOL}")
    check(tuple(res.rho.shape) == (1,) + basis.fft_size
          and bool(torch.isfinite(res.rho).all()), "finite density of grid shape")
    check(all(v > 0 for v in launches.values()), "every kernel launched in the SCF")
    check(all(v == 0 for v in plain.values()), "no plain version called in the SCF")

    # ---- 5. results ---------------------------------------------------------
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], max_abs_err=timings[name]["max_abs_err"],
                    ms=timings[name]["ms"], plain_ms=timings[name]["plain_ms"])
               for name, (src, rep) in SOURCES.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
