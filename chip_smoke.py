#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dftk_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. check that a CUDA device exists; print the card's name and power limit
  2. build the hand-written CUDA kernels from dftk_tpu_torch/csrc
  3. hold each kernel, and the composed local apply, against its plain
     PyTorch version at the Si54 shapes (compact cube 32^3, grid 64^3,
     128 bands, Gamma) in complex128 (bar 1e-11 of max|out|) and complex64
     (bar 1e-5); time kernel, plain version, a one-call library version
     where one exists and a torch.fft local apply with CUDA events
  4. run self_consistent_field (LOBPCG) in float64 on the GPU on the
     bench.py Si54 problem (LDA, HGH lda/si-q4, Ecut 10, Gamma, no
     symmetry) to a density tolerance of 1e-8, and require convergence,
     |E - E_ref| < 1e-7 Ha against the JAX package's CPU float64 energy
     (tests/data/torch_port_si54.json), kernel launches > 0 and no call of a
     plain version on the way
  a. the bf16 ('default') kernels A, B and A+B+A against their plain
     versions at the Si54 shapes: the kernel-vs-plain difference must be at
     least 10x smaller than the plain 'default'-vs-'highest' difference
     (relative Frobenius norms; the max abs errors are printed too); timed
  b. the compact-cube-resident Chebyshev filter chain of bench.py:160-192
     at Si54, 128 bands, chains of 25 and 100 applies, in complex128
     'highest', complex64 'highest' and bf16 'default': us per band-apply
     from the slope
  c. the split CheFSI SCF (self_consistent_field_split, float64, "mixed"
     filter, degree 10, 2 cycles) on Si54 to a density tolerance of 1e-8:
     |E - E_ref| < 1e-7 Ha, every kernel instantiation of the path
     (complex128 and bf16) launched, no plain version called
  d. Si256 (dftk_tpu_torch.tools.run_si_big 4 4 2 10.0: 576 bands,
     band_chunk 256): 3 iterations of the same SCF with finite energies;
     seconds per iteration, peak device memory; then kernels A (forward
     and backward) and B on one 256-band chunk at the Si256 shapes, each
     instantiation against its plain version with the bars of phases 3
     and a, and kernel B's strip width and ms per launch
  5. print the kernels' JSON line (launches from phase c, times from phases
     3 and a, bounds from the shapes), then the result line.
This script imports neither jax nor the JAX package.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_BANDS_KERNEL = 128
E_TOL = 1e-7
BARS = {"complex128": 1e-11, "complex64": 1e-5}
BF16_MARGIN = 10        # kernel-vs-plain at least 10x below default-vs-highest
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s; FLOP/s of the
# arithmetic each instantiation stands for (f64 tensor cores, f32 outside
# them, bf16 tensor cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"complex128": 67e12, "complex64": 67e12, "bf16": 989e12}
SOURCES = {
    "pruned_axis_dft": ("dftk_tpu_torch/csrc/pruned_axis_dft.cu",
                        "dftk_tpu/kernels/fused_local.py:138"),
    "local_plane": ("dftk_tpu_torch/csrc/local_plane.cu",
                    "dftk_tpu/kernels/fused_filter.py:190"),
    "pruned_axis_dft[bf16]": ("dftk_tpu_torch/csrc/pruned_axis_dft.cu",
                              "dftk_tpu/kernels/fused_local.py:138"),
    "local_plane[bf16]": ("dftk_tpu_torch/csrc/local_plane.cu",
                          "dftk_tpu/kernels/fused_filter.py:190"),
}


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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
        if tag == "complex128":
            # the one PyTorch call that computes kernel A's function
            results["pruned_axis_dft"]["library_ms"] = cuda_ms(
                lambda: torch.einsum("kbxyc,cz->kbzxy", xc, fac.fwd[2]))
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
    return results, (xc_np, V_np)


def axis_dft_work(x_shape, K, J, esize):
    """(bytes, flops) of one kernel-A call: input and output read and written
    once, the factor once; 8 real flops per complex multiply-add."""
    batch = x_shape[0] * x_shape[1] * math.prod(x_shape[2:]) // K
    return (batch * (K + J) + K * J) * esize, 8 * batch * K * J


def local_plane_work(t_shape, n1, n2, esize):
    """(bytes, flops) of one kernel-B call on t [nk, nb, n3, m1, m2]."""
    nk, nb, n3, m1, m2 = t_shape
    planes = nk * nb * n3
    macs = planes * (m1 * n2 * m2 + n1 * n2 * m1 + m1 * n2 * n1 + m1 * m2 * n2)
    nbytes = (2 * planes * m1 * m2 + 2 * (m1 * n1 + m2 * n2)) * esize \
        + nk * n3 * n1 * n2 * esize // 2
    return nbytes, 8 * macs


def bound(work, kind):
    """(ms, "bytes" | "operations"): the least time of the work on the card."""
    t_bytes = work[0] / PEAK_BYTES * 1e3
    t_ops = work[1] / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_frobenius(a, b):
    import torch
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def bf16_phase(la, basis, device, inputs):
    """Phase a: the bf16 instantiations against their plain versions."""
    import torch
    pf = basis.pruned
    xc_np, V_np = inputs
    fac = la.LocalFactors(fwd=tuple(f.to(torch.complex64) for f in pf.factors.fwd),
                          bwd=tuple(f.to(torch.complex64) for f in pf.factors.bwd))
    xc = torch.as_tensor(xc_np, device=device).to(torch.complex64)
    V = torch.as_tensor(V_np, device=device).to(torch.float32)
    t = la.pruned_axis_dft_plain(xc, fac.fwd[2], True, "default").contiguous()
    cases = {
        "pruned_axis_dft[bf16]": (
            lambda: la.pruned_axis_dft(xc, fac.fwd[2], True, "default"),
            lambda: la.pruned_axis_dft_plain(xc, fac.fwd[2], True, "default"),
            lambda: la.pruned_axis_dft_plain(xc, fac.fwd[2], True)),
        "local_plane[bf16]": (
            lambda: la.local_plane(t, V, fac, precision="default"),
            lambda: la.local_plane_plain(t, V, fac, "default"),
            lambda: la.local_plane_plain(t, V, fac)),
        "local_apply[bf16]": (
            lambda: la.local_apply(xc, V, fac, "default"),
            lambda: la.local_apply_plain(xc, V, fac, "default"),
            lambda: la.local_apply_plain(xc, V, fac)),
    }
    results = {}
    for name, (kern, plain, highest) in cases.items():
        out, ref, hi = kern(), plain(), highest()
        torch.cuda.synchronize()
        err, rounding = float((out - ref).abs().max()), float((ref - hi).abs().max())
        rel, rel_rounding = rel_frobenius(out, ref), rel_frobenius(ref, hi)
        print(f"[a] {name}: kernel vs plain max_abs_err={err:.3e} rel={rel:.3e}; "
              f"plain default vs highest max_abs={rounding:.3e} rel={rel_rounding:.3e}; "
              f"ratio (rel) {rel_rounding / max(rel, 1e-300):.3g}", flush=True)
        check(rel * BF16_MARGIN <= rel_rounding,
              f"{name}: kernel-vs-plain {BF16_MARGIN}x below default-vs-highest")
        results[name] = dict(max_abs_err=err, ms=cuda_ms(kern), plain_ms=cuda_ms(plain))
        print(f"[a] time {name}: ms={results[name]['ms']:.4f} "
              f"plain_ms={results[name]['plain_ms']:.4f}", flush=True)
    return results


def filter_chain_phase(dt, basis, device, n_short=25, n_long=100):
    """Phase b: compact-resident filter applies, us per band-apply from the
    slope between two chain lengths (bench.py:143-192)."""
    import torch
    from dftk_tpu_torch.ops import engine_split as es
    volume = basis.model.unit_cell_volume
    rho = dt.guess_density(basis)
    rng = np.random.default_rng(7)
    shape = (basis.n_kpoints, N_BANDS_KERNEL, basis.nG_max)
    X_np = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * basis.mask_np[:, None]
    X_np /= np.linalg.norm(X_np, axis=-1, keepdims=True)
    out = {}
    for label, dtype, prec in (("complex128 highest", torch.complex128, "highest"),
                               ("complex64 highest", torch.complex64, "highest"),
                               ("bf16 default", torch.complex128, "default")):
        sd = es.prepare_split_data(basis, dtype)
        V, _ = es.total_potential_split(basis.terms, sd, rho.to(sd.basis_data.kin.dtype),
                                        volume)
        enter, leave, apply_c = es.compact_filter_ops(es.make_split_ham(sd, V), volume,
                                                      precision=prec)
        X = torch.as_tensor(X_np, device=device).to(dtype)
        scale = 1.0 / 40      # keeps the powers of H finite in single precision

        def chain(n):
            x = enter(X).to(apply_c.dtype)
            for _ in range(n):
                x = apply_c(x).mul_(scale)
            return leave(x)

        t_short = cuda_ms(lambda: chain(n_short), reps=3, warmup=1)
        t_long = cuda_ms(lambda: chain(n_long), reps=3, warmup=1)
        per_apply_us = (t_long - t_short) / ((n_long - n_short) * N_BANDS_KERNEL
                                             * basis.n_kpoints) * 1e3
        out[label] = per_apply_us
        print(f"[b] filter chain {label}: {n_short} applies {t_short:.2f} ms, "
              f"{n_long} applies {t_long:.2f} ms, slope {per_apply_us:.3f} us per "
              f"band-apply ({per_apply_us * N_BANDS_KERNEL / 1e3:.3f} ms per "
              f"{N_BANDS_KERNEL}-band apply)", flush=True)
    return out


def split_scf_phase(dt, la, basis, E_ref):
    """Phase c: the split CheFSI SCF, float64, mixed filter, on Si54."""
    import torch
    t0 = time.time()

    def show(info):
        if "E" in info:
            print(f"[c] it={info['n_iter']:3d} E={info['E']:.12f} drho={info['drho']:.3e} "
                  f"eps_r={info['eps_r']:.2f} t={time.time() - t0:.1f}s", flush=True)

    la.counts.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    res = dt.self_consistent_field_split(
        basis, tol=1e-8, maxiter=60, eigensolver="chefsi", chebyshev_degree=10,
        chefsi_cycles=2, is_converged="density", filter_precision="mixed",
        callback=show)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, plain = dict(la.counts.launches), dict(la.counts.plain)
    E = res["energies"]["total"]
    print(f"[c] split SCF converged={res['converged']} n_iter={res['n_iter']} "
          f"wall={wall:.2f} s E={E:.12f} dE={E - E_ref:.3e} launches={launches} "
          f"plain_calls={plain}", flush=True)
    check(res["converged"], "split SCF converged")
    check(np.isfinite(E) and abs(E - E_ref) < E_TOL, f"split SCF |E - E_ref| < {E_TOL}")
    check(tuple(res["rho"].shape) == (1,) + basis.fft_size
          and bool(torch.isfinite(res["rho"]).all()), "finite density of grid shape")
    check(all(v > 0 for v in launches.values()), "every kernel launched in the split SCF")
    check(all(v == 0 for v in plain.values()), "no plain version called in the split SCF")
    return launches


def si256_phase(dt, la, device, n_iter=3):
    """Phase d: a few Si256 iterations, and kernel B at the Si256 shapes."""
    import torch
    from dftk_tpu_torch.tools.run_si_big import (BAND_CHUNK, build_basis, n_bands_of,
                                                 scf_options)
    t0 = time.time()
    basis = build_basis((4, 4, 2), 10.0, device)
    natoms = len(basis.model.atoms)
    n_occ, nb = n_bands_of(natoms)
    print(f"[d] Si{natoms}: {basis}, compact {basis.pruned.m_shape}, {nb} bands, "
          f"set up in {time.time() - t0:.1f} s", flush=True)
    stamps = []

    def show(info):
        torch.cuda.synchronize()
        stamps.append(time.time())
        if "E" in info:
            print(f"[d] it={info['n_iter']} E={info['E']:.10f} drho={info['drho']:.3e} "
                  f"t={stamps[-1] - t0:.1f}s", flush=True)

    opts = dict(scf_options({}), maxiter=n_iter)
    la.counts.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.time()
    res = dt.self_consistent_field_split(
        basis, n_bands=n_occ, n_extra_bands=nb - n_occ, eigensolver="chefsi",
        band_chunk=BAND_CHUNK, is_converged="density", callback=show, **opts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_it = np.diff([t0] + stamps)
    launches = dict(la.counts.launches)
    print(f"[d] Si{natoms} {res['n_iter']} iterations, s/iteration "
          f"{[round(float(t), 2) for t in per_it]}, peak device memory {peak:.2f} GiB, "
          f"launches={launches}", flush=True)
    check(all(np.isfinite(E) for E, _ in res["history"]), "finite Si256 energies")
    check(all(v > 0 for v in launches.values()), "every kernel launched at Si256")
    check(all(v == 0 for v in la.counts.plain.values()), "no plain version at Si256")

    # kernels A (forward, backward) and B alone at the Si256 shapes, in one
    # band chunk, against their plain versions: complex128 within its bar,
    # bf16 by the margin rule of phase a; kernel B in complex128 takes the
    # strip-mined path
    m1, m2, m3 = basis.pruned.m_shape
    n1, n2, n3 = basis.fft_size
    fac = basis.pruned.factors
    del res
    rng = np.random.default_rng(5)

    def crandn(shape):
        return torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                               device=device)

    x, t = crandn((1, BAND_CHUNK, m1, m2, m3)), crandn((1, BAND_CHUNK, n3, m1, m2))
    V = torch.as_tensor(rng.normal(size=(1, n3, n1, n2)), device=device)
    for tag, prec, dtype in (("complex128", "highest", torch.complex128),
                             ("bf16", "default", torch.complex64)):
        f = la.LocalFactors(fwd=tuple(a.to(dtype) for a in fac.fwd),
                            bwd=tuple(a.to(dtype) for a in fac.bwd))
        xx, tt = x.to(dtype), t.to(dtype)
        VV = V.to(torch.float64 if tag == "complex128" else torch.float32)
        cases = {
            "kernel A forward": (
                xx, lambda p: la.pruned_axis_dft(xx, f.fwd[2], True, p),
                lambda p: la.pruned_axis_dft_plain(xx, f.fwd[2], True, p)),
            "kernel A backward": (
                tt, lambda p: la.pruned_axis_dft(tt, f.bwd[2], False, p),
                lambda p: la.pruned_axis_dft_plain(tt, f.bwd[2], False, p)),
            "kernel B": (
                tt, lambda p: la.local_plane(tt, VV, f, precision=p),
                lambda p: la.local_plane_plain(tt, VV, f, p)),
        }
        for name, (inp, kern, plain) in cases.items():
            out, ref = kern(prec), plain(prec)
            torch.cuda.synchronize()
            rel = rel_frobenius(out, ref)
            err = float((out - ref).abs().max()) / float(ref.abs().max())
            line = (f"[d] {name} {tag} at Si{natoms} shapes in {tuple(inp.shape)} -> "
                    f"{tuple(out.shape)}: vs plain max rel {err:.3e}, rel Frobenius {rel:.3e}")
            del out
            if tag == "complex128":
                check(err <= BARS["complex128"], f"Si256 {name} complex128 vs plain")
            else:
                rounding = rel_frobenius(ref, plain("highest"))
                line += f"; plain default vs highest rel Frobenius {rounding:.3e}"
                check(rel * BF16_MARGIN <= rounding,
                      f"Si256 {name} bf16: kernel-vs-plain {BF16_MARGIN}x below "
                      f"default-vs-highest")
            del ref
            if name == "kernel B":
                ms = cuda_ms(lambda: kern(prec), reps=5, warmup=1)
                b = bound(local_plane_work(tuple(tt.shape), n1, n2, tt.element_size()), tag)
                line += (f"; strip {la.local_plane_strip(tt, n1, n2)} of {n2}, {ms:.3f} ms "
                         f"per launch, bound {b[0]:.3f} ms ({b[1]})")
            print(line, flush=True)


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
    from dftk_tpu_torch.tools.run_si_big import build_bench_basis
    basis = build_bench_basis(3, 10.0, device)
    print(f"[3] {basis} set up in {time.time() - t0:.1f} s", flush=True)
    m, n = basis.pruned.m_shape, basis.fft_size
    timings, inputs = kernel_phase(la, basis, device)

    # ---- 4. the LOBPCG SCF on the GPU ----------------------------------------
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
    check(launches["pruned_axis_dft"] > 0 and launches["local_plane"] > 0,
          "every complex128 kernel launched in the SCF")
    check(all(v == 0 for v in plain.values()), "no plain version called in the SCF")
    del res

    # ---- a. the bf16 kernels ---------------------------------------------------
    timings.update(bf16_phase(la, basis, device, inputs))

    # ---- b. the compact-resident filter chain -----------------------------------
    filter_chain_phase(dt, basis, device)

    # ---- c. the split CheFSI SCF on Si54 (this slice's main path) -------------
    launches = split_scf_phase(dt, la, basis, E_ref)
    del basis
    torch.cuda.empty_cache()

    # ---- d. Si256 ---------------------------------------------------------------
    si256_phase(dt, la, device)

    # ---- 5. results ---------------------------------------------------------
    x_shape, t_shape = (1, N_BANDS_KERNEL) + m, (1, N_BANDS_KERNEL, n[2], m[0], m[1])
    work = {"pruned_axis_dft": (axis_dft_work(x_shape, m[2], n[2], 16), "complex128"),
            "local_plane": (local_plane_work(t_shape, n[0], n[1], 16), "complex128"),
            "pruned_axis_dft[bf16]": (axis_dft_work(x_shape, m[2], n[2], 8), "bf16"),
            "local_plane[bf16]": (local_plane_work(t_shape, n[0], n[1], 8), "bf16")}
    kernels = []
    for name, (src, rep) in SOURCES.items():
        bound_ms, bound_by = bound(*work[name])
        kernels.append(dict(name=name, route="cuda", source=src, replaces=rep,
                            launches=launches[name],
                            max_abs_err=timings[name]["max_abs_err"],
                            ms=timings[name]["ms"], plain_ms=timings[name]["plain_ms"],
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=timings[name].get("library_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
