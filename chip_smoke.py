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
  e. the filter-stage probe kernels (csrc/filter_stages.cu) at the JAX
     probes' shapes (t [64, 32, 2, 32, 128] f32, V 64^3, realified factors
     128 x 64): the copy at 1 and 8 planes per block and every stage set
     (f2, f2_rep, f2_rep_f1, full at 1, 4 and 8 planes per block, full
     bf16, rep, dots) against its plain version (f32 bar 1e-5 of max|out|,
     bf16 by the margin rule of phase a), and the one-call library version
     of the copy and of each f32 stage set (torch.mul; one torch.einsum
     over the factors) at the same bar; then, with the counts set to 0, the
     four probe tools' main() (the path: dftk_tpu_torch.tools.probe_{
     pallas_fixed,kernel_pipe,kernel_variants,kernel_incr}), every
     instantiation launched; kernel, plain, library and bound times, and
     the per-launch cost from the slope between chains of 10 and 100 copies
  5. print the kernels' JSON line (launches from phases c and e, times from
     phases 3, a and e, bounds from the shapes), then the result line.
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
PEAK_FLOPS = {"complex128": 67e12, "complex64": 67e12, "float32": 67e12,
              "bf16": 989e12}
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
PROBE_SOURCE = "dftk_tpu_torch/csrc/filter_stages.cu"
PROBE_DIMS = (64, 32, 32, 64, 64, 128)        # n3, m1, m2, n1, n2, nbt of the probes
# the JAX probe body each instantiation replaces (PERF.md lists every one)
PROBE_REPLACES = {
    "probe_copy": "tools/probe_pallas_fixed.py:24",
    "probe_stages[f2]": "tools/probe_kernel_incr.py:71",
    "probe_stages[f2_rep]": "tools/probe_kernel_incr.py:83",
    "probe_stages[f2_rep_f1]": "tools/probe_kernel_incr.py:93",
    "probe_stages[full]": "tools/probe_kernel_incr.py:105",
    "probe_stages[rep]": "tools/probe_kernel_variants.py:96",
    "probe_stages[dots]": "tools/probe_kernel_variants.py:84",
    "probe_stages[full][bf16]": "tools/probe_kernel_variants.py:138",
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


def local_plane_library(t, V, fac):
    """Kernel B's function as one torch.einsum (a closure): t [nk, nb, n3,
    m1, m2] through F2, F1, V [nk, n3, n1, n2], B1 and B2.  V is made
    complex once, outside the call: on the card einsum refuses to mix
    complex and real operands."""
    import torch
    (F1, F2), (B1, B2), Vc = fac.fwd[:2], fac.bwd[:2], V.to(t.dtype)
    return lambda: torch.einsum("kbzxy,yj,xi,kzij,iX,jY->kbzXY", t, F2, F1, Vc, B1, B2)


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
            # the one PyTorch call that computes each kernel's function
            results["pruned_axis_dft"]["library_ms"] = cuda_ms(
                lambda: torch.einsum("kbxyc,cz->kbzxy", xc, fac.fwd[2]))
            lib = local_plane_library(t_ref, V, fac)
            ref = la.local_plane_plain(t_ref, V, fac)
            err = float((lib() - ref).abs().max())
            print(f"[3] local_plane one-call library vs plain: max_abs_err={err:.3e}",
                  flush=True)
            check(err <= BARS[tag] * float(ref.abs().max()), "local_plane library call")
            results["local_plane"]["library_ms"] = cuda_ms(lib)
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


def stage_work(stages, n3, m1, m2, n1, n2, nbt):
    """(bytes, flops) of one probe call on t [n3, m2, 2, m1, nbt] f32
    (stages None: the copy): t read and written once, each factor and the
    part of V that the stage set reads, once."""
    t_elems = n3 * 2 * m2 * m1 * nbt
    if stages is None:
        return 8 * t_elems, t_elems
    if stages == "rep":
        return 8 * t_elems + 4 * n3 * m1 * m2, t_elems
    f1 = stages in ("f2_rep_f1", "full", "dots")
    flops = 2 * n3 * nbt * 8 * m1 * m2 * n2                    # F2f, F2b
    nbytes = 8 * t_elems + 2 * 4 * 4 * n2 * m2
    if f1:
        flops += 2 * n3 * nbt * 8 * n1 * m1 * n2                # F1f, F1b
        nbytes += 2 * 4 * 4 * n1 * m1
    if stages == "full":
        flops += n3 * 2 * n1 * n2 * nbt
        nbytes += 4 * n3 * n1 * n2
    elif stages == "dots":
        flops += n3 * 2 * n1 * n2 * nbt
        nbytes += 4 * n3 * n1
    return nbytes, flops


def stage_library(stages, t, V, F):
    """The one PyTorch call that computes the f32 stage set `stages` on
    (t, V, F), as a closure, or None where there is none.  The repairs are
    index relabelings, so each chain is one einsum over the factors viewed as
    [n, 2, m, 2]; 'rep' is one torch.mul."""
    import torch
    n3, m2, _, m1, nbt = t.shape
    n1, n2 = V.shape[1:]
    if stages == "rep":                 # out[z, p, c, q, b] = t[...] V[z, q, p]
        Vt = V[:, :m1, :m2].transpose(1, 2)[:, :, None, :, None]
        return lambda: torch.mul(t, Vt)
    F2f, F1f, F1b, F2b = F
    f2f, f1f = F2f.view(n2, 2, m2, 2), F1f.view(n1, 2, m1, 2)     # [j,d,p,c], [i,e,q,d]
    f1b, f2b = F1b.view(m1, 2, n1, 2), F2b.view(m2, 2, n2, 2)     # [Q,f,i,e], [P,C,j,f]
    if stages in ("f2", "f2_rep"):      # the two repairs of f2_rep cancel
        return lambda: torch.einsum("zpcqb,jdpc,PCjd->zPCqb", t, f2f, f2b)
    if stages == "f2_rep_f1":
        return lambda: torch.einsum("zpcqb,jdpc,ieqd,Qfie,PCjf->zPCQb",
                                    t, f2f, f1f, f1b, f2b)
    if stages == "full":
        return lambda: torch.einsum("zpcqb,jdpc,ieqd,zij,Qfie,PCjf->zPCQb",
                                    t, f2f, f1f, V, f1b, f2b)
    if stages == "dots" and n2 == 2 * m1:
        # B [2n2, m1] read as [2m1, n2] and D [2m1, n2] as [2n2, m1] are
        # relabelings of (j, d, q) and (Q, f, d, q) where n2 = 2 m1
        return lambda: torch.einsum("zpcqb,jdpc,iej,zi,Qfie,PCQfd->zPCqb", t, f2f,
                                    F1f.view(n1, 2, n2), V[:, :, 0], f1b,
                                    F2b.view(m2, 2, m1, 2, 2))
    return None


def probe_phase(device):
    """Phase e: the filter-stage probe kernels at the JAX probes' shapes."""
    import torch
    from dftk_tpu_torch.kernels import filter_stages as fs
    from dftk_tpu_torch.tools import (probe_harness, probe_kernel_incr, probe_kernel_pipe,
                                      probe_kernel_variants, probe_pallas_fixed)
    check(not torch.backends.cuda.matmul.allow_tf32, "plain f32 matmuls without TF32")
    dims = PROBE_DIMS
    t, V, F = probe_harness.make_inputs(2, *dims, 1.0, 8, device)
    print(f"[e] t {tuple(t.shape)} f32 ({t.numel() * 4 / 1e6:.1f} MB), V "
          f"{tuple(V.shape)}, factors {[tuple(f.shape) for f in F]}", flush=True)
    # label: (count name, kernel, plain, stages, kind, one-call library or None)
    cases = {"probe_copy": ("probe_copy", lambda: fs.probe_copy(t),
                            lambda: fs.probe_copy_plain(t), None, "float32",
                            lambda: torch.mul(t, fs.COPY_SCALE)),
             "copy zblk=8": ("probe_copy", lambda: fs.probe_copy(t, 8),
                             lambda: fs.probe_copy_plain(t), None, "float32", None)}
    for label, stages, prec, zblk in (
            ("f2", "f2", "highest", 1), ("f2_rep", "f2_rep", "highest", 1),
            ("f2_rep_f1", "f2_rep_f1", "highest", 1), ("full", "full", "highest", 1),
            ("full zblk=4", "full", "highest", 4), ("full zblk=8", "full", "highest", 8),
            ("full bf16", "full", "default", 1), ("rep", "rep", "highest", 1),
            ("dots", "dots", "highest", 1)):
        f = None if stages == "rep" else F
        # bf16 has none: a bf16 einsum rounds the V product and the output too
        lib = stage_library(stages, t, V, F) if prec == "highest" and zblk == 1 else None
        cases[label] = (
            fs.count_name(stages, prec),
            lambda s=stages, p=prec, z=zblk, f=f: fs.probe_stages(t, V, f, s, p, z),
            lambda s=stages, p=prec, f=f: fs.probe_stages_plain(t, V, f, s, p),
            stages, "bf16" if prec == "default" else "float32", lib)
    print(f"[e] torch.einsum contraction path from opt_einsum: "
          f"{torch.backends.opt_einsum.enabled}", flush=True)
    results = {}
    for label, (name, kern, plain, stages, kind, lib) in cases.items():
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err, scale = float((out - ref).abs().max()), float(ref.abs().max())
        line = f"[e] {label}: kernel vs plain max_abs_err={err:.3e} max|out|={scale:.3e}"
        if kind == "bf16":
            hi = fs.probe_stages_plain(t, V, F, "full")
            rel, rounding = rel_frobenius(out, ref), rel_frobenius(ref, hi)
            print(f"{line}; rel Frobenius {rel:.3e} against plain default vs highest "
                  f"{rounding:.3e}", flush=True)
            check(rel * BF16_MARGIN <= rounding, f"probe {label}: kernel-vs-plain "
                  f"{BF16_MARGIN}x below default-vs-highest")
        else:
            print(f"{line} rel={err / scale:.3e} bar=1e-05", flush=True)
            check(err <= 1e-5 * scale, f"probe {label} within 1e-5")
        if lib is not None:
            lib_err = float((lib() - ref).abs().max())
            print(f"[e] {label}: one-call library vs plain max_abs_err={lib_err:.3e} "
                  f"bar=1e-05", flush=True)
            check(lib_err <= 1e-5 * scale, f"probe {label}: library call within 1e-5")
        del out, ref
        results[label] = dict(name=name, max_abs_err=err)

    # the path: the four probe tools, counts from 0
    fs.counts.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    fixed = probe_pallas_fixed.main(device)
    for tool in (probe_kernel_pipe, probe_kernel_variants, probe_kernel_incr):
        tool.main(device)
    torch.cuda.synchronize()
    launches = dict(fs.counts.launches)
    print(f"[e] the four probe tools ran in {time.time() - t0:.1f} s, launches={launches}",
          flush=True)
    check(all(v > 0 for v in launches.values()), "every probe kernel launched by the tools")

    for label, (name, kern, plain, stages, kind, lib) in cases.items():
        r = results[label]
        r["ms"], r["plain_ms"] = cuda_ms(kern), cuda_ms(plain)
        r["bound_ms"], r["bound_by"] = bound(stage_work(stages, *dims), kind)
        r["library_ms"] = None if lib is None else cuda_ms(lib)
        print(f"[e] time {label}: " + ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in r.items() if k not in ("name", "max_abs_err")), flush=True)
    print(f"[e] copy chain slope 10->100 launches: {fixed['slope_ms']:.4f} ms per launch, "
          f"intercept {fixed['intercept_ms']:.4f} ms per chain; torch.mul per call in "
          f"chains of 10/100: {fixed['mult_per_iter'][10]:.4f}/"
          f"{fixed['mult_per_iter'][100]:.4f} ms", flush=True)
    return {r["name"]: r for label, r in results.items()
            if label not in ("copy zblk=8", "full zblk=4", "full zblk=8")}, launches


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
    torch.cuda.empty_cache()

    # ---- e. the filter-stage probes -----------------------------------------------
    probe_timings, probe_launches = probe_phase(device)

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
    for name, rep in PROBE_REPLACES.items():
        r = probe_timings[name]
        kernels.append(dict(name=name, route="cuda", source=PROBE_SOURCE, replaces=rep,
                            launches=probe_launches[name], max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=r.get("library_ms")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
