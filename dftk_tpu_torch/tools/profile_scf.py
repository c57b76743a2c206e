"""Where the device time of the split CheFSI SCF goes, on one CUDA card.

    python -m dftk_tpu_torch.tools.profile_scf [si54|si256]

si54: the Si54 Gamma problem of bench.py (Ecut 10, 118 bands), the split
SCF in complex128 with the "mixed" filter, degree 10, 2 cycles, to a
density residual of 1e-8, after a 2-iteration warm-up run.
si256: 3 iterations of `run_si_big 4 4 2 10.0` (576 bands, band_chunk
256), after a 1-iteration warm-up run.

Runs the SCF under torch.profiler and prints the wall time, the device
time summed over the device-side events (kernels, copies), the device's
idle share of the wall, and the kernels ordered by device time.
"""
import sys
import time

import torch


def _setup(case):
    from dftk_tpu_torch.tools import run_si_big
    if case == "si54":
        basis = run_si_big.build_bench_basis()
        kw = dict(tol=1e-8, maxiter=60, chebyshev_degree=10, chefsi_cycles=2)
        return basis, kw, dict(kw, maxiter=2)
    if case == "si256":
        basis = run_si_big.build_basis((4, 4, 2), 10.0)
        n_occ, nb = run_si_big.n_bands_of(len(basis.model.atoms))
        kw = dict(run_si_big.scf_options({}), n_bands=n_occ, n_extra_bands=nb - n_occ,
                  band_chunk=run_si_big.BAND_CHUNK, maxiter=3)
        return basis, kw, dict(kw, maxiter=1)
    raise SystemExit(f"unknown case {case!r}: si54 or si256")


def main(argv=None):
    from dftk_tpu_torch import self_consistent_field_split
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    argv = sys.argv[1:] if argv is None else argv
    case = argv[0] if argv else "si54"
    basis, kw, warm = _setup(case)
    run = lambda k: self_consistent_field_split(basis, eigensolver="chefsi",
                                                is_converged="density", **k)
    run(warm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        res = run(kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
    # device-side events only (kernels, memcpy/memset): a CPU op's device
    # time repeats that of the kernels it launched
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        raise SystemExit("the profiler recorded no device time")
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows) / 1e3
    print(f"{case}: {torch.cuda.get_device_name(basis.device)}; {res['n_iter']} "
          f"iterations, converged={res['converged']}, wall {wall:.3f} s under the "
          f"profiler, device time {busy:.3f} s, idle share {1 - busy / wall:.3f}")
    for name, count, ms in rows[:25]:
        print(f"  {ms:10.1f} ms {100 * ms / 1e3 / busy:5.1f}% {count:7d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
