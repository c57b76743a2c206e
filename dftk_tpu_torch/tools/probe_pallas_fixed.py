"""Is there a large fixed per-launch cost for a kernel here?

    python -m dftk_tpu_torch.tools.probe_pallas_fixed

Port of `tools/probe_pallas_fixed.py`: `probe_copy` (out = 0.999 t, one
block per z-plane, as the TPU grid holds one plane per step) on the probes'
t [n3, m2, 2, m1, nbt] f32, in chains of 10, 20, 50 and 100 launches, three
times each; then `torch.mul` by 0.999 in chains of 10 and 100 as the
control (the JAX tool's XLA multiply), and the per-launch cost from the
slope between the chains of 10 and 100 copies.  Returns the times.
"""
import torch

from dftk_tpu_torch.kernels import filter_stages as fs
from dftk_tpu_torch.tools.probe_harness import (chain_total_ms, device_of, header,
                                                make_inputs, vs_plain)

m1 = m2 = 32
n1 = n2 = n3 = 64
nbt = 128
LOOPS = (10, 20, 50, 100)
REPS = 3


def main(device="cuda"):
    device = device_of(device)
    header("probe_pallas_fixed", device)
    t1 = make_inputs(0, n3, m1, m2, n1, n2, nbt, 0.01, 64, device)[0]
    err, rel = vs_plain(fs.probe_copy(t1), fs.probe_copy_plain(t1))
    print(f"copy vs plain: max_abs_err {err:.2e} rel {rel:.2e}", flush=True)
    per_iter = {}
    for loop in LOOPS:
        for rep in range(REPS):
            dt = chain_total_ms(fs.probe_copy, t1, loop)
            per_iter[loop] = min(per_iter.get(loop, dt / loop), dt / loop)
            print(f"cuda  copy loop={loop:4d} rep{rep}: total {dt:8.2f} ms  "
                  f"per-iter {dt / loop:7.3f} ms", flush=True)
    mult = {}
    for loop in (10, 100):
        dt = chain_total_ms(lambda a: torch.mul(a, fs.COPY_SCALE), t1, loop)
        mult[loop] = dt / loop
        print(f"torch mult loop={loop:4d}     : total {dt:8.2f} ms  "
              f"per-iter {dt / loop:7.3f} ms", flush=True)
    lo, hi = LOOPS[0], LOOPS[-1]
    slope = (per_iter[hi] * hi - per_iter[lo] * lo) / (hi - lo)
    fixed = per_iter[lo] * lo - slope * lo
    print(f"copy slope loop={lo}->{hi}: {slope:.4f} ms per launch, intercept "
          f"{fixed:.4f} ms per chain", flush=True)
    return dict(copy_per_iter=per_iter, mult_per_iter=mult, slope_ms=slope,
                intercept_ms=fixed)


if __name__ == "__main__":
    main()
