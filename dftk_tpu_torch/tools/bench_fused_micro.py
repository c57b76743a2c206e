"""Micro-bench the band-major fully fused chain and its swap-only ablation.

    python -m dftk_tpu_torch.tools.bench_fused_micro

Port of `tools/bench_fused_micro.py` on its shapes: xr, xi [1, NB, M, M, M]
f32, V [1, N, N, N], F [2M, 2N], G [2N, 2M], normal from
np.random.default_rng(0) in the JAX tool's order.  Per variant
(`micro_full`, `micro_swaponly`): one warm-up call and ITERS timed calls of
a chain of CHAIN applies, each fed the previous output, as the JAX tool's
`fori_loop`; prints its two lines and the kernel-vs-plain error of one
application; returns ms per apply.

F and G are unscaled, as in the JAX tool, so the chain overflows f32 to
inf and NaN after about seven applies.  The timings keep these inputs (an
FMA takes as long on inf or NaN); the error is that of one application.
"""
import numpy as np
import torch

from dftk_tpu_torch.kernels import fused_micro as fm
from dftk_tpu_torch.tools.probe_harness import device_of, header, mean_ms, vs_plain

NB, M, N = 256, 32, 64
CHAIN = 10
ITERS = 3


def main(device="cuda"):
    device = device_of(device)
    header("bench_fused_micro", device)
    rng = np.random.default_rng(0)
    conv = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    xr = conv(rng.normal(size=(1, NB, M, M, M)))
    xi = conv(rng.normal(size=(1, NB, M, M, M)))
    V = conv(rng.normal(size=(1, N, N, N)))
    F = conv(rng.normal(size=(2 * M, 2 * N)))
    G = conv(rng.normal(size=(2 * N, 2 * M)))
    variants = {"full": (lambda a, b: fm.micro_full(a, b, V, F, G),
                         lambda: fm.micro_full_plain(xr, xi, V, F, G)),
                "swaponly": (lambda a, b: fm.micro_swaponly(a, b, N),
                             lambda: fm.micro_swaponly_plain(xr, xi, N))}
    res = {}
    for name, (apply, plain) in variants.items():
        def call():
            c = (xr, xi)
            for _ in range(CHAIN):
                c = apply(*c)
            return c

        dt = mean_ms(call, device, ITERS)
        err, rel = vs_plain(torch.stack(apply(xr, xi)), torch.stack(plain()))
        print(f"kernel[{name}] {NB} bands x{CHAIN} chained: {dt:.3f} ms", flush=True)
        print(f"   -> per apply: {dt / CHAIN:.3f} ms  (one apply vs plain max_abs_err "
              f"{err:.2e} rel {rel:.2e})", flush=True)
        res[name] = dt / CHAIN
    return res


if __name__ == "__main__":
    main()
