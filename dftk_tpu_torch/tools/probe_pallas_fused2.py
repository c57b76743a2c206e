"""Probe 2: the exact op sequence of the fully fused local-apply kernel.

    python -m dftk_tpu_torch.tools.probe_pallas_fused2

Port of `tools/probe_pallas_fused2.py` on its shapes and inputs (f32, one
np.random.default_rng(0) drawn in the JAX tool's order, F / m):
  (a) k_a: a swap of the last two axes [2, 32, 32, 64] -> [2, 32, 64, 32]
  (b) k_b: [2, 32, 64, 64] viewed [2, 32, 4096], swapped, viewed
      [2, 64, 64, 32]
  (c) k_c: concat(ar, ai) [2, 32, 32, 64] @ F [64, 128] split into re, im
      [2, 32, 32, 64]
through `kernels/op_probes.py`.  Per body: one line with the mean ms of
ITERS back-to-back launches (CUDA events) and the kernel-vs-plain error.
Returns ms per body.  main(device="cpu") runs the plain versions (host
times).
"""
import numpy as np
import torch

from dftk_tpu_torch.kernels import op_probes as op
from dftk_tpu_torch.tools.probe_harness import device_of, header, op_line

ITERS = 10
TB, M, N = 2, 32, 64


def make_inputs(device):
    """The JAX tool's inputs: x4, xb, ar, ai, F."""
    rng = np.random.default_rng(0)
    conv = lambda shape: torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                                         device=device)
    x4 = conv((TB, M, M, N))
    xb = conv((TB, M, N, N))
    ar, ai = conv((TB, M, M, M)), conv((TB, M, M, M))
    return dict(x4=x4, xb=xb, ar=ar, ai=ai, F=conv((2 * M, 2 * N)) / M)


def main(device="cuda"):
    device = device_of(device)
    header("probe_pallas_fused2", device)
    d = make_inputs(device)
    x4, xb, ar, ai, F = (d[k] for k in ("x4", "xb", "ar", "ai", "F"))
    res = {}
    op_line(res, "k_a", f"swap4d {list(x4.shape)}", lambda: op.k_a(x4),
            lambda: op.k_a_plain(x4), device, ITERS)
    op_line(res, "k_b", f"viewswap {list(xb.shape)}", lambda: op.k_b(xb),
            lambda: op.k_b_plain(xb), device, ITERS)
    op_line(res, "k_c", "contract-minor concat+GEMM+slice", lambda: op.k_c(ar, ai, F),
            lambda: op.k_c_plain(ar, ai, F), device, ITERS)
    return res


if __name__ == "__main__":
    main()
