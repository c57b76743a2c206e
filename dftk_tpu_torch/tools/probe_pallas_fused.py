"""Probe the op set of the fused local apply: transposes, a GEMM, the axis chain.

    python -m dftk_tpu_torch.tools.probe_pallas_fused

Port of `tools/probe_pallas_fused.py` on its shapes and inputs (f32, each
from its own np.random.default_rng(seed), F / m1 as the JAX tool scales it):
  1. t2d: a 2-D transpose [32, 8192] -> [8192, 32] (seed 0)
  2. swap: a batched last-two swap [2048, 64, 2] -> [2048, 2, 64] (seed 1)
  3. gemm: [4096, 64] @ [64, 128] in full f32 (seeds 2, 3)
  4. fused: the chain swap -> [R/2, 64] @ F -> x V -> @ F^T -> swap on
     xb [8, 32, 8192] with F [64, 64] / 32 and V [4096, 1, 32] (seeds 4-6)
through `kernels/op_probes.py`.  Per body: one line with the mean ms of
ITERS back-to-back launches (CUDA events) and the kernel-vs-plain error;
then, as the JAX tool does, the time of 10 fused calls.  Returns ms per
body.  main(device="cpu") runs the plain versions (host times).
"""
import numpy as np
import torch

from dftk_tpu_torch.kernels import op_probes as op
from dftk_tpu_torch.tools.probe_harness import device_of, header, mean_ms, op_line

ITERS = 10
M1, R, NB = 32, 8192, 8


def make_inputs(device):
    """The JAX tool's inputs: x, y, A, B, xb, F, V."""
    conv = lambda seed, shape: torch.as_tensor(np.random.default_rng(seed).normal(size=shape),
                                               dtype=torch.float32, device=device)
    return dict(x=conv(0, (M1, R)), y=conv(1, (2048, 64, 2)), A=conv(2, (4096, 64)),
                B=conv(3, (64, 128)), xb=conv(4, (NB, M1, R)),
                F=conv(5, (2 * M1, 2 * M1)) / M1, V=conv(6, (R // 2, 1, M1)))


def main(device="cuda"):
    device = device_of(device)
    header("probe_pallas_fused", device)
    d = make_inputs(device)
    x, y, A, B, xb, F, V = (d[k] for k in ("x", "y", "A", "B", "xb", "F", "V"))
    res = {}
    op_line(res, "t2d", f"2D transpose {list(x.shape)}", lambda: op.t2d(x),
            lambda: op.t2d_plain(x), device, ITERS)
    op_line(res, "swap", f"batched swap {list(y.shape)}", lambda: op.swap(y),
            lambda: op.swap_plain(y), device, ITERS)
    op_line(res, "gemm", f"GEMM {list(A.shape)}@{list(B.shape)} HIGHEST",
            lambda: op.gemm(A, B), lambda: op.gemm_plain(A, B), device, ITERS)
    op_line(res, "fused", "fused chain", lambda: op.fused(xb, F, V),
            lambda: op.fused_plain(xb, F, V), device, ITERS)
    ten = 10 * mean_ms(lambda: op.fused(xb, F, V), device, 10)
    print(f"       10 iters: {ten / 1e3:.6f} s", flush=True)
    return res


if __name__ == "__main__":
    main()
