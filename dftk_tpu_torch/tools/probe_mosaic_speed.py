"""Micro-speed of single ops repeated on data that stays on the chip.

    python -m dftk_tpu_torch.tools.probe_mosaic_speed

Port of `tools/probe_mosaic_speed.py` on its shapes, through
`kernels/op_speed.py`: each body repeats one op R = 100 times inside one
launch (each block keeps its part of the data in shared memory or
registers), and the line gives the launch's time / R per op, as the JAX
tool does, with TF/s for the dots:
  rep_dot: acc <- 1e-3 (F @ acc) + 0.5 acc, F [K, K], acc [K, N] at
           (128, 4096) f32 and bf16 ('default'), (64, 4096) f32 and bf16,
           (64, 8192) f32 and (128, 8192) f32
  d1:      the same on acc [64, 64, 128], F on axis 1, f32
  tp:      x <- 0.999 x.permute(2, 1, 0, 3), x [64, 2, 64, 128]
  tp2:     x <- 0.999 x.permute(1, 0, 2), x [64, 64, 128]
  vm:      x <- (x V[:, None, :, None]) 1.001, x [64, 2, 64, 128], V [64, 64]
  tp3:     x <- 0.999 x.permute(0, 2, 1), x [64, 128, 128]
The JAX tool draws unseeded np.random.randn(shape) * 0.01 per input; this
one draws the same shapes in the same order from np.random.default_rng(0).
Times: one launch, CUDA events, after a warm-up.  Each line also gives
the kernel-vs-plain error at R.  Returns us per op by count name.
main(device="cpu") runs the plain versions (host times).
"""
import numpy as np
import torch

from dftk_tpu_torch.kernels import op_speed as osp
from dftk_tpu_torch.tools.probe_harness import device_of, header, mean_ms, vs_plain

R = 100


def make_inputs(device, seed=0):
    """The inputs of the eleven bodies in the JAX tool's order: a list of
    tuples of f32 tensors, randn * 0.01."""
    rng = np.random.default_rng(seed)
    shapes = [[(K, K), (K, N)] for K, N, _ in osp.REP_DOTS] + [
        [(64, 64), (64, 64, 128)], [(64, 2, 64, 128)], [(64, 64, 128)],
        [(64, 2, 64, 128), (64, 64)], [(64, 128, 128)]]
    return [tuple(torch.as_tensor(rng.standard_normal(s) * 0.01, dtype=torch.float32,
                                  device=device) for s in body) for body in shapes]


def bodies(inputs, R):
    """(JAX tool's label, count name, kernel, plain, flops per op) of each
    body at R steps, in order."""
    out = []
    for (K, N, prec), (F, acc) in zip(osp.REP_DOTS, inputs):
        body = f"rep_dot_{K}x{N}"
        tag = "f32" if prec == "highest" else "bf16"
        out.append((f"dot [{K},{K}]@[{K},{N}] {tag} x{R}", osp.gemm_name(body, prec),
                    lambda F=F, acc=acc, b=body, p=prec: osp.rep_gemm(acc, F, R, b, p),
                    lambda F=F, acc=acc, b=body, p=prec: osp.rep_gemm_plain(acc, F, R, b, p),
                    2 * K * K * N))
    (F1, a1), (xtp,), (xtp2,), (xvm, V), (xtp3,) = inputs[len(osp.REP_DOTS):]
    swap = lambda x, perm, body: (lambda: osp.rep_swap(x, perm, R, body),
                                  lambda: osp.rep_swap_plain(x, perm, R, body))
    out += [
        (f"dot dim1 [64,64]@[64,64,128] f32 + tp x{R}", "op_rep_gemm[d1]",
         lambda: osp.rep_gemm(a1, F1, R, "d1"), lambda: osp.rep_gemm_plain(a1, F1, R, "d1"),
         2 * 64 * 64 * 64 * 128),
        (f"transpose [64,2,64,128] (2,1,0,3) x{R}", "op_rep_swap[tp]",
         *swap(xtp, (2, 1, 0, 3), "tp"), 0),
        (f"transpose [64,64,128] (1,0,2) x{R}", "op_rep_swap[tp2]",
         *swap(xtp2, (1, 0, 2), "tp2"), 0),
        (f"V-mult broadcast [64,2,64,128] x{R}", "op_rep_vmul[vm]",
         lambda: osp.rep_vmul(xvm, V, R), lambda: osp.rep_vmul_plain(xvm, V, R), 0),
        (f"transpose [64,128,128] (0,2,1) lane swap x{R}", "op_rep_swap[tp3]",
         *swap(xtp3, (0, 2, 1), "tp3"), 0),
    ]
    return out


def main(device="cuda"):
    device = device_of(device)
    header("probe_mosaic_speed", device)
    res = {}
    for label, name, kernel, plain, flops in bodies(make_inputs(device), R):
        dt = mean_ms(kernel, device) / 1e3 / R
        err, rel = vs_plain(kernel(), plain())
        res[name] = dt * 1e6
        print(f"{label:56s}: {dt * 1e6:9.2f} us"
              + (f"  {flops / dt / 1e12:6.1f} TF/s" if flops else "")
              + f"  vs plain max_abs_err {err:.2e} rel {rel:.2e}", flush=True)
    return res


if __name__ == "__main__":
    main()
