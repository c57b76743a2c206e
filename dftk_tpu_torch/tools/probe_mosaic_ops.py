"""Probe the reshape, permute and dot patterns of the fused kernels, one launch each.

    python -m dftk_tpu_torch.tools.probe_mosaic_ops

Port of `tools/probe_mosaic_ops.py` on its shapes and inputs (all ones, as
the JAX tool has them; f32 out), through `kernels/op_probes.py`:
  1. view1: reshape [64, 32, 128] -> [64, 4096] (a copy)
  2. perm2: permute (2, 1, 0, 3) of [64, 2, 32, 128]
  3. dot3: [128, 64] @ [64, 4096], f32 (HIGHEST)
  4. dot4: [128, 64] against [64, 32, 128] over its dim 0, 'default'
  5. view5: reshape [2560, 64] -> [80, 32, 64] (a copy)
  6. dot6: batched [64, 128, 64] @ [64, 64, 64], 'default'
  7. view7: reshape [64, 2, 32, 128] -> [128, 32, 128] (a copy)
  8. dot8: bf16 [128, 64] @ bf16 [64, 4096] with f32 products and sums
Per body one line: the JAX tool's (name, OK and the output's shape), then
the ms of one launch (CUDA events after a warm-up) and the kernel-vs-plain
error.  On inputs of ones every output is 1.0 or 64.0 whatever the layout,
so `make_inputs(device, ones=False)` draws the same shapes normal from a
seed, for checks that see layouts.  Returns ms per body.
main(device="cpu") runs the plain versions (host times).
"""
import numpy as np
import torch

from dftk_tpu_torch.kernels import op_probes as op
from dftk_tpu_torch.tools.probe_harness import device_of, header, mean_ms, vs_plain

M1, M2, N2, NBT = 32, 32, 64, 128
ARGS = (("a",), ("b",), ("F", "d"), ("F", "d3"), ("e",), ("X", "M"), ("g",),
        ("Fb", "db"))          # the inputs of each body, keys of make_inputs


def make_inputs(device, ones=True, seed=0):
    """The JAX tool's inputs, in its order (ones; or normal from `seed`)."""
    shapes = dict(a=(2 * M2, M1, NBT), b=(N2, 2, M1, NBT), F=(2 * N2, 2 * M2),
                  d=(2 * M2, M1 * NBT), d3=(2 * M2, M1, NBT), e=(2560, 64),
                  X=(N2, NBT, 2 * M1), M=(N2, 2 * M1, 2 * M1), g=(N2, 2, M1, NBT),
                  Fb=(2 * N2, 2 * M2), db=(2 * M2, M1 * NBT))
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in shapes.items():
        v = np.ones(s) if ones else rng.standard_normal(s)
        dtype = torch.bfloat16 if k in ("Fb", "db") else torch.float32
        out[k] = torch.as_tensor(v, dtype=torch.float32, device=device).to(dtype)
    return out


def bodies(d):
    """(JAX tool's label, count name, kernel, plain) of each body, in order."""
    return [
        ("reshape [64,32,128]->[64,4096]", "op_transpose[view1]",
         lambda: op.reshape_copy(d["a"], (2 * M2, M1 * NBT), "view1"),
         lambda: op.reshape_copy_plain(d["a"], (2 * M2, M1 * NBT), "view1")),
        ("transpose [64,2,32,128] (2,1,0,3)", "op_transpose[perm2]",
         lambda: op.permute(d["b"], (2, 1, 0, 3), "perm2"),
         lambda: op.permute_plain(d["b"], (2, 1, 0, 3), "perm2")),
        ("dot [128,64]@[64,4096] f32", "op_gemm[dot3]",
         lambda: op.mosaic_dot(d["F"], d["d"], "highest", "dot3"),
         lambda: op.mosaic_dot_plain(d["F"], d["d"], "highest", "dot3")),
        ("dot 2D lhs x 3D rhs (contract dim0)", "op_gemm[dot4][default]",
         lambda: op.mosaic_dot(d["F"], d["d3"], "default", "dot4"),
         lambda: op.mosaic_dot_plain(d["F"], d["d3"], "default", "dot4")),
        ("reshape [2560,64]->[80,32,64]", "op_transpose[view5]",
         lambda: op.reshape_copy(d["e"], (80, 32, 64), "view5"),
         lambda: op.reshape_copy_plain(d["e"], (80, 32, 64), "view5")),
        ("batched dot [64,128,64]@[64,64,64]", "op_gemm[dot6][default]",
         lambda: op.mosaic_dot(d["X"], d["M"], "default", "dot6"),
         lambda: op.mosaic_dot_plain(d["X"], d["M"], "default", "dot6")),
        ("reshape [64,2,32,128]->[128,32,128]", "op_transpose[view7]",
         lambda: op.reshape_copy(d["g"], (2 * N2, M1, NBT), "view7"),
         lambda: op.reshape_copy_plain(d["g"], (2 * N2, M1, NBT), "view7")),
        ("dot bf16 [128,64]@[64,4096] accum f32", "op_gemm[dot8][bf16]",
         lambda: op.mosaic_dot(d["Fb"], d["db"], "highest", "dot8"),
         lambda: op.mosaic_dot_plain(d["Fb"], d["db"], "highest", "dot8")),
    ]


def main(device="cuda"):
    device = device_of(device)
    header("probe_mosaic_ops", device)
    res = {}
    for label, name, kernel, plain in bodies(make_inputs(device)):
        ms = mean_ms(kernel, device)
        out = kernel()
        err, rel = vs_plain(out, plain())
        res[name] = ms
        print(f"{label:56s}: OK {tuple(out.shape)}  {ms:8.4f} ms  vs plain max_abs_err "
              f"{err:.2e} rel {rel:.2e}", flush=True)
    return res


if __name__ == "__main__":
    main()
