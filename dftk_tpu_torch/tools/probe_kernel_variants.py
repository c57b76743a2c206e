"""Time filter-chain kernel variants to find where the cycles go.

    python -m dftk_tpu_torch.tools.probe_kernel_variants

Port of `tools/probe_kernel_variants.py` on the probes' shapes (t [n3, m2,
2, m1, nbt] f32, V [n3, n1, n2], factors / 8), chains of LOOP launches of
`probe_stages`: the full chain; 'dots' (the four dots with reshapes in
place of the repairs, which the JAX body k_dots meant but cannot run at its
shapes); 'rep' (repairs and V only); the full chain fed the 4-D factors
F1f4 [n1, 2, m1, 2] and F1b4 [m1, 2, n1, 2] of k_mdim viewed as 2-D (a
free view: k_mdim's contractions are the full chain's); the full chain with
bf16 operands.  Prints ms per launch and the kernel-vs-plain error of one
application; returns the times.
"""
import numpy as np
import torch

from dftk_tpu_torch.tools.probe_harness import device_of, header, make_inputs, stage_line

m1 = m2 = 32
n1 = n2 = n3 = 64
nbt = 128
LOOP = 20


def main(device="cuda"):
    device = device_of(device)
    header("probe_kernel_variants", device)
    t1, V, ex = make_inputs(0, n3, m1, m2, n1, n2, nbt, 1.0, 8, device)
    rng = np.random.default_rng(1)
    F1f4, F1b4 = (torch.as_tensor(rng.standard_normal(s) / 8, dtype=torch.float32,
                                  device=device)
                  for s in ((n1, 2, m1, 2), (m1, 2, n1, 2)))
    res = {}
    stage_line(res, "full chain (repairs, f32)", t1, V, ex, "full", LOOP)
    stage_line(res, "dots only (no repairs, f32)", t1, V, ex, "dots", LOOP,
               note="reshapes for repairs, V[z, :, 0] per row: the JAX body "
                    "fails at its own shapes")
    stage_line(res, "repairs+V only (no dots)", t1, V, None, "rep", LOOP)
    mdim = (ex[0], F1f4.reshape(2 * n1, 2 * m1), F1b4.reshape(2 * m1, 2 * n1), ex[3])
    stage_line(res, "multi-dim dot absorbs fwd repair (f32)", t1, V, mdim, "full", LOOP,
               note="the full chain on the 4-D factors viewed as 2-D")
    stage_line(res, "full chain (repairs, bf16 1-pass)", t1, V, ex, "full", LOOP,
               precision="default")
    return res


if __name__ == "__main__":
    main()
