"""Planar-re/im transpose-free fused filter kernel probe.

    python -m dftk_tpu_torch.tools.probe_kernel_planar

Port of `tools/probe_kernel_planar.py` on its shapes (t [n3, 2, m2, m1, nbt]
f32 / 8, the re and im planes of each z-plane; V [n3, n1, n2]; eight real
factors / 8), chains of LOOP launches of `probe_planar`: the planar chain
in f32, then with bf16 operands (one pass, f32 sums).  Prints ms per launch
and the kernel-vs-plain error of one application; returns the times.
"""
from dftk_tpu_torch.tools.probe_harness import (device_of, header, make_planar_inputs,
                                                planar_line)

m1 = m2 = 32
n1 = n2 = n3 = 64
nbt = 128
LOOP = 20


def main(device="cuda"):
    device = device_of(device)
    header("probe_kernel_planar", device)
    t1, V, ex = make_planar_inputs(0, n3, m1, m2, n1, n2, nbt, device)
    res = {}
    planar_line(res, "planar f32 (transpose-free)", t1, V, ex, LOOP)
    planar_line(res, "planar bf16 1-pass (transpose-free)", t1, V, ex, LOOP, "default")
    return res


if __name__ == "__main__":
    main()
