"""Pipeline diagnostics: launch settings, chain length, planes per block.

    python -m dftk_tpu_torch.tools.probe_kernel_pipe

Port of `tools/probe_kernel_pipe.py` on the probes' shapes (t [n3, m2, 2,
m1, nbt] f32, V [n3, n1, n2], factors / 64): `probe_copy` with one plane
per block in chains of LOOP and 2 LOOP launches and with zblk = 8 planes per
block, and the full chain (`probe_stages` 'full') with zblk = 1, 4 and 8.
The JAX tool's three `dimension_semantics` settings of the copy have no
Hopper counterpart (blocks run in parallel, in no order): they are one
launch and one line here.  Prints ms per launch and the kernel-vs-plain
error of one application; returns the times.
"""
from dftk_tpu_torch.tools.probe_harness import (copy_line, device_of, header,
                                                make_inputs, stage_line)

m1 = m2 = 32
n1 = n2 = n3 = 64
nbt = 128
LOOP = 20


def main(device="cuda"):
    device = device_of(device)
    header("probe_kernel_pipe", device)
    t1, V, ex = make_inputs(0, n3, m1, m2, n1, n2, nbt, 0.01, 64, device)
    res = {}
    copy_line(res, f"copy zblk=1 semantics=None|parallel|arbitrary loop{LOOP}", t1, LOOP,
              note="one launch: dimension_semantics has no Hopper counterpart")
    copy_line(res, f"copy zblk=1 loop{2 * LOOP}", t1, 2 * LOOP)
    copy_line(res, "copy zblk=8", t1, LOOP, zblk=8)
    for zblk in (1, 4, 8):
        stage_line(res, f"full zblk={zblk}", t1, V, ex, "full", LOOP, zblk=zblk)
    return res


if __name__ == "__main__":
    main()
