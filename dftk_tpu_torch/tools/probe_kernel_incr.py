"""Incremental filter-chain teardown: add one stage at a time.

    python -m dftk_tpu_torch.tools.probe_kernel_incr

Port of `tools/probe_kernel_incr.py` on the probes' shapes (t [n3, m2, 2,
m1, nbt] f32 * 0.01, V [n3, n1, n2], factors / 64), chains of LOOP
launches: the copy, then `probe_stages` 'f2' (F2f and F2b), 'f2_rep' (+ both
repairs), 'f2_rep_f1' (+ F1f and F1b) and 'full' (+ V).  The JAX tool's
k1b differs from k1 only in the lane layout of its right-hand side, which
is free on a GPU: its line runs the same 'f2' launch.  Prints ms per launch
and the kernel-vs-plain error of one application; returns the times.
"""
from dftk_tpu_torch.tools.probe_harness import (copy_line, device_of, header,
                                                make_inputs, stage_line)

m1 = m2 = 32
n1 = n2 = n3 = 64
nbt = 128
LOOP = 20


def main(device="cuda"):
    device = device_of(device)
    header("probe_kernel_incr", device)
    t1, V, ex = make_inputs(0, n3, m1, m2, n1, n2, nbt, 0.01, 64, device)
    res = {}
    copy_line(res, "0 copy only", t1, LOOP)
    stage_line(res, "1 F2f+F2b only (2 dots, 3D rhs)", t1, V, ex, "f2", LOOP)
    stage_line(res, "1b same but 2D rhs (reshape lanes)", t1, V, ex, "f2", LOOP,
               note="the same 'f2' launch as line 1: the 2-D rhs is a Mosaic "
                    "lane layout, free on a GPU")
    stage_line(res, "2 = 1 + two repairs", t1, V, ex, "f2_rep", LOOP)
    stage_line(res, "3 = 2 + F1f+F1b (4 dots total)", t1, V, ex, "f2_rep_f1", LOOP)
    stage_line(res, "4 = full chain (with V mult)", t1, V, ex, "full", LOOP)
    return res


if __name__ == "__main__":
    main()
