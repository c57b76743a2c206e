"""Time the local apply and the Si54 split SCF of several checkouts in turns,
on one CUDA card.

    python -m dftk_tpu_torch.tools.compare_trees TREE [TREE ...]

Each TREE is the root of a checkout (for example one unpacked from `git
archive`) with its own `chip_smoke.py` and `dftk_tpu_torch`.  Every tree's
kernel library is built first, all at once, into the tree's own `build/`;
then each tree runs, in its own process and in the order given (for a
parent P and a change C: `P C C P`), phase 3 of its `chip_smoke.py` (its
kernels against their plain versions at the Si54 shapes, with CUDA-event
times) and phase c (the Si54 split CheFSI SCF, float64, "mixed" filter),
timed on the host clock ending in a synchronize; and phase a (the bf16
kernels against their plain versions), with the device time per call
(torch.profiler) of the bf16 kernel A forward, kernel B and A+B+A at Si54
and of kernel A forward and kernel B on one 256-band chunk at the Si256
shapes (random data).  Prints one JSON line per run: the tree, the
complex128 and bf16 ms of kernel A forward, kernel B and A+B+A (one launch,
CUDA events), the bf16 device times, and the SCF's wall seconds,
iterations and energy error.
"""
import json
import os
import subprocess
import sys

_BUILD = "from dftk_tpu_torch.kernels import local_apply as la; la.library()"

_RUN = r"""
import json, time, types
import torch
import chip_smoke as cs
import dftk_tpu_torch as dt
from dftk_tpu_torch.kernels import local_apply as la
from dftk_tpu_torch.tools.run_si_big import build_bench_basis
with open("tests/data/torch_port_si54.json") as f:
    E_ref = json.load(f)["total_energy"]
device = torch.device("cuda", 0)
basis = build_bench_basis(3, 10.0, device)
timings, inputs = cs.kernel_phase(la, basis, device)
result = {"ms": {n: timings[n]["ms"] for n in ("pruned_axis_dft", "local_plane", "local_apply")}}
# bf16: phase a's checks and one-launch times, and device times per call
bf = cs.bf16_phase(la, basis, device, inputs)
names = ("pruned_axis_dft[bf16]", "local_plane[bf16]", "local_apply[bf16]")
result["ms_bf16"] = {n: bf[n]["ms"] for n in names}
fac = la.LocalFactors(fwd=tuple(f.to(torch.complex64) for f in basis.pruned.factors.fwd),
                      bwd=tuple(f.to(torch.complex64) for f in basis.pruned.factors.bwd))
xc = torch.as_tensor(inputs[0], device=device).to(torch.complex64)
V = torch.as_tensor(inputs[1], device=device).to(torch.float32)
t = la.pruned_axis_dft(xc, fac.fwd[2], True, "default")
calls = (lambda: la.pruned_axis_dft(xc, fac.fwd[2], True, "default"),
         lambda: la.local_plane(t, V, fac, precision="default"),
         lambda: la.local_apply(xc, V, fac, "default"))
result["device_ms_bf16"] = {n: cs.device_ms(f) for n, f in zip(names, calls)}
# one 256-band chunk at the Si256 shapes (random data and factors)
g = torch.Generator(device=device).manual_seed(5)
cr = lambda *s: torch.randn(*s, dtype=torch.complex64, device=device, generator=g)
(m1, m2, m3), (n1, n2, n3) = (64, 64, 32), (120, 120, 64)
fac = la.LocalFactors(fwd=(cr(m1, n1) / 8, cr(m2, n2) / 8, cr(m3, n3) / 6),
                      bwd=(cr(n1, m1) / 11, cr(n2, m2) / 11, cr(n3, m3) / 8))
x, t = cr(1, 256, m1, m2, m3), cr(1, 256, n3, m1, m2)
V = torch.randn(1, n3, n1, n2, device=device, generator=g)
calls = (lambda: la.pruned_axis_dft(x, fac.fwd[2], True, "default"),
         lambda: la.local_plane(t, V, fac, precision="default"))
result["si256_device_ms_bf16"] = {n: cs.device_ms(f, n=5) for n, f in zip(names, calls)}
del x, t, V

def scf(*args, **kw):           # the phase's SCF call, its result recorded
    res = dt.self_consistent_field_split(*args, **kw)
    result.update(n_iter=res["n_iter"], dE=res["energies"]["total"] - E_ref)
    return res

torch.cuda.synchronize()
t0 = time.time()
cs.split_scf_phase(types.SimpleNamespace(self_consistent_field_split=scf), la, basis, E_ref)
result["scf_wall_s"] = time.time() - t0
print("COMPARE " + json.dumps(result), flush=True)
"""


def _env(tree):
    return dict(os.environ, PYTHONPATH=tree)


def main(argv=None):
    trees = [os.path.abspath(t) for t in (sys.argv[1:] if argv is None else argv)]
    if not trees:
        raise SystemExit(__doc__)
    builds = {t: subprocess.Popen([sys.executable, "-c", _BUILD], cwd=t, env=_env(t))
              for t in sorted(set(trees))}
    for tree, proc in builds.items():
        if proc.wait() != 0:
            raise SystemExit(f"building the kernels of {tree} failed")
    for i, tree in enumerate(trees):
        out = subprocess.run([sys.executable, "-c", _RUN], cwd=tree, env=_env(tree),
                             capture_output=True, text=True)
        line = [x for x in out.stdout.splitlines() if x.startswith("COMPARE ")]
        if out.returncode != 0 or not line:
            raise SystemExit(f"run {i} in {tree} failed:\n{out.stdout[-3000:]}\n"
                             f"{out.stderr[-3000:]}")
        result = json.loads(line[0][len("COMPARE "):])
        print(json.dumps({"run": i, "tree": tree, **result}), flush=True)


if __name__ == "__main__":
    main()
