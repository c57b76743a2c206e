"""The filter-stage probes of dftk_tpu_torch against the JAX probe kernels.

The JAX probes (`tools/probe_pallas_fixed.py`, `tools/probe_kernel_pipe.py`,
`tools/probe_kernel_variants.py`, `tools/probe_kernel_incr.py`) keep their
Pallas bodies as closures inside `main()`.  They are reached without editing
`tools/`: each module is loaded from its file, its shape globals are set
small, `pl.pallas_call` is replaced by a recorder that builds the call with
`interpret=True` and keeps every call's kernel, inputs and output, and
`main()` runs under `jax.disable_jit()`.  The plain PyTorch versions of
`dftk_tpu_torch/kernels/filter_stages.py` then run on the recorded inputs:
  * f32 stage sets within 1e-5 of max|out| (the two sum in other orders);
  * 'full' at 'default' (k_full_bf): the port's difference from JAX at least
    10x below the port's own 'default'-vs-'highest' difference (both round
    the same operands to bf16 and sum in f32 in other orders);
  * k_dots and k_mdim print FAIL in the JAX run (faults of the reference);
    'dots' is held against the test's jnp transcription of k_dots with its
    two shape faults repaired, and k_mdim's inputs (4-D factors viewed as
    2-D) go through the JAX k_full body and the port's 'full'.
The CUDA kernels run only on a GPU: tests/test_torch_cuda.py holds them
against these plain versions there.
"""
import contextlib
import importlib
import importlib.util
import io
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from dftk_tpu_torch.kernels import filter_stages as fs
from dftk_tpu_torch.kernels import local_apply as la
from dftk_tpu_torch.tools import probe_harness

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
SMALL = dict(m1=4, m2=4, n1=8, n2=8, n3=8, nbt=8)
BAR = 1e-5


class _Stop(Exception):
    pass


def _capture(name, stop_after_first=False, loop1_run=False):
    """Run tools/<name>.py's main() at the SMALL shapes with every Pallas
    call recorded in interpret mode; returns (module, records, printed)."""
    records = []
    real = pl.pallas_call

    def recorder(kernel, **kw):
        f = real(kernel, interpret=True, **kw)

        def call(*args):
            rec = dict(name=kernel.__name__, kernel=kernel, kw=kw,
                       args=[np.array(a) for a in args])
            records.append(rec)
            out = f(*args)
            rec["out"] = np.asarray(out)
            if stop_after_first:
                raise _Stop
            return out
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(os.environ, "DFTK_TPU_X64", os.environ.get("DFTK_TPU_X64", "0"))
        mp.setattr(sys, "path", list(sys.path))
        mp.setattr(pl, "pallas_call", recorder)
        spec = importlib.util.spec_from_file_location(f"_jax_{name}", TOOLS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for k, v in SMALL.items():
            setattr(mod, k, v)
        if hasattr(mod, "LOOP"):
            mod.LOOP = 1
        if loop1_run:          # probe_kernel_pipe's run() takes its loop length
            run = mod.run
            mp.setattr(mod, "run", lambda nm, f, extra, loop=1: run(nm, f, extra, loop=1))
        np.random.seed(0)
        buf = io.StringIO()
        with jax.disable_jit(), contextlib.redirect_stdout(buf):
            try:
                mod.main()
            except _Stop:
                pass
    return mod, records, buf.getvalue()


@pytest.fixture(scope="module")
def captured():
    return {"probe_pallas_fixed": _capture("probe_pallas_fixed", stop_after_first=True),
            "probe_kernel_pipe": _capture("probe_kernel_pipe", loop1_run=True),
            "probe_kernel_variants": _capture("probe_kernel_variants"),
            "probe_kernel_incr": _capture("probe_kernel_incr")}


def _first(records, name, grid=None):
    for r in records:
        if r["name"] == name and "out" in r and (grid is None or r["kw"]["grid"] == grid):
            return r
    raise AssertionError(f"no recorded call of {name} (grid {grid})")


def _port(rec, stages, precision="highest", zblk=1):
    t, V, *factors = (torch.as_tensor(a) for a in rec["args"])
    return fs.probe_stages_plain(t, V, factors or None, stages, precision, zblk).numpy()


def _close(out, ref, what):
    err = np.max(np.abs(out - ref))
    print(f"{what}: port vs JAX max_abs_err {err:.1e} (max|out| {np.max(np.abs(ref)):.1e})")
    assert out.shape == ref.shape and out.dtype == np.float32
    assert err <= BAR * np.max(np.abs(ref))


@pytest.mark.parametrize("tool, kernel, grid", [
    ("probe_pallas_fixed", "k0", (8,)),
    ("probe_kernel_pipe", "k0", (8,)),
    ("probe_kernel_pipe", "k0", (1,)),
    ("probe_kernel_incr", "k0", (8,)),
])
def test_copy_plain_matches_jax(captured, tool, kernel, grid):
    rec = _first(captured[tool][1], kernel, grid)
    out = fs.probe_copy_plain(torch.as_tensor(rec["args"][0])).numpy()
    _close(out, rec["out"], f"{tool} {kernel} grid {grid}")


@pytest.mark.parametrize("tool, kernel, grid, stages", [
    ("probe_kernel_incr", "k1", None, "f2"),
    ("probe_kernel_incr", "k1b", None, "f2"),
    ("probe_kernel_incr", "k2", None, "f2_rep"),
    ("probe_kernel_incr", "k3", None, "f2_rep_f1"),
    ("probe_kernel_incr", "k4", None, "full"),
    ("probe_kernel_variants", "k_full", None, "full"),
    ("probe_kernel_variants", "k_rep", None, "rep"),
    ("probe_kernel_pipe", "k4", (8,), "full"),
    ("probe_kernel_pipe", "k4", (2,), "full"),
    ("probe_kernel_pipe", "k4", (1,), "full"),
])
def test_stages_plain_matches_jax(captured, tool, kernel, grid, stages):
    rec = _first(captured[tool][1], kernel, grid)
    zblk = SMALL["n3"] // rec["kw"]["grid"][0]
    _close(_port(rec, stages, zblk=zblk), rec["out"], f"{tool} {kernel} as {stages}")


def test_bf16_full_plain_matches_k_full_bf(captured):
    rec = _first(captured["probe_kernel_variants"][1], "k_full_bf")
    port = _port(rec, "full", "default")
    err = np.max(np.abs(port - rec["out"]))
    rounding = np.max(np.abs(port - _port(rec, "full")))
    print(f"k_full_bf: port vs JAX at 'default' {err:.1e}; port 'default' vs "
          f"'highest' {rounding:.1e}")
    assert err * 10 <= rounding


@pytest.mark.parametrize("line", ["dots only (no repairs, f32)",
                                  "multi-dim dot absorbs fwd repair (f32)"])
def test_reference_bodies_fail_in_jax(captured, line):
    """k_dots fails in its math at its own shapes, k_mdim in its harness."""
    printed = captured["probe_kernel_variants"][2]
    row = next(r for r in printed.splitlines() if r.startswith(line))
    assert ": FAIL " in row, row


def test_dots_plain_matches_repaired_k_dots(captured):
    mod, records, _ = captured["probe_kernel_variants"]
    rec = _first(records, "k_full")
    t, V, F2f, F1f, F1b, F2b = (jnp.asarray(a) for a in rec["args"])
    n3, m2, _, m1, nbt = t.shape
    n1, n2 = V.shape[1:]
    planes = []
    for z in range(n3):
        # k_dots (tools/probe_kernel_variants.py:84-93) with its two shape
        # faults repaired: B read as [2m1, n2] (not [2n1, m1]), and V[z][:, 0]
        # one scale per n1 row of C [n1, 2, n2] (not a 5-D broadcast)
        A = t[z].reshape(2 * m2, m1, nbt)
        B = mod.dot_hi(F2f, A)
        C = mod.dot_hi(F1f, B.reshape(2 * m1, n2, nbt))
        Cv = C.reshape(n1, 2, n2, nbt) * V[z][:, 0][:, None, None, None]
        D = mod.dot_hi(F1b, Cv.reshape(2 * n1, n2, nbt))
        planes.append(mod.dot_hi(F2b, D.reshape(2 * n2, m1, nbt)).reshape(m2, 2, m1, nbt))
    ref = np.asarray(jnp.stack(planes))
    _close(_port(rec, "dots"), ref, "k_dots repaired as dots")


def test_mdim_is_full_with_2d_factors(captured):
    records = captured["probe_kernel_variants"][1]
    mdim = next(r for r in records if r["name"] == "k_mdim")
    full = _first(records, "k_full")
    t, V, F2f, F1f4, F1b4, F2b = mdim["args"]
    n1, _, m1, _ = F1f4.shape
    args = [t, V, F2f, F1f4.reshape(2 * n1, 2 * m1), F1b4.reshape(2 * m1, 2 * n1), F2b]
    ref = np.asarray(pl.pallas_call(full["kernel"], interpret=True, **full["kw"])(
        *(jnp.asarray(a) for a in args)))
    _close(_port(dict(args=args), "full"), ref, "k_mdim inputs as full")


@pytest.mark.parametrize("tool", ["probe_pallas_fixed", "probe_kernel_pipe",
                                  "probe_kernel_variants", "probe_kernel_incr"])
def test_tool_main_on_cpu(tool, monkeypatch, capsys):
    mod = importlib.import_module(f"dftk_tpu_torch.tools.{tool}")
    for k, v in SMALL.items():
        monkeypatch.setattr(mod, k, v)
    if hasattr(mod, "LOOP"):
        monkeypatch.setattr(mod, "LOOP", 2)
    fs.counts.reset()
    res = mod.main(device="cpu")
    printed = capsys.readouterr().out
    assert "CPU, plain versions" in printed and "FAIL" not in printed
    assert set(fs.counts.launches.values()) == {0} and sum(fs.counts.plain.values()) > 0
    assert la._library is None
    if tool == "probe_pallas_fixed":
        assert np.isfinite(res["slope_ms"]) and set(res["copy_per_iter"]) == set(mod.LOOPS)
    else:
        assert all(np.isfinite(v) and v > 0 for v in res.values())
        assert "max_abs_err 0.00e+00" in printed


@pytest.mark.parametrize("stages", ["f2", "f2_rep", "f2_rep_f1", "full", "rep", "dots"])
def test_chip_smoke_library_call_matches_plain(stages):
    """chip_smoke.py times one PyTorch call per f32 stage set as its library
    version: it must compute the plain version's function."""
    import chip_smoke
    dims = [SMALL[k] for k in ("n3", "m1", "m2", "n1", "n2", "nbt")]
    t, V, F = probe_harness.make_inputs(3, *dims, 1.0, 4, "cpu")
    lib = chip_smoke.stage_library(stages, t, V, F)
    ref = fs.probe_stages_plain(t, V, None if stages == "rep" else F, stages)
    assert lib().shape == ref.shape
    assert float((lib() - ref).abs().max()) <= BAR * float(ref.abs().max())
    if stages == "dots":       # the relabeling needs n2 = 2 m1
        dims[1] += 1
        t, V, F = probe_harness.make_inputs(3, *dims, 1.0, 4, "cpu")
        assert chip_smoke.stage_library(stages, t, V, F) is None


def test_tool_main_needs_a_card_unless_asked(monkeypatch):
    from dftk_tpu_torch.tools import probe_kernel_incr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_kernel_incr.main()


@pytest.mark.parametrize("stages, precision", [("full", "tensor32"), ("f2", "default"),
                                               ("rep", "default"), ("swap", "highest")])
def test_stages_refuse_unknown_instantiations(stages, precision):
    t = torch.zeros((2, 4, 2, 4, 4))
    with pytest.raises(ValueError):
        fs.probe_stages(t, torch.zeros((2, 8, 8)), None, stages, precision)


def test_stages_refuse_bad_shapes():
    t, V = torch.zeros((2, 4, 2, 4, 4)), torch.zeros((2, 8, 8))
    F = tuple(torch.zeros(s) for s in ((16, 8), (16, 8), (8, 16), (8, 16)))
    with pytest.raises(ValueError, match="zblk"):
        fs.probe_stages(t, V, F, "full", zblk=3)
    with pytest.raises(ValueError, match="factors"):
        fs.probe_stages(t, V, F[::-1], "full")
    fs.probe_stages(t, V, F, "full", zblk=2)


@pytest.mark.parametrize("stages, m, n, strip, smem", [
    ("full", (32, 32), (64, 64), 32, 196608),     # the probes' shapes
    ("f2", (32, 32), (64, 64), None, 131072),
    ("rep", (32, 32), (64, 64), None, 65536),
    ("full", (4, 4), (8, 8), 8, 4096),
])
def test_stages_shared_memory(stages, m, n, strip, smem):
    if strip is not None:
        assert fs.probe_stages_strip(*m, *n) == strip
    assert fs.probe_stages_smem(stages, *m, *n, strip or 0) == smem
    assert smem <= la.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        fs.probe_stages_strip(128, 128, 256, 256)
