"""The filter-stage probes of dftk_tpu_torch against the JAX probe kernels.

The JAX probes (`tools/probe_pallas_fixed.py`, `tools/probe_kernel_pipe.py`,
`tools/probe_kernel_variants.py`, `tools/probe_kernel_incr.py`) keep their
Pallas bodies as closures inside `main()`.  tests/data/make_torch_port_setup.py
(entry `probes`) reaches them without editing `tools/`: each module is
loaded from its file, its shape globals are set small, `pl.pallas_call` is
replaced by a recorder that builds the call with `interpret=True` and keeps
every call's kernel, inputs and output, and `main()` runs under
`jax.disable_jit()`; tests/data/torch_port_setup.json holds the inputs and
outputs of the calls held here, so this file runs no JAX code.  The plain
PyTorch versions of `dftk_tpu_torch/kernels/filter_stages.py` then run on
the recorded inputs:
  * f32 stage sets within 1e-5 of max|out| (the two sum in other orders);
  * 'full' at 'default' (k_full_bf): the port's difference from JAX at least
    10x below the port's own 'default'-vs-'highest' difference (both round
    the same operands to bf16 and sum in f32 in other orders);
  * k_dots and k_mdim print FAIL in the JAX run (faults of the reference);
    'dots' is held against the data script's jnp transcription of k_dots
    with its two shape faults repaired, and k_mdim's inputs (4-D factors
    viewed as 2-D) go through the JAX k_full body and the port's 'full'.
The CUDA kernels run only on a GPU: tests/test_torch_cuda.py holds them
against these plain versions there.
"""
import importlib
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from dftk_tpu_torch.kernels import filter_stages as fs
from dftk_tpu_torch.kernels import local_apply as la
from dftk_tpu_torch.tools import probe_harness

DATA = pathlib.Path(__file__).resolve().parent / "data"
_spec = importlib.util.spec_from_file_location("make_setup", DATA / "make_torch_port_setup.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
with open(DATA / "torch_port_setup.json") as _f:
    REF = json.load(_f)["probes"]
SMALL = make.SMALL
BAR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


def _record(call):
    return dict(args=[make.from_b64(a).copy() for a in call["args"]],
                kw=dict(grid=tuple(call["grid"])),
                out=None if call["out"] is None else make.from_b64(call["out"]))


@pytest.fixture(scope="module")
def captured():
    """(tool, kernel, grid or None) -> the recorded call."""
    out = {}
    for (tool, kernel, grid), call in zip(make.PROBE_CALLS, REF["calls"], strict=True):
        assert (call["tool"], call["kernel"]) == (tool, kernel)
        out[tool, kernel, grid] = _record(call)
    return out


def _first(captured, tool, name, grid=None):
    return captured[tool, name, grid]


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
    rec = _first(captured, tool, kernel, grid)
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
    rec = _first(captured, tool, kernel, grid)
    zblk = SMALL["n3"] // rec["kw"]["grid"][0]
    _close(_port(rec, stages, zblk=zblk), rec["out"], f"{tool} {kernel} as {stages}")


def test_bf16_full_plain_matches_k_full_bf(captured):
    rec = _first(captured, "probe_kernel_variants", "k_full_bf")
    port = _port(rec, "full", "default")
    err = np.max(np.abs(port - rec["out"]))
    rounding = np.max(np.abs(port - _port(rec, "full")))
    print(f"k_full_bf: port vs JAX at 'default' {err:.1e}; port 'default' vs "
          f"'highest' {rounding:.1e}")
    assert err * 10 <= rounding


@pytest.mark.parametrize("line", make.FAIL_LINES)
def test_reference_bodies_fail_in_jax(line):
    """k_dots fails in its math at its own shapes, k_mdim in its harness."""
    row = REF["fail_rows"][line]
    assert row.startswith(line) and row.endswith(": FAIL"), row


def test_dots_plain_matches_repaired_k_dots(captured):
    rec = _first(captured, "probe_kernel_variants", "k_full")
    _close(_port(rec, "dots"), make.from_b64(REF["dots_ref"]), "k_dots repaired as dots")


def test_mdim_is_full_with_2d_factors(captured):
    t, V, F2f, F1f4, F1b4, F2b = _first(captured, "probe_kernel_variants", "k_mdim")["args"]
    n1, _, m1, _ = F1f4.shape
    args = [t, V, F2f, F1f4.reshape(2 * n1, 2 * m1), F1b4.reshape(2 * m1, 2 * n1), F2b]
    _close(_port(dict(args=args), "full"), make.from_b64(REF["mdim_ref"]),
           "k_mdim inputs as full")


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
