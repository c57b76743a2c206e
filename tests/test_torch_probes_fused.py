"""The planar and fused-micro probes of dftk_tpu_torch against the JAX bodies.

`tools/probe_kernel_planar.py` (k_planar, k_planar_bf) and
`tools/bench_fused_micro.py` (kernel_full, kernel_swaponly) keep their
Pallas bodies unedited; they are captured in the test by
`tests/data/make_torch_port_setup.py::capture` (which records
test_torch_probes.py's JAX side): each tool is loaded from its file with
small shape globals, `pl.pallas_call` is replaced by an interpret-mode
recorder and `main()` runs under `jax.disable_jit()`. The recorder raises
once it has recorded a call, and each tool's own harness (`run`, `timeit`)
catches that as a failed timing and goes on to its next body, so every body
runs once, not LOOP or 4 x 10 times. The recorded inputs go into the port's
plain versions
(`kernels/filter_stages.py::probe_planar_plain`,
`kernels/fused_micro.py::micro_{full,swaponly}_plain`):
  * f32 (k_planar, kernel_full on one application) within 1e-5 of max|out|;
  * k_planar_bf: the port's difference from JAX at least 10x below the
    port's own 'default'-vs-'highest' difference (both round the same
    operands to bf16 and sum in f32 in other orders);
  * kernel_swaponly exactly (a broadcast and an add of the same values).
The CUDA kernels run only on a GPU: tests/test_torch_cuda.py holds them
against these plain versions there.
"""
import importlib

import numpy as np
import pytest
import torch

from dftk_tpu_torch.kernels import filter_stages as fs
from dftk_tpu_torch.kernels import fused_micro as fm
from dftk_tpu_torch.kernels import local_apply as la
from dftk_tpu_torch.tools import probe_harness
from test_torch_probes import BAR, SMALL, make

_capture, _first = make.capture, make.first_record

MICRO_SMALL = dict(NB=2, M=4, N=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def captured():
    return {"probe_kernel_planar": _capture("probe_kernel_planar", stop_after_first=True),
            "bench_fused_micro": _capture("bench_fused_micro", stop_after_first=True,
                                          small=MICRO_SMALL)}


def _close(out, ref, what):
    err = np.max(np.abs(out - ref))
    print(f"{what}: port vs JAX max_abs_err {err:.1e} (max|out| {np.max(np.abs(ref)):.1e})")
    assert out.shape == ref.shape and out.dtype == np.float32
    assert err <= BAR * np.max(np.abs(ref))


def _planar(rec, precision="highest"):
    t, V, *factors = (torch.as_tensor(a) for a in rec["args"])
    return fs.probe_planar_plain(t, V, factors, precision).numpy()


def test_each_body_ran_once(captured):
    for tool, bodies in (("probe_kernel_planar", ["k_planar", "k_planar_bf"]),
                         ("bench_fused_micro", ["kernel_full", "kernel_swaponly"])):
        assert [r["name"] for r in captured[tool][1]] == bodies


def test_planar_plain_matches_k_planar(captured):
    rec = _first(captured["probe_kernel_planar"][1], "k_planar")
    assert rec["out"].shape == (SMALL["n3"], 2, SMALL["m2"], SMALL["m1"], SMALL["nbt"])
    _close(_planar(rec), rec["out"], "k_planar")


def test_planar_bf16_plain_matches_k_planar_bf(captured):
    rec = _first(captured["probe_kernel_planar"][1], "k_planar_bf")
    port = _planar(rec, "default")
    err = np.max(np.abs(port - rec["out"]))
    rounding = np.max(np.abs(port - _planar(rec)))
    print(f"k_planar_bf: port vs JAX at 'default' {err:.1e}; port 'default' vs "
          f"'highest' {rounding:.1e}")
    assert err * 10 <= rounding


def _micro(rec):
    return [torch.as_tensor(a) for a in rec["args"]]


def test_micro_full_plain_matches_kernel_full(captured):
    rec = _first(captured["bench_fused_micro"][1], "kernel_full")
    xr, xi, V, F, G = _micro(rec)
    out = np.stack([o.numpy() for o in fm.micro_full_plain(xr, xi, V, F, G)])
    _close(out, rec["out"], "kernel_full, one application")


def test_micro_swaponly_plain_equals_kernel_swaponly(captured):
    rec = _first(captured["bench_fused_micro"][1], "kernel_swaponly")
    xr, xi = _micro(rec)[:2]
    out = np.stack([o.numpy() for o in fm.micro_swaponly_plain(xr, xi, MICRO_SMALL["N"])])
    assert out.shape == rec["out"].shape and out.dtype == np.float32
    assert np.array_equal(out, rec["out"])


@pytest.mark.parametrize("tool, small", [("probe_kernel_planar", dict(SMALL, LOOP=2)),
                                         ("bench_fused_micro", dict(MICRO_SMALL, CHAIN=2,
                                                                    ITERS=1))])
def test_tool_main_on_cpu(tool, small, monkeypatch, capsys):
    mod = importlib.import_module(f"dftk_tpu_torch.tools.{tool}")
    for k, v in small.items():
        monkeypatch.setattr(mod, k, v)
    fs.counts.reset()
    fm.counts.reset()
    res = mod.main(device="cpu")
    printed = capsys.readouterr().out
    assert "CPU, plain versions" in printed and "max_abs_err 0.00e+00" in printed
    assert len(res) == 2 and all(np.isfinite(v) and v > 0 for v in res.values())
    for c in (fs.counts, fm.counts):
        assert set(c.launches.values()) == {0}
    assert sum(fs.counts.plain.values()) + sum(fm.counts.plain.values()) > 0
    assert la._library is None


@pytest.mark.parametrize("tool", ["probe_kernel_planar", "bench_fused_micro"])
def test_tool_main_needs_a_card_unless_asked(tool, monkeypatch):
    mod = importlib.import_module(f"dftk_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main()


def _planar_inputs(seed=3):
    dims = [SMALL[k] for k in ("n3", "m1", "m2", "n1", "n2", "nbt")]
    return probe_harness.make_planar_inputs(seed, *dims, "cpu")


def _micro_inputs(K=2, NB=2, M=4, N=8):
    rng = np.random.default_rng(5)
    conv = lambda s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    return (conv((K, NB, M, M, M)), conv((K, NB, M, M, M)), conv((K, N, N, N)),
            conv((2 * M, 2 * N)), conv((2 * N, 2 * M)))


def test_cpu_tensors_take_the_plain_versions():
    t, V, P = _planar_inputs()
    xr, xi, Vm, F, G = _micro_inputs()
    fs.counts.reset()
    fm.counts.reset()
    for prec in ("highest", "default"):
        assert torch.equal(fs.probe_planar(t, V, P, prec), fs.probe_planar_plain(t, V, P, prec))
    assert all(torch.equal(a, b) for a, b in zip(fm.micro_full(xr, xi, Vm, F, G),
                                                 fm.micro_full_plain(xr, xi, Vm, F, G)))
    assert all(torch.equal(a, b) for a, b in zip(fm.micro_swaponly(xr, xi, 8),
                                                 fm.micro_swaponly_plain(xr, xi, 8)))
    assert fs.counts.plain["probe_planar"] == fs.counts.plain["probe_planar[bf16]"] == 2
    assert fm.counts.plain == {"micro_full": 2, "micro_swaponly": 2}
    assert set(fs.counts.launches.values()) == {0} and set(fm.counts.launches.values()) == {0}
    assert la._library is None


def test_micro_full_uses_the_band_s_own_potential():
    """Band (k, t) multiplies by V[k]: each k of the batch equals a run alone."""
    xr, xi, V, F, G = _micro_inputs()
    both = fm.micro_full_plain(xr, xi, V, F, G)
    for k in range(2):
        one = fm.micro_full_plain(xr[k:k + 1], xi[k:k + 1], V[k:k + 1], F, G)
        for a, b in zip(both, one):
            assert float((a[k:k + 1] - b).abs().max()) <= BAR * float(b.abs().max())


def test_wrappers_refuse_bad_inputs():
    t, V, P = _planar_inputs()
    with pytest.raises(ValueError, match="precision"):
        fs.probe_planar(t, V, P, "tensor32")
    with pytest.raises(ValueError, match="factors"):
        fs.probe_planar(t, V, P[::-1])
    with pytest.raises(ValueError, match="t must be"):
        fs.probe_planar(t.transpose(1, 2), V, P)
    xr, xi, Vm, F, G = _micro_inputs()
    with pytest.raises(ValueError, match="F \\[2M, 2N\\]"):
        fm.micro_full(xr, xi, Vm, G, F)
    with pytest.raises(ValueError, match="V \\[K, N, N, N\\]"):
        fm.micro_full(xr, xi, Vm[:1], F, G)
    with pytest.raises(ValueError, match="M, M, M"):
        fm.micro_swaponly(xr[..., :2], xi[..., :2], 8)


@pytest.mark.parametrize("m, n, strip, smem", [
    ((32, 32), (64, 64), 32, 199680),        # the probe's shapes: two strips
    ((4, 4), (8, 8), 8, 4480),
])
def test_planar_shared_memory(m, n, strip, smem):
    assert fs.probe_planar_strip(*m, *n) == strip
    assert fs.probe_planar_smem(*m, *n, strip) == smem <= la.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        fs.probe_planar_strip(128, 128, 256, 256)


def test_chip_smoke_library_calls_match_plain():
    """chip_smoke.py times one PyTorch call per new kernel as its library
    version: each must compute the plain version's function."""
    import chip_smoke
    t, V, P = _planar_inputs()
    ref = fs.probe_planar_plain(t, V, P)
    lib = chip_smoke.planar_as_real(chip_smoke.planar_library(t, V, P)())
    assert lib.shape == ref.shape
    assert float((lib - ref).abs().max()) <= BAR * float(ref.abs().max())
    xr, xi, Vm, F, G = _micro_inputs()
    ref = torch.stack(fm.micro_full_plain(xr, xi, Vm, F, G))
    lib = chip_smoke.micro_full_library(xr, xi, Vm, F, G)()
    assert lib.shape == ref.shape
    assert float((lib - ref).abs().max()) <= BAR * float(ref.abs().max())
    ref = torch.stack(fm.micro_swaponly_plain(xr, xi, 8))
    assert torch.equal(torch.stack(chip_smoke.swaponly_library(xr, xi)()), ref)
