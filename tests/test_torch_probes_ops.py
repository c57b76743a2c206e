"""The fused-local-apply op probes of dftk_tpu_torch against the JAX bodies.

`tools/probe_pallas_fused.py` (t_kernel, s_kernel, g_kernel, f_kernel) and
`tools/probe_pallas_fused2.py` (k_a, k_b, k_c) keep their Pallas bodies
unedited; they are captured as in test_torch_probes.py, at the tools' own
full shapes (they are locals of `main()`): each tool is loaded from its
file, `pl.pallas_call` is replaced by an interpret-mode recorder and
`main()` runs under `jax.disable_jit()`.  The recorder raises once it has
recorded a call, and each tool's `run()` catches that as a failed call and
goes on to its next body, so every body runs once (and
probe_pallas_fused's timing loop, which needs a result, not at all).  The
recorded inputs go into the port's plain versions
(`kernels/op_probes.py`): the four transposes exactly, g_kernel, f_kernel
and k_c within 1e-5 of max|out|.  The CUDA kernels run only on a GPU:
tests/test_torch_cuda.py holds them against these plain versions there.
"""
import importlib

import numpy as np
import pytest
import torch

from dftk_tpu_torch.kernels import local_apply as la
from dftk_tpu_torch.kernels import op_probes as op
from test_torch_probes import BAR, _capture, _first

BODIES = {"probe_pallas_fused": ["t_kernel", "s_kernel", "g_kernel", "f_kernel"],
          "probe_pallas_fused2": ["k_a", "k_b", "k_c"]}


@pytest.fixture(scope="module")
def captured():
    return {tool: _capture(tool, stop_after_first=True, small={}) for tool in BODIES}


def _args(captured, tool, body):
    rec = _first(captured[tool][1], body)
    return rec, [torch.as_tensor(a) for a in rec["args"]]


def test_each_body_ran_once(captured):
    for tool, bodies in BODIES.items():
        assert [r["name"] for r in captured[tool][1]] == bodies


@pytest.mark.parametrize("tool, body, plain, shape", [
    ("probe_pallas_fused", "t_kernel", op.t2d_plain, (8192, 32)),
    ("probe_pallas_fused", "s_kernel", op.swap_plain, (2048, 2, 64)),
    ("probe_pallas_fused2", "k_a", op.k_a_plain, (2, 32, 64, 32)),
    ("probe_pallas_fused2", "k_b", op.k_b_plain, (2, 64, 64, 32)),
])
def test_transpose_plain_equals_jax(captured, tool, body, plain, shape):
    rec, (x,) = _args(captured, tool, body)
    out = plain(x).numpy()
    assert out.shape == rec["out"].shape == shape and out.dtype == np.float32
    assert np.array_equal(out, rec["out"])


@pytest.mark.parametrize("tool, body, plain, shape", [
    ("probe_pallas_fused", "g_kernel", op.gemm_plain, (4096, 128)),
    ("probe_pallas_fused", "f_kernel", op.fused_plain, (8, 32, 8192)),
    ("probe_pallas_fused2", "k_c", lambda *a: torch.stack(op.k_c_plain(*a)),
     (2, 2, 32, 32, 64)),
])
def test_f32_plain_matches_jax(captured, tool, body, plain, shape):
    rec, args = _args(captured, tool, body)
    out, ref = plain(*args).numpy(), rec["out"]
    err = np.max(np.abs(out - ref))
    print(f"{body}: port vs JAX max_abs_err {err:.1e} (max|out| {np.max(np.abs(ref)):.1e})")
    assert out.shape == ref.shape == shape and out.dtype == np.float32
    assert err <= BAR * np.max(np.abs(ref))


def _small(seed=3):
    rng = np.random.default_rng(seed)
    conv = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    return dict(x=conv(5, 7), y=conv(3, 5, 2), x4=conv(2, 3, 4, 5), xb=conv(2, 3, 4, 4),
                a=conv(6, 4), b=conv(4, 3), ar=conv(2, 3, 4), ai=conv(2, 3, 4),
                Fc=conv(8, 6), xf=conv(2, 4, 10), F=conv(8, 8), V=conv(5, 1, 4))


def test_cpu_tensors_take_the_plain_versions():
    d = _small()
    op.counts.reset()
    for body, args in (("t2d", ("x",)), ("swap", ("y",)), ("k_a", ("x4",)),
                       ("k_b", ("xb",)), ("gemm", ("a", "b")), ("fused", ("xf", "F", "V"))):
        a = [d[k] for k in args]
        assert torch.equal(getattr(op, body)(*a), getattr(op, f"{body}_plain")(*a))
    assert all(torch.equal(u, v) for u, v in zip(op.k_c(d["ar"], d["ai"], d["Fc"]),
                                                 op.k_c_plain(d["ar"], d["ai"], d["Fc"])))
    rows34 = [n for n in op.counts.plain if n not in op.MOSAIC_NAMES]   # the seven bodies
    assert len(rows34) == 7 and {op.counts.plain[n] for n in rows34} == {2}
    assert set(op.counts.launches.values()) == {0}
    assert la._library is None


def test_transpose_tiles_fit_and_fold_short_axes():
    """The tile the wrapper picks fits the kernel's shared-memory tile
    (2048 floats with the odd row pitch) and takes a short axis whole."""
    for B, R, C in ((1, 32, 8192), (2048, 64, 2), (64, 32, 64), (2, 32, 4096),
                    (3, 37, 5), (5, 2, 67), (7, 1, 1000), (4, 1000, 1)):
        TR, TC, G = op.transpose_tile(B, R, C)
        assert 1 <= TR <= R and 1 <= TC <= C and 1 <= G <= B
        assert G * TR * (TC | 1) <= 2 * op.TRANSPOSE_TILE
        assert (TR == R or TR >= 32) and (TC == C or TC >= 32)
    assert op.transpose_tile(2048, 64, 2) == (64, 2, 8)      # swap: 8 whole entries


@pytest.mark.parametrize("tool", ["probe_pallas_fused", "probe_pallas_fused2"])
def test_tool_main_on_cpu(tool, monkeypatch, capsys):
    mod = importlib.import_module(f"dftk_tpu_torch.tools.{tool}")
    monkeypatch.setattr(mod, "ITERS", 1)
    op.counts.reset()
    res = mod.main(device="cpu")
    printed = capsys.readouterr().out
    assert "CPU, plain versions" in printed
    assert printed.count("max_abs_err 0.00e+00") == len(res) == len(BODIES[tool])
    assert all(np.isfinite(v) and v > 0 for v in res.values())
    assert set(op.counts.launches.values()) == {0} and sum(op.counts.plain.values()) > 0
    assert la._library is None


@pytest.mark.parametrize("tool", ["probe_pallas_fused", "probe_pallas_fused2"])
def test_tool_main_needs_a_card_unless_asked(tool, monkeypatch):
    mod = importlib.import_module(f"dftk_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main()


def test_wrappers_refuse_bad_inputs():
    d = _small()
    with pytest.raises(ValueError, match="float32"):
        op.t2d(d["x"].double())
    with pytest.raises(ValueError, match="2-D"):
        op.t2d(d["y"])
    with pytest.raises(ValueError, match="3-D"):
        op.swap(d["x"])
    with pytest.raises(ValueError, match="4-D"):
        op.k_b(d["y"])
    with pytest.raises(ValueError, match="gemm"):
        op.gemm(d["a"], d["a"])
    with pytest.raises(ValueError, match="k_c"):
        op.k_c(d["ar"], d["ai"], d["Fc"][:6])
    with pytest.raises(ValueError, match="R even"):
        op.fused(d["xf"][..., :9], d["F"], d["V"])
    with pytest.raises(ValueError, match="V \\[R/2, 1, m1\\]"):
        op.fused(d["xf"], d["F"], d["V"][:4])
    with pytest.raises(ValueError, match="all tensors"):
        op.gemm(d["a"], d["b"].to("meta"))


def test_chip_smoke_library_calls_match_plain():
    """chip_smoke.py times one PyTorch call per new kernel as its library
    version: each must compute the plain version's function."""
    import chip_smoke
    d = _small()
    ref = torch.stack(op.k_c_plain(d["ar"], d["ai"], d["Fc"]))
    lib, conv = chip_smoke.k_c_library(d["ar"], d["ai"], d["Fc"])
    out = conv(lib())
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= BAR * float(ref.abs().max())
    ref = op.fused_plain(d["xf"], d["F"], d["V"])
    lib, conv = chip_smoke.fused_library(d["xf"], d["F"], d["V"])
    out = conv(lib())
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= BAR * float(ref.abs().max())
