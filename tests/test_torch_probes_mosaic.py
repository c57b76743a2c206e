"""The Mosaic op probes of dftk_tpu_torch against the JAX bodies.

`tools/probe_mosaic_ops.py` (eight bodies of `try_kernel`, on inputs of
ones) and `tools/probe_mosaic_speed.py` (eleven bodies of `run`, each one
op repeated R times on VMEM-resident data) keep their Pallas bodies
unedited; they are captured as in test_torch_probes.py: each tool is
loaded from its file, `pl.pallas_call` is replaced by an interpret-mode
recorder and `main()` runs under `jax.disable_jit()`; the recorder stops
each call once recorded, and each tool's harness catches that and goes on
to its next body, so every body runs once.  probe_mosaic_ops runs at its
own full shapes (locals of `main()`), probe_mosaic_speed at R = 1 and
R = 3 (its module global R).  Most bodies are lambdas or share the name
`kern`, so the records are told apart by their order.  The recorded inputs
go through the bodies of the port's tools (`dftk_tpu_torch/tools/
probe_mosaic_{ops,speed}.py`), whose plain versions live in
`kernels/op_probes.py` and `kernels/op_speed.py`:
  * probe_mosaic_ops: every plain version equals the JAX body exactly
    on the tool's inputs of ones (every output is 1.0 or 64.0, so the
    'default' and bf16 dots agree exactly too); as ones cannot see a wrong
    permutation, contraction or batch axis, each recorded kernel also runs
    again in interpret mode on seeded normal inputs of the recorded shapes:
    the copies and the permute exactly, the dots within 1e-5 of max|out|
    (the 'default' ones on bf16 values, where the port's rounding is exact
    and the capture's f32 DEFAULT computes the same products);
  * probe_mosaic_speed at R = 1: the permutes and kern_vm exactly, the dots
    within 1e-5 of max|out|; at R = 3 the permutes and kern_vm within
    1e-6 (XLA folds the repeated scale: JAX matches transpose(x) fl(0.999^3)
    better than a step-by-step f32 replay), the dots within 1e-5.  The
    capture computes Precision.DEFAULT in full f32 on the CPU; the port's
    'default' rounds its operands to bf16, which the 1e-3 factor on the dot
    hides below the bar, so its plain 'default' is also shown to differ
    from its plain 'highest'.
The CUDA kernels run only on a GPU: tests/test_torch_cuda.py holds them
against these plain versions there.
"""
import numpy as np
import pytest
import torch

from dftk_tpu_torch.kernels import local_apply as la
from dftk_tpu_torch.kernels import op_probes as op
from dftk_tpu_torch.kernels import op_speed as osp
from dftk_tpu_torch.tools import probe_mosaic_ops as pmo
from dftk_tpu_torch.tools import probe_mosaic_speed as pms
from test_torch_probes import BAR, _capture, jnp, pl

OPS_OUT = [(64, 4096), (32, 2, 64, 128), (128, 4096), (128, 32, 128), (80, 32, 64),
           (64, 128, 64), (128, 32, 128), (128, 4096)]
SPEED_NAMES = ["kern"] * 6 + ["kern_d1", "kern_tp", "kern_tp2", "kern_vm", "kern_tp3"]
SPEED_OUT_ARG = [1] * 7 + [0] * 4      # the output is shaped as acc (dots) or x
EXACT = ("op_rep_swap[tp]", "op_rep_swap[tp2]", "op_rep_vmul[vm]", "op_rep_swap[tp3]")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def captured():
    return {"ops": _capture("probe_mosaic_ops", stop_after_first=True, small={})[1],
            **{R: _capture("probe_mosaic_speed", stop_after_first=True, small={"R": R})[1]
               for R in (1, 3)}}


def _torch(a):
    if a.dtype.name == "bfloat16":       # exact: the values are bf16 already
        return torch.as_tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.as_tensor(a)


def _jax(t):
    a = jnp.asarray(t.float().numpy())     # exact: bf16 values widen and narrow back
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _ops_inputs(records):
    d = {}
    for rec, keys in zip(records, pmo.ARGS):
        d.update({k: _torch(a) for k, a in zip(keys, rec["args"])})
    return d


def test_each_body_ran_once(captured):
    assert [r["name"] for r in captured["ops"]] == ["<lambda>"] * 8
    assert [r["out"].shape for r in captured["ops"]] == OPS_OUT
    for R in (1, 3):
        assert [r["name"] for r in captured[R]] == SPEED_NAMES
        assert [r["out"].shape for r in captured[R]] == [
            r["args"][k].shape for r, k in zip(captured[R], SPEED_OUT_ARG)]


@pytest.mark.parametrize("i", range(8))
def test_mosaic_ops_plain_equals_jax(captured, i):
    """Bodies (1)-(8) on the JAX tool's own inputs of ones."""
    rec = captured["ops"][i]
    label, name, _, plain = pmo.bodies(_ops_inputs(captured["ops"]))[i]
    out = plain()
    assert out.dtype == torch.float32 and tuple(out.shape) == OPS_OUT[i]
    assert np.array_equal(out.numpy(), rec["out"]), label


@pytest.mark.parametrize("i", range(8))
def test_mosaic_ops_plain_matches_jax_on_normal_inputs(captured, i):
    rec = captured["ops"][i]
    d = pmo.make_inputs("cpu", ones=False, seed=11)
    label, name, _, plain = pmo.bodies(d)[i]
    if name.endswith("[default]"):
        for k in pmo.ARGS[i]:
            d[k] = d[k].bfloat16().float()
    args = [d[k] for k in pmo.ARGS[i]]
    assert [tuple(a.shape) for a in args] == [a.shape for a in rec["args"]]
    ref = np.asarray(pl.pallas_call(rec["kernel"], interpret=True, **rec["kw"])(
        *(_jax(a) for a in args)))
    out = plain().numpy()
    err, scale = np.max(np.abs(out - ref)), np.max(np.abs(ref))
    print(f"{name} normal inputs: port vs JAX max_abs_err {err:.1e} (max|out| {scale:.1e})")
    assert out.shape == ref.shape and out.dtype == np.float32
    assert err <= (BAR if "gemm" in name else 0) * scale, label


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("i", range(11))
def test_mosaic_speed_plain_matches_jax(captured, R, i):
    rec = captured[R][i]
    inputs = [tuple(_torch(a) for a in r["args"]) for r in captured[R]]
    label, name, _, plain, _ = pms.bodies(inputs, R)[i]
    out, ref = plain().numpy(), rec["out"]
    err, scale = np.max(np.abs(out - ref)), np.max(np.abs(ref))
    print(f"{name} R={R}: port vs JAX max_abs_err {err:.1e} (max|out| {scale:.1e})")
    assert out.shape == ref.shape and out.dtype == np.float32
    if name in EXACT:
        assert err <= (0 if R == 1 else 1e-6) * scale, label
    else:
        assert err <= BAR * scale, label


@pytest.mark.parametrize("i", [1, 3])
def test_mosaic_speed_default_rounds(captured, i):
    """The 'default' rep_dots round their operands: their plain version
    differs from the 'highest' one on the same inputs."""
    K, N, prec = osp.REP_DOTS[i]
    F, acc = (_torch(a) for a in captured[3][i]["args"])
    body = f"rep_dot_{K}x{N}"
    assert prec == "default"
    lo, hi = osp.rep_gemm_plain(acc, F, 3, body, "default"), osp.rep_gemm_plain(acc, F, 3, body)
    diff = float((lo - hi).abs().max())
    print(f"{body} R=3: plain default vs highest max_abs {diff:.1e} "
          f"(max|out| {float(hi.abs().max()):.1e})")
    assert diff > 0


def _small(seed=5):
    rng = np.random.default_rng(seed)
    conv = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    return dict(x=conv(3, 4, 5), p=conv(3, 2, 5, 4), a=conv(6, 4), b=conv(4, 3, 2),
                X=conv(2, 5, 4), M=conv(2, 4, 3), F=conv(6, 6), acc=conv(6, 10),
                acc3=conv(2, 6, 10), s=conv(4, 3, 4, 2), v=conv(2, 3, 4, 5), V=conv(2, 4))


def test_cpu_tensors_take_the_plain_versions():
    d = _small()
    op.counts.reset()
    osp.counts.reset()
    cases = [
        (op.reshape_copy, op.reshape_copy_plain, (d["x"], (12, 5), "view1")),
        (op.reshape_copy, op.reshape_copy_plain, (d["x"], (60,), "view5")),
        (op.reshape_copy, op.reshape_copy_plain, (d["x"], (2, 30), "view7")),
        (op.permute, op.permute_plain, (d["p"], (2, 1, 0, 3), "perm2")),
        (op.mosaic_dot, op.mosaic_dot_plain, (d["a"], d["b"][:, 0], "highest", "dot3")),
        (op.mosaic_dot, op.mosaic_dot_plain, (d["a"], d["b"], "default", "dot4")),
        (op.mosaic_dot, op.mosaic_dot_plain, (d["X"], d["M"], "default", "dot6")),
        (op.mosaic_dot, op.mosaic_dot_plain, (d["a"].bfloat16(), d["b"][:, 0].bfloat16(),
                                              "highest", "dot8")),
        (osp.rep_swap, osp.rep_swap_plain, (d["s"], (2, 1, 0, 3), 3, "tp")),
        (osp.rep_swap, osp.rep_swap_plain, (d["x"][:, :3], (1, 0, 2), 2, "tp2")),
        (osp.rep_swap, osp.rep_swap_plain, (d["s"][:, :, :3, 0], (0, 2, 1), 1, "tp3")),
        (osp.rep_vmul, osp.rep_vmul_plain, (d["v"], d["V"], 3)),
        (osp.rep_gemm, osp.rep_gemm_plain, (d["acc3"], d["F"], 2, "d1")),
    ] + [(osp.rep_gemm, osp.rep_gemm_plain, (d["acc"], d["F"], 3, f"rep_dot_{K}x{N}", p))
         for K, N, p in osp.REP_DOTS]
    for kernel, plain, args in cases:
        out = kernel(*args)
        assert out.dtype == torch.float32 and torch.equal(out, plain(*args))
    assert out.shape == d["acc"].shape
    assert {op.counts.plain[n] for n in op.MOSAIC_NAMES} == {2}
    assert set(osp.counts.plain.values()) == {2}
    assert set(op.counts.launches.values()) == {0}
    assert set(osp.counts.launches.values()) == {0}
    assert la._library is None


def test_plain_versions_replay_the_bodies():
    """The reshapes copy, the permute moves rows whole, 'default' rounds
    both operands, the R-step bodies repeat their step."""
    d = _small()
    y = op.reshape_copy(d["x"], (12, 5), "view1")
    assert y.data_ptr() != d["x"].data_ptr() and torch.equal(y, d["x"].reshape(12, 5))
    assert torch.equal(op.permute(d["p"], (2, 1, 0, 3), "perm2")[1, 0, 2],
                       d["p"][2, 0, 1])
    rnd = lambda t: t.bfloat16().float()
    assert torch.equal(op.mosaic_dot_plain(d["X"], d["M"], "default", "dot6"),
                       rnd(d["X"]) @ rnd(d["M"]))
    step = lambda a: d["F"] @ a * 1e-3 + a * 0.5
    assert torch.equal(osp.rep_gemm_plain(d["acc"], d["F"], 2, "rep_dot_64x4096"),
                       step(step(d["acc"])))
    assert torch.equal(osp.rep_swap_plain(d["s"], (2, 1, 0, 3), 1, "tp"),
                       d["s"].permute(2, 1, 0, 3) * 0.999)


def test_swap_dims():
    """swap_dims views each permute as [B, P, M, Q, L]."""
    assert op.swap_dims((64, 2, 64, 128), (2, 1, 0, 3)) == (1, 64, 2, 64, 128)
    assert op.swap_dims((64, 64, 128), (1, 0, 2)) == (1, 64, 1, 64, 128)
    assert op.swap_dims((64, 128, 128), (0, 2, 1)) == (64, 128, 1, 128, 1)
    assert op.swap_dims((3, 5, 7, 11), (0, 3, 2, 1)) == (3, 5, 7, 11, 1)


def test_tool_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(pms, "R", 1)
    op.counts.reset()
    osp.counts.reset()
    res_ops, res_speed = pmo.main(device="cpu"), pms.main(device="cpu")
    printed = capsys.readouterr().out
    assert printed.count("CPU, plain versions") == 2
    assert printed.count("max_abs_err 0.00e+00") == 19
    assert list(res_ops) == list(op.MOSAIC_NAMES) and list(res_speed) == list(osp.NAMES)
    assert all(np.isfinite(v) and v > 0 for v in (*res_ops.values(), *res_speed.values()))
    assert "OK (32, 2, 64, 128)" in printed and "x1" in printed
    assert set(op.counts.launches.values()) == {0}
    assert set(osp.counts.launches.values()) == {0}
    assert la._library is None


@pytest.mark.parametrize("tool", [pmo, pms])
def test_tool_main_needs_a_card_unless_asked(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main()


def test_wrappers_refuse_bad_inputs():
    d = _small()
    bad = [
        (op.reshape_copy, (d["x"], (7, 9), "view1"), "cannot reshape"),
        (op.reshape_copy, (d["x"], (12, 5), "view2"), "no instantiation"),
        (op.reshape_copy, (d["x"].double(), (12, 5), "view1"), "float32"),
        (op.permute, (d["p"], (1, 2, 0, 3), "perm2"), "does not swap"),
        (op.mosaic_dot, (d["a"], d["a"], "highest", "dot3"), "a \\[M, K\\]"),
        (op.mosaic_dot, (d["a"], d["b"], "highest", "dot4"), "no instantiation"),
        (op.mosaic_dot, (d["a"], d["b"], "tf32", "dot4"), "precision"),
        (op.mosaic_dot, (d["a"].bfloat16(), d["b"], "highest", "dot8"), "bfloat16"),
        (op.mosaic_dot, (d["a"].bfloat16(), d["b"].bfloat16(), "default", "dot8"),
         "nothing to round"),
        (osp.rep_gemm, (d["acc"], d["F"], 0, "d1"), "R must be"),
        (osp.rep_gemm, (d["acc"], d["F"], 1.5, "d1"), "R must be"),
        (osp.rep_gemm, (d["acc"], d["F"][:5], 1, "d1"), "F \\[K, K\\]"),
        (osp.rep_gemm, (d["acc"], d["F"], 1, "rep_dot_6x10"), "no instantiation"),
        (osp.rep_gemm, (torch.zeros(130, 4), torch.zeros(130, 130), 1, "d1"), "above 128"),
        (osp.rep_swap, (d["s"], (1, 0, 2, 3), 1, "tp"), "one length"),
        (osp.rep_swap, (d["s"], (2, 1, 0, 3), -1, "tp"), "R must be"),
        (osp.rep_swap, (d["s"].double(), (2, 1, 0, 3), 1, "tp"), "float32"),
        (osp.rep_vmul, (d["v"], d["V"].T, 1), "V \\[A, Bk\\]"),
        (osp.rep_vmul, (d["v"], d["V"].to("meta"), 1), "all tensors"),
    ]
    for fn, args, match in bad:
        with pytest.raises(ValueError, match=match):
            fn(*args)


def test_chip_smoke_library_calls_match_plain():
    """chip_smoke.py times one PyTorch call per body (per step for the
    R-step bodies) as its library version: each must compute the plain
    version's function (row 5 at its bar, row 6 within 1e-5 at R = 3)."""
    import chip_smoke
    d = _small()
    close = lambda out, ref, bar: out.shape == ref.shape and \
        float((out - ref).abs().max()) <= bar * float(ref.abs().max())
    for acc in (d["acc"], d["acc3"]):
        assert close(chip_smoke.rep_gemm_library(acc, d["F"], 3)(),
                     osp.rep_gemm_plain(acc, d["F"], 3, "d1"), BAR)
    assert close(chip_smoke.rep_swap_library(d["s"], (2, 1, 0, 3), 3, osp.SCALE_SWAP)(),
                 osp.rep_swap_plain(d["s"], (2, 1, 0, 3), 3, "tp"), BAR)
    assert close(chip_smoke.rep_vmul_library(d["v"], d["V"], 3, osp.SCALE_VMUL)(),
                 osp.rep_vmul_plain(d["v"], d["V"], 3), BAR)
    inputs = pmo.make_inputs("cpu", ones=False, seed=7)
    lib = chip_smoke.mosaic_ops_library(inputs)
    assert list(lib) == list(op.MOSAIC_NAMES)
    for _, name, _, plain in pmo.bodies(inputs):
        if lib[name] is not None:
            assert close(lib[name](), plain(), BAR if "gemm" in name else 0), name
    assert lib["op_gemm[dot4][default]"] is None and lib["op_gemm[dot6][default]"] is None
    assert torch.equal(chip_smoke.dot_highest(inputs["X"], inputs["M"]),
                       inputs["X"] @ inputs["M"])
