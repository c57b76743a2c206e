"""The local-apply kernels of dftk_tpu_torch against the TPU kernels.

The plain PyTorch versions in `dftk_tpu_torch/kernels/local_apply.py` are
held against the JAX package's Pallas kernels, run on the CPU in interpret
mode, on the same inputs made with numpy:
  * local_apply_plain vs kernels/fused_local.py::fused_local_apply, f64,
    1e-12 (the bar of tests/test_engine_split.py::
    test_pallas_fused_local_matches_xla);
  * local_plane_plain vs kernels/fused_filter.py::fused_filter_mid, f32 at
    'highest' precision, 1e-5 of max|out| (the two sum in other orders);
  * the bf16 ('default') mode: local_plane_plain vs fused_filter_mid and
    pruned_axis_dft_plain vs fused_filter.py::dot_z, both at 'default'.
    Both packages round the same operands to bf16 and accumulate in f32 in
    other orders, so their difference must be at least 10x smaller than
    the difference between 'default' and 'highest' at the same inputs
    (measured on the CPU: ~1e-7 against ~1e-2 for kernel B, ~1e-6 against
    ~3e-2 for the z transform).
The CUDA kernels themselves run only on a GPU: tests/test_torch_cuda.py
holds them against the plain versions there.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dftk_tpu as dftk
from dftk_tpu.ops.engine_split import build_pruned_fft as jax_build_pruned_fft

import dftk_tpu_torch as dt
from dftk_tpu_torch.kernels import local_apply as la

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])


def _si2(pkg, **kw):
    Si = pkg.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = pkg.model_DFT(SI_LATTICE, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                          functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    return pkg.PlaneWaveBasis(model, Ecut=7.0, kgrid=pkg.MonkhorstPack((2, 2, 2)),
                              fft_size=(18, 18, 18), **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def bases():
    return _si2(dftk), _si2(dt, device="cpu")


def _random_inputs(rng, nk, nb, m, n):
    xc = rng.normal(size=(nk, nb) + m) + 1j * rng.normal(size=(nk, nb) + m)
    V_zxy = rng.normal(size=(nk, n[2], n[0], n[1]))
    return xc, V_zxy


def test_pruned_factors_match_jax_block_factors(bases):
    jb, tb = bases
    pf = jax_build_pruned_fft(jb, dtype=jnp.float64)
    fac = tb.pruned.factors
    for a in range(3):
        m, n = fac.fwd[a].shape
        blk_f = np.asarray(pf.Fblk_f[a])      # [[C, S], [-S, C]]
        blk_b = np.asarray(pf.Fblk_b[a])
        np.testing.assert_allclose(fac.fwd[a].numpy(),
                                   blk_f[:m, :n] + 1j * blk_f[:m, n:], atol=1e-15)
        np.testing.assert_allclose(fac.bwd[a].numpy(),
                                   blk_b[:n, :m] + 1j * blk_b[:n, m:], atol=1e-15)


def test_local_apply_plain_matches_fused_local_interpret(bases):
    from dftk_tpu.kernels.fused_local import fused_local_apply
    jb, tb = bases
    pf = jax_build_pruned_fft(jb, dtype=jnp.float64)
    m, n = tb.pruned.m_shape, tb.fft_size
    xc, V_zxy = _random_inputs(np.random.default_rng(0), tb.n_kpoints, 3, m, n)
    V_rev = np.transpose(V_zxy, (0, 1, 3, 2))          # [nk, n3, n2, n1]
    yr, yi = fused_local_apply(jnp.asarray(xc.real), jnp.asarray(xc.imag),
                               jnp.asarray(V_rev), pf, interpret=True)
    ref = np.asarray(yr) + 1j * np.asarray(yi)
    out = la.local_apply_plain(torch.as_tensor(xc), torch.as_tensor(V_zxy),
                               tb.pruned.factors).numpy()
    assert np.max(np.abs(out - ref)) < 1e-12


def test_local_plane_plain_matches_fused_filter_mid_interpret(bases, monkeypatch):
    from jax.experimental import pallas as pl
    from dftk_tpu.kernels.fused_filter import FusedFilterFactors, fused_filter_mid
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    jb, tb = bases
    pf = jax_build_pruned_fft(jb, dtype=jnp.float32)
    (m1, m2, _), (n1, n2, n3) = tb.pruned.m_shape, tb.fft_size
    nb = 4
    rng = np.random.default_rng(1)
    t = (rng.normal(size=(nb, n3, m1, m2))
         + 1j * rng.normal(size=(nb, n3, m1, m2))).astype(np.complex64)
    V = rng.normal(size=(n3, n1, n2)).astype(np.float32)
    # fused_filter_mid layout: [n3, 2 (re/im), m2, m1, nb]
    t1 = np.stack([t.real, t.imag], axis=1).transpose(2, 1, 4, 3, 0)
    ref5 = np.asarray(fused_filter_mid(jnp.asarray(np.ascontiguousarray(t1)),
                                       jnp.asarray(V),
                                       FusedFilterFactors(pf, precision="highest")))
    ref = (ref5[:, 0] + 1j * ref5[:, 1]).transpose(3, 0, 2, 1)   # [nb, n3, m1, m2]

    f64 = tb.pruned.factors
    f32 = la.LocalFactors(fwd=tuple(f.to(torch.complex64) for f in f64.fwd),
                          bwd=tuple(f.to(torch.complex64) for f in f64.bwd))
    out = la.local_plane_plain(torch.as_tensor(t)[None], torch.as_tensor(V)[None],
                               f32)[0].numpy()
    assert np.max(np.abs(out - ref)) < 1e-5 * np.max(np.abs(ref))


def _f32(factors):
    return la.LocalFactors(fwd=tuple(f.to(torch.complex64) for f in factors.fwd),
                           bwd=tuple(f.to(torch.complex64) for f in factors.bwd))


@pytest.fixture(scope="module")
def interpret_pallas():
    from jax.experimental import pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        yield


def _bf16_bar(name, port, ref, ref_highest):
    err = np.max(np.abs(port - ref))
    rounding = np.max(np.abs(ref - ref_highest))
    print(f"{name}: port vs JAX at 'default' {err:.1e}; JAX 'default' vs "
          f"'highest' {rounding:.1e}")
    assert err * 10 <= rounding


def test_bf16_local_plane_plain_matches_fused_filter_mid_default(bases, interpret_pallas):
    from dftk_tpu.kernels.fused_filter import FusedFilterFactors, fused_filter_mid
    jb, tb = bases
    pf = jax_build_pruned_fft(jb, dtype=jnp.float32)
    (m1, m2, _), (n1, n2, n3) = tb.pruned.m_shape, tb.fft_size
    rng = np.random.default_rng(6)
    t = (rng.normal(size=(4, n3, m1, m2))
         + 1j * rng.normal(size=(4, n3, m1, m2))).astype(np.complex64)
    V = rng.normal(size=(n3, n1, n2)).astype(np.float32)
    t1 = jnp.asarray(np.ascontiguousarray(
        np.stack([t.real, t.imag], axis=1).transpose(2, 1, 4, 3, 0)))
    refs = {}
    for prec in ("default", "highest"):
        r5 = np.asarray(fused_filter_mid(t1, jnp.asarray(V),
                                         FusedFilterFactors(pf, precision=prec)))
        refs[prec] = (r5[:, 0] + 1j * r5[:, 1]).transpose(3, 0, 2, 1)
    la.counts.reset()
    out = la.local_plane_plain(torch.as_tensor(t)[None], torch.as_tensor(V)[None],
                               _f32(tb.pruned.factors), precision="default")[0]
    assert la.counts.plain["local_plane[bf16]"] == 1
    _bf16_bar("local_plane", out.numpy(), refs["default"], refs["highest"])


def test_bf16_axis_dft_plain_matches_dot_z_default(bases):
    from dftk_tpu.kernels.fused_filter import FusedFilterFactors, dot_z
    jb, tb = bases
    pf = jax_build_pruned_fft(jb, dtype=jnp.float32)
    m1, m2, m3 = tb.pruned.m_shape
    n3 = tb.fft_size[2]
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(1, 4, m1, m2, m3))
         + 1j * rng.normal(size=(1, 4, m1, m2, m3))).astype(np.complex64)
    # dot_z layout: [k, 2 m3 (z, re/im), m2, m1, nb]
    X = np.stack([x.real, x.imag], axis=-1).transpose(0, 4, 5, 3, 2, 1)
    X = jnp.asarray(np.ascontiguousarray(X).reshape(1, 2 * m3, m2, m1, 4))
    refs = {}
    for prec in ("default", "highest"):
        y = np.asarray(dot_z(FusedFilterFactors(pf, precision=prec).f3f, X, prec))
        y = y.reshape(1, n3, 2, m2, m1, 4)
        refs[prec] = (y[:, :, 0] + 1j * y[:, :, 1]).transpose(0, 4, 1, 3, 2)
    out = la.pruned_axis_dft_plain(torch.as_tensor(x), _f32(tb.pruned.factors).fwd[2],
                                   True, precision="default")
    _bf16_bar("pruned_axis_dft", out.numpy(), refs["default"], refs["highest"])


def test_bf16_mode_takes_complex64_only(bases):
    _, tb = bases
    x = torch.zeros((1, 1) + tb.pruned.m_shape, dtype=torch.complex128)
    with pytest.raises(TypeError, match="complex64"):
        la.pruned_axis_dft(x, tb.pruned.factors.fwd[2], True, precision="default")
    with pytest.raises(ValueError, match="precision"):
        la.pruned_axis_dft(x, tb.pruned.factors.fwd[2], True, precision="tensor32")
    # bf16 keeps 7 fraction bits: both parts are ties, which go to the even
    r = la.round_bf16(torch.tensor([1 + 2 ** -8 + 1j * (1 + 3 * 2 ** -8)],
                                   dtype=torch.complex64))
    assert complex(r[0]) == 1 + 1j * (1 + 2 ** -6)


def test_wrappers_take_plain_path_on_cpu(bases):
    """On CPU tensors the wrappers run the plain versions and never build or
    launch a kernel (this machine needs no nvcc for that)."""
    _, tb = bases
    m, n = tb.pruned.m_shape, tb.fft_size
    xc, V_zxy = _random_inputs(np.random.default_rng(2), 1, 2, m, n)
    xc, V_zxy = torch.as_tensor(xc), torch.as_tensor(V_zxy)
    la.counts.reset()
    out = la.local_apply(xc, V_zxy, tb.pruned.factors)
    assert set(la.counts.launches.values()) == {0}
    assert la.counts.plain == {"pruned_axis_dft": 2, "local_plane": 1,
                               "pruned_axis_dft[bf16]": 0, "local_plane[bf16]": 0}
    assert la._library is None
    torch.testing.assert_close(out, la.local_apply_plain(xc, V_zxy, tb.pruned.factors),
                               rtol=0, atol=0)


@pytest.mark.parametrize("m, n, dtype, widest", [
    ((32, 32), (64, 64), torch.complex128, 64),     # Si54: the whole plane fits
    ((32, 32), (64, 64), torch.complex64, 64),
    ((48, 48), (96, 96), torch.complex128, 79),     # strip-mined
])
def test_local_plane_strip_width(m, n, dtype, widest):
    t = torch.empty((1, 1, 1) + m, dtype=dtype)
    assert la.local_plane_strip(t, *n) == widest
    assert la.local_plane_strip(t, *n, strip=16) == 16
    with pytest.raises(ValueError):
        la.local_plane_strip(t, *n, strip=widest + 1)


def test_local_plane_refuses_oversized_planes():
    t = torch.empty((1, 1, 1, 96, 96), dtype=torch.complex128)
    with pytest.raises(ValueError, match="shared memory"):
        la.local_plane_strip(t, 192, 192)


def test_chip_smoke_local_plane_library_matches_plain(bases):
    """chip_smoke.py times one torch.einsum as kernel B's library version:
    it must compute the plain version's function."""
    import chip_smoke
    tb = bases[1]
    (m1, m2, _), (n1, n2, n3) = tb.pruned.m_shape, tb.fft_size
    rng = np.random.default_rng(2)
    shape = (tb.n_kpoints, 2, n3, m1, m2)
    t = torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape))
    V = torch.as_tensor(rng.normal(size=(tb.n_kpoints, n3, n1, n2)))
    ref = la.local_plane_plain(t, V, tb.pruned.factors)
    out = chip_smoke.local_plane_library(t, V, tb.pruned.factors)()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert float((out - ref).abs().max()) < 1e-12 * float(ref.abs().max())
