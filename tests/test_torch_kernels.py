"""The local-apply kernels of dftk_tpu_torch against the TPU kernels.

The plain PyTorch versions in `dftk_tpu_torch/kernels/local_apply.py` are
held against the JAX package's Pallas kernels, run on the CPU in interpret
mode on the same inputs made with numpy, whose outputs are recorded in
tests/data/torch_port_scf.json (entry "kernels"; its `command` reruns
tests/data/make_torch_port_scf.py, whose constructors and seeded inputs
this file imports):
  * the pruned factors against the JAX package's realified block factors,
    1e-15;
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
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.kernels import local_apply as la

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_scf", DATA / "make_torch_port_scf.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
with open(DATA / "torch_port_scf.json") as _f:
    REF = json.load(_f)["kernels"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def bases():
    return make.si2_kgrid_basis(dt, device="cpu")


def _random_inputs(rng, nk, nb, m, n):
    xc = rng.normal(size=(nk, nb) + m) + 1j * rng.normal(size=(nk, nb) + m)
    V_zxy = rng.normal(size=(nk, n[2], n[0], n[1]))
    return xc, V_zxy


def test_pruned_factors_match_jax_block_factors(bases):
    tb = bases
    fac = tb.pruned.factors
    assert list(tb.pruned.m_shape) == REF["m_shape"]
    for a in range(3):
        np.testing.assert_allclose(fac.fwd[a].numpy(), make.as_complex(REF["fwd"][a]),
                                   atol=1e-15)
        np.testing.assert_allclose(fac.bwd[a].numpy(), make.as_complex(REF["bwd"][a]),
                                   atol=1e-15)


def test_local_apply_plain_matches_fused_local_interpret(bases):
    tb = bases
    xc, V_zxy = make.kernel_inputs(0, tb.n_kpoints, tb.pruned.m_shape, tb.fft_size)
    out = la.local_apply_plain(torch.as_tensor(xc), torch.as_tensor(V_zxy),
                               tb.pruned.factors).numpy()
    assert np.max(np.abs(out - make.as_complex(REF["local_apply"]))) < 1e-12


def test_local_plane_plain_matches_fused_filter_mid_interpret(bases):
    tb = bases
    t, V = make.plane_inputs(1, tb.pruned.m_shape, tb.fft_size)
    ref = make.as_complex(REF["local_plane"])
    out = la.local_plane_plain(torch.as_tensor(t)[None], torch.as_tensor(V)[None],
                               _f32(tb.pruned.factors))[0].numpy()
    assert np.max(np.abs(out - ref)) < 1e-5 * np.max(np.abs(ref))


def _f32(factors):
    return la.LocalFactors(fwd=tuple(f.to(torch.complex64) for f in factors.fwd),
                           bwd=tuple(f.to(torch.complex64) for f in factors.bwd))


def _bf16_bar(name, port, ref, ref_highest):
    err = np.max(np.abs(port - ref))
    rounding = np.max(np.abs(ref - ref_highest))
    print(f"{name}: port vs JAX at 'default' {err:.1e}; JAX 'default' vs "
          f"'highest' {rounding:.1e}")
    assert err * 10 <= rounding


def test_bf16_local_plane_plain_matches_fused_filter_mid_default(bases):
    tb = bases
    t, V = make.plane_inputs(6, tb.pruned.m_shape, tb.fft_size)
    refs = {p: make.as_complex(r) for p, r in REF["local_plane_bf16"].items()}
    la.counts.reset()
    out = la.local_plane_plain(torch.as_tensor(t)[None], torch.as_tensor(V)[None],
                               _f32(tb.pruned.factors), precision="default")[0]
    assert la.counts.plain["local_plane[bf16]"] == 1
    _bf16_bar("local_plane", out.numpy(), refs["default"], refs["highest"])


def test_bf16_axis_dft_plain_matches_dot_z_default(bases):
    tb = bases
    m1, m2, m3 = tb.pruned.m_shape
    rng = np.random.default_rng(7)
    shape = (1, make.PLANE_NB, m1, m2, m3)
    x = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)
    refs = {p: make.as_complex(r) for p, r in REF["dot_z"].items()}
    out = la.pruned_axis_dft_plain(torch.as_tensor(x), _f32(tb.pruned.factors).fwd[2],
                                   True, precision="default")
    _bf16_bar("pruned_axis_dft", out.numpy(), refs["default"], refs["highest"])


def test_bf16_mode_takes_complex64_only(bases):
    tb = bases
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
    tb = bases
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


@pytest.mark.parametrize("m, n, dtype, default, widest", [
    ((32, 32), (64, 64), torch.complex128, 32, 64),  # Si54: two blocks an SM; one fits all
    ((32, 32), (64, 64), torch.complex64, 64, 64),   # the whole plane fits
    ((48, 48), (96, 96), torch.complex128, 40, 40),  # strip-mined, one block
])
def test_local_plane_strip_width(m, n, dtype, default, widest):
    t = torch.empty((1, 1, 1) + m, dtype=dtype)
    assert la.local_plane_strip(t, *n) == default
    assert la.local_plane_strip(t, *n, strip=16) == 16
    assert la.local_plane_strip(t, *n, strip=widest) == widest
    with pytest.raises(ValueError):
        la.local_plane_strip(t, *n, strip=widest + 1)


def test_local_plane_refuses_oversized_planes():
    t = torch.empty((1, 1, 1, 96, 96), dtype=torch.complex128)
    with pytest.raises(ValueError, match="shared memory"):
        la.local_plane_strip(t, 192, 192)
    # 17 row tiles are more than 16 warps hold in registers: the complex128
    # output accumulates in device memory
    t = torch.empty((1, 1, 1, 136, 8), dtype=torch.complex128)
    assert la.local_plane_layout_c128(136, 8, 144, 16) == (16, 16, 0)
    assert la.local_plane_strip(t, 144, 16) == 16
    assert la.local_plane_strip(t.to(torch.complex64), 144, 16) == 16


def test_local_plane_c128_layout_range():
    """Every complex128 plane whose interleaved [m1, m2] and [m1, n2] planes
    and [n1, 1] strip fit one block's shared memory (the float kernel's
    layout), with m1 : m2 within 1 : 4 and 4 : 1 and n / m from 1 to 3, has
    a layout of the complex128 kernel."""
    ran = 0
    for m1 in range(4, 140, 5):
        for m2 in range(4, 140, 5):
            if max(m1, m2) > 4 * min(m1, m2):
                continue
            for f in (1.0, 1.5, 2.0, 3.0):
                n1, n2 = int(m1 * f + 0.99), int(m2 * f + 0.99)
                if (m1 * m2 + m1 * n2 + n1) * 16 > la.SMEM_MAX:
                    continue
                strip, warps, oc = la.local_plane_layout_c128(m1, m2, n1, n2)
                assert 1 <= strip <= n2 and (warps, oc) in la._PLANE_LAYOUTS_C128
                ran += 1
    assert ran > 1000


def test_chip_smoke_local_plane_library_matches_plain(bases):
    """chip_smoke.py times one torch.einsum as kernel B's library version:
    it must compute the plain version's function."""
    import chip_smoke
    tb = bases
    (m1, m2, _), (n1, n2, n3) = tb.pruned.m_shape, tb.fft_size
    rng = np.random.default_rng(2)
    shape = (tb.n_kpoints, 2, n3, m1, m2)
    t = torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape))
    V = torch.as_tensor(rng.normal(size=(tb.n_kpoints, n3, n1, n2)))
    ref = la.local_plane_plain(t, V, tb.pruned.factors)
    out = chip_smoke.local_plane_library(t, V, tb.pruned.factors)()
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert float((out - ref).abs().max()) < 1e-12 * float(ref.abs().max())



# ---- the bf16 kernels' packed factors (the layout the CUDA kernels read) ----

def _unpack_a(P):
    """Complex tiles [..., 16 Rt, 16 Ct] from A fragments [..., Rt, Ct, 2,
    32, 8], by the PTX layout of mma.m16n8k16: lane = 4 gr + tg holds a_r
    (row gr + 8 (r % 2), columns 2 tg + 8 (r // 2) + e) as values 2 r + e."""
    *lead, Rt, Ct = P.shape[:-3]
    out = torch.zeros(*lead, Rt, 16, Ct, 16, dtype=torch.complex128)
    for lane in range(32):
        gr, tg = divmod(lane, 4)
        for r in range(4):
            for e in range(2):
                v = P[..., lane, 2 * r + e].double()
                out[..., gr + 8 * (r % 2), :, 2 * tg + 8 * (r // 2) + e] = \
                    torch.complex(v[..., 0], v[..., 1])
    return out.reshape(*lead, 16 * Rt, 16 * Ct)


def _unpack_b(P):
    """Complex tiles [..., 16 Kt, 8 Nt] from B fragments [..., Nt, Kt, 32,
    8]: lane = 4 gr + tg holds b_r (k 2 tg + 8 r + e, column gr) as values
    2 r + e of the real part, then the same four of the imaginary part."""
    *lead, Nt, Kt = P.shape[:-2]
    out = torch.zeros(*lead, Kt, 16, Nt, 8, dtype=torch.complex128)
    for lane in range(32):
        gr, tg = divmod(lane, 4)
        for r in range(2):
            for e in range(2):
                re, im = P[..., lane, 2 * r + e].double(), P[..., lane, 4 + 2 * r + e].double()
                out[..., 2 * tg + 8 * r + e, :, gr] = torch.complex(re, im).transpose(-1, -2)
    return out.reshape(*lead, 16 * Kt, 8 * Nt)


def _crand(rng, *shape):
    return torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape)).to(
        torch.complex64)


@pytest.mark.parametrize("R, C", [(16, 16), (9, 30), (33, 7)])
def test_bf16_fragment_packs_follow_the_mma_layout(R, C):
    """_pack_a and _pack_b hold the matrix rounded to bf16 (round_bf16),
    zero-padded to whole tiles, each value where mma.sync reads it."""
    F = _crand(np.random.default_rng(R * C), R, C)
    ref = la.round_bf16(F).to(torch.complex128)
    A = _unpack_a(la._pack_a(F))
    assert A.shape == (la._pad(R, 16), la._pad(C, 16))
    assert torch.equal(A[:R, :C], ref) and not A[R:].any() and not A[:, C:].any()
    B = _unpack_b(la._pack_b(F))
    assert B.shape == (la._pad(R, 16), la._pad(C, 8))
    assert torch.equal(B[:R, :C], ref) and not B[R:].any() and not B[:, C:].any()


def _plane_bf16_emulated(t, V, fac, strip):
    """Kernel B's bf16 data flow on the CPU from the wrapper's packs, as the
    CUDA kernel walks them: per strip T1s = X F2f, S = (F1f^T T1s) V, T1s' =
    F1b^T S, out += T1s' F2b, the four intermediates' operands rounded to
    bf16, f32 sums."""
    r = la.round_bf16
    nk, nb, n3, m1, m2 = t.shape
    n1, n2 = V.shape[-2:]
    P2f, P1f, P1b, P2b = la.bf16_plane_packs(fac, strip)
    F1T, B1T = (_unpack_a(p).to(torch.complex64) for p in (P1f, P1b))
    G, H = (_unpack_b(p).to(torch.complex64) for p in (P2f, P2b))
    m1p, m2p, wp = F1T.shape[1], G.shape[1], G.shape[2]
    X = torch.zeros(nk, nb, n3, m1p, m2p, dtype=torch.complex64)
    X[..., :m1, :m2] = r(t)
    out = torch.zeros_like(X)
    for s in range(G.shape[0]):
        w = min(strip, n2 - s * strip)
        Vs = torch.zeros(nk, 1, n3, F1T.shape[0], wp)
        Vs[..., :n1, :w] = V[:, None, :, :, s * strip:s * strip + w]
        T = r(X @ G[s])
        S = r((F1T @ T) * Vs)
        out += r(B1T @ S) @ H[s]
    return out[..., :m1, :m2]


@pytest.mark.parametrize("m, n, strips", [((9, 13), (18, 22), (None, 5, 7, 16)),
                                          ((16, 16), (18, 18), (None, 8))])
def test_bf16_plane_packs_emulated_match_plain(m, n, strips):
    """The packs of bf16_plane_packs, read strip by strip as the CUDA kernel
    reads them, give local_plane_plain's 'default' result: their difference
    at least 10x below the 'default'-vs-'highest' one (the bar of the
    kernel on the card)."""
    rng = np.random.default_rng(9)
    (m1, m2), (n1, n2) = m, n
    t = _crand(rng, 1, 2, 3, m1, m2)
    V = torch.as_tensor(rng.normal(size=(1, 3, n1, n2))).float()
    fac = la.LocalFactors(fwd=(_crand(rng, m1, n1) / m1 ** 0.5,
                               _crand(rng, m2, n2) / m2 ** 0.5, None),
                          bwd=(_crand(rng, n1, m1) / n1 ** 0.5,
                               _crand(rng, n2, m2) / n2 ** 0.5, None))
    ref = la.local_plane_plain(t, V, fac, "default")
    rounding = float(torch.linalg.vector_norm(ref - la.local_plane_plain(t, V, fac))
                     / torch.linalg.vector_norm(ref))
    for strip in strips:
        w = la.local_plane_strip_bf16(m1, m2, n1, n2, strip)
        out = _plane_bf16_emulated(t, V, fac, w)
        rel = float(torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(ref))
        assert 10 * rel <= rounding, (strip, rel, rounding)


@pytest.mark.parametrize("forward", [True, False])
def test_bf16_axis_pack_emulated_matches_plain(forward):
    """Kernel A's packed factor, read as the CUDA kernel reads it (forward
    out^T = F^T in^T with F^T as A, backward out = in^T F with F as B),
    gives pruned_axis_dft_plain's 'default' result at K and J that no tile
    divides."""
    rng = np.random.default_rng(10)
    K, J = 37, 45
    F = _crand(rng, K, J) / K ** 0.5
    x = _crand(rng, 1, 2, 5, 7, K) if forward else _crand(rng, 1, 2, K, 5, 7)
    ref = la.pruned_axis_dft_plain(x, F, forward, "default")
    P = la.bf16_axis_pack(F, forward)
    Fe = (_unpack_a(P).T if forward else _unpack_b(P))[:K, :J].to(torch.complex64)
    xr = la.round_bf16(x)
    out = (torch.einsum("kbxyc,cz->kbzxy", xr, Fe) if forward
           else torch.einsum("kbzxy,zc->kbxyc", xr, Fe))
    assert torch.allclose(out, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    assert la.bf16_axis_pack(F, forward) is P           # kept per factor tensor
    F.mul_(2)
    assert la.bf16_axis_pack(F, forward) is not P       # remade after an in-place change


def test_local_plane_bf16_strip_range():
    """Every plane the first bf16 design ran (its complex64 [m1, m2] and [m1,
    n2] planes and one [n1, 1] column within one block's shared memory),
    with m1 : m2 within 1 : 4 and 4 : 1 and n / m from 1 to 3, has a strip of
    the bf16 kernel, and the widest strip the first design took is taken."""
    ran = 0
    for m1 in range(4, 200, 5):
        for m2 in range(4, 200, 5):
            if max(m1, m2) > 4 * min(m1, m2):
                continue
            for f in (1.0, 1.5, 2.0, 3.0):
                n1, n2 = int(m1 * f + 0.99), int(m2 * f + 0.99)
                first = min(n2, (la.SMEM_MAX - (m1 * m2 + m1 * n2) * 8) // (n1 * 8))
                if first < 1:
                    continue
                strip = la.local_plane_strip_bf16(m1, m2, n1, n2)
                assert 1 <= strip <= n2
                assert la._plane_smem_bf16(m1, m2, n1, strip) <= la.SMEM_MAX
                assert la.local_plane_strip_bf16(m1, m2, n1, n2, first) == first
                ran += 1
    assert ran > 2000
    # the Si54 and Si256 planes: one strip of 64, two of 64 (two blocks an SM)
    assert la.local_plane_strip_bf16(32, 32, 64, 64) == 64
    assert la.local_plane_strip_bf16(64, 64, 120, 120) == 64
