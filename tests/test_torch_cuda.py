"""dftk_tpu_torch's CUDA kernels on the GPU (skipped without one).

Imports only torch and the port, so that it runs on a machine without jax:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures jax).  The kernels are held
against their plain PyTorch versions, complex128 at 1e-11 and complex64 at
1e-5 of max|out| (complex128 also at ragged shapes, the Si54 and Si256
plane sizes and forced strips, with F streamed at tall K and the plane
output in device memory where registers do not hold it, and the refusals
of what does not fit);
the bf16 ('default') instantiations so that the kernel-vs-plain
difference is at least 10x below the plain 'default'-vs-'highest'
difference (relative Frobenius norms: both round the same operands and sum
in other orders), kernel B also at ragged planes, explicit strips, the
Si54 and Si256 planes, both output layouts and planes near the first
design's limit, kernel A at K and J that no tile divides and tall K, with
the bf16 kernel B's shared-memory count held against the wrapper's.  The Si2 SCF and the Si2 split
CheFSI SCF ("mixed" filter) on the GPU are held against the same SCFs on
the CPU (1e-9 Ha), and the symmetric Si2 SCF (48 operations) at 1e-10 Ha;
the density symmetrizer against the CPU's (1e-13) and, at symmetric Si54's
1296 operations, against a loop over the operations; the forces and stresses of one Si2 state on the GPU
against the CPU's (1e-11), every op of both on the card.  Kernels A and B,
complex128 and bf16, at the collinear-spin paths' shapes (iron, Fe2,
Fe16, Fe54), with the up and down potentials on the two halves of the k
rows.  One Sternheimer solve of chi0 and one apply of Omega + K on the
card against the same on the CPU (1e-11), on a symmetric Si2 state, and
the Gamma Si2 DFPT dynamical matrix on the card against the CPU's (1e-9
of max|C|).  H at k+q through the permuted Ham against H at k_perm, and
the complex dV_q psi (Re and Im as two local applies) against its plain
versions, within 1e-14 of max|out|.  The exchange apply and the ACE build
and apply on the card against the CPU's (1e-12 of max|out|), at Gamma and
on a k-grid.  The
filter-stage probe kernels (`kernels/filter_stages.py`)
are held against their plain versions at small, unequal sizes, with 1 and 4
planes per block: f32 stage sets at 1e-5 of max|out|, the bf16 'full' by
the margin rule above, the copy at 1e-6.  The planar chain (`probe_planar`,
f32 and bf16 operands) and the band-major fused chain (`micro_full`, one
application) are held to the same bars, and `micro_swaponly` to exact
equality, at small sizes and at the probes' plane sizes (m 32, n 64).  The
op probes (`kernels/op_probes.py`) are held against their plain versions
at the JAX tools' shapes and at ragged ones that divide no tile: the
transposes exactly, `gemm` (also batched), `k_c` and `fused` at 1e-5 of
max|out|; so are the Mosaic op probes: the reshape copies and the permute
exactly (also off 16-byte alignment), the f32 and bf16-operand dots at
1e-5, the 'default' ones by the margin rule, all of them exactly on
inputs of ones; the R-step kernels (`kernels/op_speed.py`) at R = 1, 2, 3
(an odd R is a swap): the swaps and the V multiply exactly (kern_vm's
subnormals kept), the repeated dots by the margin rule both ways (a
'highest' one against the plain 'default' as a 'default' one against the
plain 'highest': 1e-5 of max|out| cannot tell them apart, the product
being ~1e-4 of acc).  Kernels A and B (complex128 and complex64) at the
postprocess paths' shapes: the Si54 fine basis of the two-grid refinement
(Ecut 15, grid 80^3) and band-path k-points off Gamma (silicon at Ecut 12).
"""
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import dftk_tpu_torch as dt
from dftk_tpu_torch.kernels import local_apply as la

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])


def _si2(device, positions=(np.ones(3) / 8, -np.ones(3) / 8)):
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dt.model_DFT(SI_LATTICE, [Si, Si], list(positions),
                         functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    return dt.PlaneWaveBasis(model, Ecut=7.0, kgrid=dt.MonkhorstPack((2, 2, 2)),
                             fft_size=(18, 18, 18), device=device)


@pytest.fixture(scope="module")
def gpu_basis():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return _si2("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, bar", [(torch.complex128, 1e-11),
                                        (torch.complex64, 1e-5)])
def test_cuda_kernels_match_plain(gpu_basis, dtype, bar):
    b = gpu_basis
    m, n = b.pruned.m_shape, b.fft_size
    fac = la.LocalFactors(fwd=tuple(f.to(dtype) for f in b.pruned.factors.fwd),
                          bwd=tuple(f.to(dtype) for f in b.pruned.factors.bwd))
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    rng = np.random.default_rng(3)
    shape = (b.n_kpoints, 5) + m
    xc = torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                         device="cuda").to(dtype)
    V = torch.as_tensor(rng.normal(size=(b.n_kpoints, n[2], n[0], n[1])),
                        device="cuda").to(rdt)

    def close(out, ref):
        torch.cuda.synchronize()
        return float((out - ref).abs().max()) <= bar * float(ref.abs().max())

    t = la.pruned_axis_dft(xc, fac.fwd[2], forward=True)
    assert close(t, la.pruned_axis_dft_plain(xc, fac.fwd[2], True))
    back = la.pruned_axis_dft(t, fac.bwd[2], forward=False)
    assert close(back, la.pruned_axis_dft_plain(t, fac.bwd[2], False))
    for strip in (None, 5, 7):
        assert close(la.local_plane(t, V, fac, strip=strip),
                     la.local_plane_plain(t, V, fac))
    assert close(la.local_apply(xc, V, fac), la.local_apply_plain(xc, V, fac))


def _c128(rng, shape, scale=1.0):
    return torch.as_tensor((rng.normal(size=shape) + 1j * rng.normal(size=shape)) * scale,
                           device="cuda")


def _close_c128(out, ref):
    """complex128 bar: 1e-11 of max|out| (the tensor-core and DFMA sums
    differ from the plain einsum's only in order)."""
    torch.cuda.synchronize()
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    return float((out - ref).abs().max()) <= 1e-11 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("nk, nb, m1, m2, K, J", [
    (2, 3, 5, 7, 11, 13),       # K, J no multiple of 4: one ragged tile
    (1, 4, 9, 30, 37, 45),      # 270 rows: several row tiles, K over two chunks
    (1, 2, 33, 33, 6, 70),      # 1089 rows: several blocks; J over two column tiles
    (1, 3, 32, 32, 32, 64),     # the Si54 shapes, fewer bands
    (1, 2, 6, 7, 160, 80),      # K of five chunks: F streams with the input
    (1, 2, 9, 5, 200, 64),      # K of seven chunks, streamed
    (2, 2, 24, 24, 24, 33),     # the ABINIT golden's z axis (m 24, grid 33)
    (1, 2, 24, 24, 24, 48),     # symmetric Si8's (grid 48)
    (1, 2, 32, 32, 32, 72)])    # symmetric Si54's (grid 72)
def test_cuda_c128_kernel_a_ragged(nk, nb, m1, m2, K, J, forward):
    """Kernel A in complex128 against its plain version; for backward the
    roles of K and J are those of the z axis back (K = n3 rows in, J out)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    rng = np.random.default_rng(31)
    x = _c128(rng, (nk, nb, m1, m2, K) if forward else (nk, nb, K, m1, m2))
    F = _c128(rng, (K, J), K ** -0.5)
    la.counts.reset()
    out = la.pruned_axis_dft(x, F, forward)
    assert _close_c128(out, la.pruned_axis_dft_plain(x, F, forward))
    assert la.counts.launches["pruned_axis_dft"] == 1


def _plane_case(rng, nk, nb, n3, m, n):
    """t [nk, nb, n3, m1, m2], V [nk, n3, n1, n2] and random complex128
    factors of the planes' shapes."""
    (m1, m2), (n1, n2) = m, n
    t = _c128(rng, (nk, nb, n3, m1, m2))
    V = torch.as_tensor(rng.normal(size=(nk, n3, n1, n2)), device="cuda")
    fac = la.LocalFactors(
        fwd=(_c128(rng, (m1, n1), m1 ** -0.5), _c128(rng, (m2, n2), m2 ** -0.5), None),
        bwd=(_c128(rng, (n1, m1), n1 ** -0.5), _c128(rng, (n2, m2), n2 ** -0.5), None))
    return t, V, fac


@pytest.mark.cuda
@pytest.mark.parametrize("nk, nb, n3, m, n, strips", [
    (2, 3, 4, (9, 13), (18, 22), (None, 5, 7, 8)),    # odd in every axis, nk = 2
    (1, 2, 3, (64, 64), (120, 120), (None, 16)),      # Si256 planes: strips of 24, 16
    (1, 2, 2, (32, 32), (64, 64), (None, 24)),        # Si54 planes: strips of 32, 24
    (1, 2, 2, (136, 8), (144, 16), (None, 5)),        # 17 row tiles: out in device memory
    (1, 1, 2, (64, 72), (128, 144), (None, 7)),       # 8 x 9 out tiles: out in device memory
    (2, 2, 2, (24, 24), (33, 33), (None,)),           # the ABINIT golden's planes
    (1, 2, 2, (24, 24), (48, 48), (None,)),           # symmetric Si8's
    (1, 2, 2, (24, 24), (45, 45), (None,)),           # displaced Si8's
    (1, 2, 2, (32, 32), (72, 72), (None,))])          # symmetric Si54's
def test_cuda_c128_kernel_b_planes(nk, nb, n3, m, n, strips):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    t, V, fac = _plane_case(np.random.default_rng(32), nk, nb, n3, m, n)
    ref = la.local_plane_plain(t, V, fac)
    la.counts.reset()
    for strip in strips:
        assert _close_c128(la.local_plane(t, V, fac, strip=strip), ref)
    assert la.counts.launches["local_plane"] == len(strips)


@pytest.mark.cuda
def test_cuda_c128_kernel_b_refuses_what_does_not_fit():
    """The complex128 kernel B's shared-memory arithmetic: planes whose
    narrowest strip needs more than 227 KB, and strips wider than fit; the
    kernel's own count of its shared memory is the wrapper's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    rng = np.random.default_rng(33)
    t, V, fac = _plane_case(rng, 1, 1, 1, (96, 96), (192, 192))
    with pytest.raises(ValueError, match="shared memory"):
        la.local_plane(t, V, fac)
    t, V, fac = _plane_case(rng, 1, 1, 2, (16, 16), (18, 18))
    with pytest.raises(ValueError, match="strip"):
        la.local_plane(t, V, fac, strip=19)
    for m1, m2, n1, strip in ((16, 16, 18, 18), (9, 13, 18, 5), (64, 64, 120, 24),
                              (136, 8, 144, 16), (64, 72, 128, 7)):
        assert la.library().dftk_local_plane_c128_smem(m1, m2, n1, strip) == \
            la._plane_smem_c128(m1, m2, n1, strip)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(gpu_basis):
    fac = gpu_basis.pruned.factors
    m, n = gpu_basis.pruned.m_shape, gpu_basis.fft_size
    xc = torch.zeros((1, 2) + m, dtype=torch.complex128, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        la.pruned_axis_dft(xc.transpose(-1, -2), fac.fwd[2], forward=True)
    with pytest.raises(TypeError):
        la.pruned_axis_dft(xc.to(torch.complex64), fac.fwd[2], forward=True)
    with pytest.raises(ValueError):
        la.pruned_axis_dft(xc, fac.fwd[2][:3].contiguous(), forward=True)
    V = torch.zeros((1, n[2], n[0], n[1]), dtype=torch.float32, device="cuda")
    t = torch.zeros((1, 2, n[2], m[0], m[1]), dtype=torch.complex128, device="cuda")
    with pytest.raises(TypeError):
        la.local_plane(t, V, fac)


@pytest.mark.cuda
def test_cuda_scf_matches_cpu(gpu_basis):
    cpu = _si2("cpu")
    kw = dict(tol=1e-10, n_bands=8, seed=7)
    psi0 = dt.scf.driver.random_orbitals(cpu, 11, seed=7)
    res_c = dt.self_consistent_field(cpu, psi=psi0, **kw)
    la.counts.reset()
    res_g = dt.self_consistent_field(gpu_basis, psi=psi0.to("cuda"), **kw)
    assert res_c.converged and res_g.converged
    assert abs(res_g.total_energy - res_c.total_energy) < 1e-9
    assert la.counts.launches["pruned_axis_dft"] > 0 and la.counts.launches["local_plane"] > 0
    assert all(v == 0 for v in la.counts.plain.values())


def _si2_symmetric(device):
    """Si2 at Ecut 7 on MonkhorstPack (2, 2, 2) with the default symmetries
    (48 operations, 3 irreducible k-points) and the basis' own FFT size."""
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dt.model_DFT(SI_LATTICE, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                         functionals=["lda_x", "lda_c_vwn"])
    return dt.PlaneWaveBasis(model, Ecut=7.0, kgrid=dt.MonkhorstPack((2, 2, 2)),
                             device=device)


@pytest.mark.cuda
def test_cuda_symmetrizer_matches_cpu():
    """The density symmetrizer on the card against the port's CPU one on a
    seeded random density (1e-13), and at symmetric Si54's 1296 operations
    on a 72^3 grid against a per-operation loop on the card (1e-13 of
    max|rho|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from dftk_tpu_torch.ops.density import build_symmetrization_maps, make_symmetrizer
    cpu, gpu = _si2_symmetric("cpu"), _si2_symmetric("cuda")
    rho = torch.as_tensor(np.random.default_rng(40).random((1,) + cpu.fft_size))
    out = make_symmetrizer(gpu)(rho.cuda())
    assert out.device.type == "cuda"
    assert float((out.cpu() - make_symmetrizer(cpu)(rho)).abs().max()) < 1e-13

    from dftk_tpu_torch.tools.run_si_big import build_bench_basis
    m = build_bench_basis(3, 10.0, "cpu").model
    si54 = dt.PlaneWaveBasis(dt.model_DFT(m.lattice, m.atoms, m.positions,
                                          functionals=["lda_x", "lda_c_vwn"]),
                             Ecut=10.0, kgrid=(1, 1, 1), device="cuda")
    assert len(si54.symmetries) == 1296 and si54.fft_size == (72, 72, 72)
    rho = torch.as_tensor(np.random.default_rng(41).random((1,) + si54.fft_size),
                          device="cuda")
    out = make_symmetrizer(si54)(rho)
    maps = build_symmetrization_maps(si54)
    Gred = torch.as_tensor(si54.G_cube.reshape(-1, 3), dtype=torch.float64, device="cuda")
    rho_G = torch.fft.fftn(rho[0]).reshape(-1)
    pad = torch.cat([rho_G, rho_G.new_zeros(1)])
    acc = torch.zeros_like(rho_G)
    for s, op in enumerate(si54.symmetries):
        idx = torch.as_tensor(maps.rot_idx[maps.op_rot[s]], device="cuda")
        tau = torch.as_tensor(op.tau, device="cuda")
        acc += torch.exp(-2j * np.pi * (Gred @ tau)) * pad[idx]
    acc *= torch.as_tensor(maps.lowpass, device="cuda") / len(si54.symmetries)
    ref = torch.fft.ifftn(acc.reshape(si54.fft_size)).real
    assert float((out[0] - ref).abs().max()) < 1e-13 * float(rho.abs().max())


@pytest.mark.cuda
def test_cuda_symmetric_scf_matches_cpu():
    """The symmetric Si2 SCF (48 operations, 3 irreducible k-points) on the
    card against the same SCF on the CPU (1e-10 Ha), through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    cpu, gpu = _si2_symmetric("cpu"), _si2_symmetric("cuda")
    assert len(gpu.symmetries) == 48 and gpu.n_kpoints == 3
    kw = dict(tol=1e-10, n_bands=4, seed=7)
    psi0 = dt.scf.driver.random_orbitals(cpu, 7, seed=7)
    res_c = dt.self_consistent_field(cpu, psi=psi0, **kw)
    la.counts.reset()
    res_g = dt.self_consistent_field(gpu, psi=psi0.to("cuda"), **kw)
    assert res_c.converged and res_g.converged
    assert abs(res_g.total_energy - res_c.total_energy) < 1e-10
    assert la.counts.launches["pruned_axis_dft"] > 0 and la.counts.launches["local_plane"] > 0
    assert all(v == 0 for v in la.counts.plain.values())


class _OffCardOps(TorchDispatchMode):
    """Records every op that computes a tensor of one or more dimensions off
    the card.  Not counted: `lift_fresh`, which hands torch a host array
    (numpy setup data, a list of indices) before its copy to the card, and
    the 0-d scalars torch wraps Python numbers in."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is not torch.ops.aten.lift_fresh.default and any(
                isinstance(t, torch.Tensor) and t.device.type != "cuda" and t.dim() > 0
                for t in tree_leaves(out)):
            self.ops.append(str(func))
        return out


@pytest.mark.cuda
def test_cuda_forces_stresses_match_cpu():
    """Forces and stresses of one state of Si2 with atom 0 displaced (random
    orbitals, 4 occupied bands and 2 empty, the guess density): the card's
    within 1e-11 of the CPU's, and no op of either derivative computes a
    tensor off the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    positions = (np.array([0.127, 0.125, 0.123]), -np.ones(3) / 8)
    cpu, gpu = _si2("cpu", positions), _si2("cuda", positions)
    psi = dt.scf.driver.random_orbitals(cpu, 6, seed=11)
    occ = torch.tensor([2.0, 2.0, 2.0, 2.0, 0.0, 0.0]).repeat(cpu.n_kpoints, 1)
    rho = dt.guess_density(cpu)
    state_c = types.SimpleNamespace(psi=psi, occupation=occ, rho=rho)
    state_g = types.SimpleNamespace(psi=psi.cuda(), occupation=occ.cuda(), rho=rho.cuda())
    ref = (dt.compute_forces_cart(state_c, cpu), dt.compute_stresses_cart(state_c, cpu))
    with _OffCardOps() as log:
        out = (dt.compute_forces_cart(state_g, gpu), dt.compute_stresses_cart(state_g, gpu))
    assert not log.ops, sorted(set(log.ops))
    for a, b in zip(out, ref):
        assert a.device.type == "cuda" and a.dtype == torch.float64
        assert float((a.cpu() - b).abs().max()) < 1e-11


@pytest.mark.cuda
def test_cuda_bf16_kernels_match_plain(gpu_basis):
    b = gpu_basis
    m, n = b.pruned.m_shape, b.fft_size
    fac = la.LocalFactors(fwd=tuple(f.to(torch.complex64) for f in b.pruned.factors.fwd),
                          bwd=tuple(f.to(torch.complex64) for f in b.pruned.factors.bwd))
    rng = np.random.default_rng(4)
    shape = (b.n_kpoints, 5) + m
    xc = torch.as_tensor(rng.normal(size=shape) + 1j * rng.normal(size=shape),
                         device="cuda").to(torch.complex64)
    V = torch.as_tensor(rng.normal(size=(b.n_kpoints, n[2], n[0], n[1])),
                        device="cuda").to(torch.float32)
    t = la.pruned_axis_dft_plain(xc, fac.fwd[2], True, "default").contiguous()

    def rel(a, b):
        torch.cuda.synchronize()
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    la.counts.reset()
    for kern, plain, highest in (
            (la.pruned_axis_dft(xc, fac.fwd[2], True, "default"),
             la.pruned_axis_dft_plain(xc, fac.fwd[2], True, "default"),
             la.pruned_axis_dft_plain(xc, fac.fwd[2], True)),
            (la.pruned_axis_dft(t, fac.bwd[2], False, "default"),
             la.pruned_axis_dft_plain(t, fac.bwd[2], False, "default"),
             la.pruned_axis_dft_plain(t, fac.bwd[2], False)),
            (la.local_plane(t, V, fac, strip=7, precision="default"),
             la.local_plane_plain(t, V, fac, "default"), la.local_plane_plain(t, V, fac)),
            (la.local_plane(t, V, fac, precision="default"),
             la.local_plane_plain(t, V, fac, "default"), la.local_plane_plain(t, V, fac)),
            (la.local_apply(xc, V, fac, "default"),
             la.local_apply_plain(xc, V, fac, "default"), la.local_apply_plain(xc, V, fac))):
        assert 10 * rel(kern, plain) <= rel(plain, highest)
    assert la.counts.launches["pruned_axis_dft[bf16]"] == 4
    assert la.counts.launches["local_plane[bf16]"] == 3
    with pytest.raises(TypeError, match="complex64"):
        la.local_plane(t.to(torch.complex128), V.double(), b.pruned.factors,
                       precision="default")


def _c64_case(t, V, fac):
    """The complex128 plane case in complex64 data and an f32 potential."""
    c = lambda f: None if f is None else f.to(torch.complex64)
    return t.to(torch.complex64), V.float(), la.LocalFactors(
        fwd=tuple(map(c, fac.fwd)), bwd=tuple(map(c, fac.bwd)))


def _margin(out, plain, highest):
    """The bf16 bar: kernel-vs-plain at least 10x below the plain
    'default'-vs-'highest' difference (relative Frobenius norms)."""
    assert out.shape == plain.shape and bool(torch.isfinite(out).all())
    return 10 * _rel(out, plain) <= _rel(plain, highest)


@pytest.mark.cuda
@pytest.mark.parametrize("nk, nb, n3, m, n, strips", [
    (2, 3, 4, (9, 13), (18, 22), (None, 5, 7, 8, 16)),  # odd in every axis, nk = 2
    (1, 2, 3, (64, 64), (120, 120), (None, 16)),        # Si256 planes: strips of 64, 16
    (1, 2, 2, (32, 32), (64, 64), (None, 24)),          # Si54 planes: one strip of 64, 24
    (1, 2, 2, (136, 8), (144, 16), (None, 5)),          # 9 row tiles of 16: out in device memory
    (1, 1, 2, (64, 72), (128, 144), (None, 7)),         # 4 x 10 out tiles: device memory
    (1, 1, 2, (100, 100), (120, 120), (None, 120)),     # large planes the first design ran
    (1, 1, 2, (24, 94), (72, 282), (None, 278)),        # the first design's widest strip
    (2, 2, 2, (24, 24), (33, 33), (None,)),             # the ABINIT golden's planes
    (1, 2, 2, (24, 24), (48, 48), (None,)),             # symmetric Si8's
    (1, 2, 2, (24, 24), (45, 45), (None,)),             # displaced Si8's
    (1, 2, 2, (32, 32), (72, 72), (None,))])            # symmetric Si54's
def test_cuda_bf16_kernel_b_planes(nk, nb, n3, m, n, strips):
    """The bf16 kernel B against its plain version by the margin rule, at
    ragged planes, explicit strips, both output layouts, and (last case)
    planes near the first design's shared-memory limit at its widest strip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    t, V, fac = _c64_case(*_plane_case(np.random.default_rng(34), nk, nb, n3, m, n))
    plain = la.local_plane_plain(t, V, fac, "default")
    highest = la.local_plane_plain(t, V, fac)
    la.counts.reset()
    for strip in strips:
        assert _margin(la.local_plane(t, V, fac, strip=strip, precision="default"),
                       plain, highest), strip
    assert la.counts.launches["local_plane[bf16]"] == len(strips)
    assert la.counts.plain["local_plane[bf16]"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("forward", [True, False])
@pytest.mark.parametrize("nk, nb, m1, m2, K, J", [
    (2, 3, 5, 7, 11, 13),       # K, J odd: one ragged tile, 8-byte copies
    (1, 4, 9, 30, 37, 45),      # 270 rows: several row tiles, K over two chunks
    (1, 2, 33, 33, 6, 70),      # 1089 rows: several blocks; J over two column tiles
    (1, 3, 32, 32, 32, 64),     # the Si54 shapes, fewer bands
    (1, 2, 6, 7, 160, 80),      # tall K: five chunks (backward: n3 160, m3 80)
    (1, 2, 9, 5, 200, 64),      # K = 200: seven chunks
    (2, 2, 24, 24, 24, 33),     # the ABINIT golden's z axis (m 24, grid 33)
    (1, 2, 32, 32, 32, 72)])    # symmetric Si54's (grid 72)
def test_cuda_bf16_kernel_a_ragged(nk, nb, m1, m2, K, J, forward):
    """The bf16 kernel A against its plain version by the margin rule; for
    backward the roles of K and J are those of the z axis back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    rng = np.random.default_rng(35)
    x = _c128(rng, (nk, nb, m1, m2, K) if forward else (nk, nb, K, m1, m2))
    x, F = x.to(torch.complex64), _c128(rng, (K, J), K ** -0.5).to(torch.complex64)
    la.counts.reset()
    out = la.pruned_axis_dft(x, F, forward, "default")
    assert _margin(out, la.pruned_axis_dft_plain(x, F, forward, "default"),
                   la.pruned_axis_dft_plain(x, F, forward))
    assert la.counts.launches["pruned_axis_dft[bf16]"] == 1


def _spin_potential(rng, nk, n3, n1, n2):
    """V [nk, n3, n1, n2] of a collinear-spin basis: the first half of the k
    rows applies the up channel, the second half the down one, as
    `ops/hamiltonian.py::build_ham` gathers V[kspin]."""
    V2 = torch.as_tensor(rng.normal(size=(2, n3, n1, n2)), device="cuda")
    return V2[torch.arange(nk, device="cuda") // (nk // 2)].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("nk, nb, m, n", [
    (12, 11, (16, 16, 16), (20, 20, 20)),   # the iron goldens (6 k-points x 2 spins)
    (28, 21, (16, 16, 16), (24, 24, 24)),   # displaced Fe2 on MP (3, 3, 3)
    (2, 106, (24, 24, 24), (40, 40, 40)),   # Fe16, Gamma, both spins
    (2, 330, (32, 32, 32), (60, 60, 60))])  # Fe54
def test_cuda_kernels_at_spin_shapes(nk, nb, m, n):
    """Kernels A and B and the A -> B -> A chain at the collinear-spin
    paths' shapes, the two halves of the k rows under different potentials:
    complex128 at 1e-11 of max|out|, bf16 by the margin rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    rng = np.random.default_rng(36)
    x = _c128(rng, (nk, nb) + m)
    V = _spin_potential(rng, nk, n[2], n[0], n[1])
    assert float((V[0] - V[-1]).abs().max()) > 0
    fac = la.LocalFactors(
        fwd=tuple(_c128(rng, (a, b), a ** -0.5) for a, b in zip(m, n)),
        bwd=tuple(_c128(rng, (b, a), b ** -0.5) for a, b in zip(m, n)))
    t = la.pruned_axis_dft_plain(x, fac.fwd[2], True).contiguous()
    la.counts.reset()
    assert _close_c128(la.pruned_axis_dft(x, fac.fwd[2], True),
                       la.pruned_axis_dft_plain(x, fac.fwd[2], True))
    assert _close_c128(la.local_plane(t, V, fac), la.local_plane_plain(t, V, fac))
    assert _close_c128(la.local_apply(x, V, fac), la.local_apply_plain(x, V, fac))
    c64 = lambda f: f.to(torch.complex64)
    x64, t64, V32 = c64(x), c64(t), V.float()
    fac64 = la.LocalFactors(fwd=tuple(map(c64, fac.fwd)), bwd=tuple(map(c64, fac.bwd)))
    for kern, plain in (
            (lambda p: la.pruned_axis_dft(x64, fac64.fwd[2], True, p),
             lambda p: la.pruned_axis_dft_plain(x64, fac64.fwd[2], True, p)),
            (lambda p: la.local_plane(t64, V32, fac64, precision=p),
             lambda p: la.local_plane_plain(t64, V32, fac64, p)),
            (lambda p: la.local_apply(x64, V32, fac64, p),
             lambda p: la.local_apply_plain(x64, V32, fac64, p))):
        assert _margin(kern("default"), plain("default"), plain("highest"))
    assert la.counts.launches["pruned_axis_dft"] == 3
    assert la.counts.launches["local_plane"] == 2
    assert la.counts.launches["pruned_axis_dft[bf16]"] == 3
    assert la.counts.launches["local_plane[bf16]"] == 2


@pytest.mark.cuda
def test_cuda_bf16_layout_matches_the_wrapper():
    """The bf16 kernel B's own count of its shared memory is the wrapper's,
    the register-held output takes the planes of up to 8 warps x 4 tiles,
    and a plane whose strip of 16 does not fit is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    lib = la.library()
    for m1, m2, n1, strip in ((16, 16, 18, 18), (9, 13, 18, 5), (64, 64, 120, 64),
                              (32, 32, 64, 64), (136, 8, 144, 16), (64, 72, 128, 7),
                              (100, 100, 120, 120), (24, 94, 72, 278)):
        assert lib.dftk_local_plane_bf16_smem(m1, m2, n1, strip) == \
            la._plane_smem_bf16(m1, m2, n1, strip)
    assert [lib.dftk_local_plane_bf16_oc(*m) for m in
            ((32, 32), (64, 64), (9, 13), (136, 8), (64, 72))] == [1, 4, 1, 0, 0]
    t, V, fac = _c64_case(*_plane_case(np.random.default_rng(36), 1, 1, 1, (16, 16),
                                       (3000, 18)))
    with pytest.raises(ValueError, match="shared memory"):
        la.local_plane(t, V, fac, precision="default")


def _probe_inputs(n3, m1, m2, n1, n2, nbt):
    """Filter-stage probe inputs t [n3, m2, 2, m1, nbt], V [n3, n1, n2] and
    the four realified factors, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    rng = np.random.default_rng(11)
    conv = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    t = conv(rng.normal(size=(n3, m2, 2, m1, nbt)))
    V = conv(rng.normal(size=(n3, n1, n2)))
    F = tuple(conv(rng.normal(size=s) / 4) for s in
              ((2 * n2, 2 * m2), (2 * n1, 2 * m1), (2 * m1, 2 * n1), (2 * m2, 2 * n2)))
    return t, V, F


@pytest.fixture(scope="module")
def probe_inputs():
    """Small, unequal sizes: t [n3=8, m2=4, 2, m1=6, nbt=12], V [8, n1=10, n2=8]."""
    return _probe_inputs(8, 6, 4, 10, 8, 12)


@pytest.mark.cuda
@pytest.mark.parametrize("zblk", [1, 4])
@pytest.mark.parametrize("stages, wide", [("f2", False), ("f2_rep", False),
                                          ("f2_rep_f1", False), ("full", False),
                                          ("full", True), ("rep", False), ("dots", False)])
def test_cuda_probe_stages_match_plain(probe_inputs, stages, wide, zblk):
    """wide: the probes' plane sizes (m = 32, n = 64), where the F1 stages
    run on two strips of 32 columns."""
    from dftk_tpu_torch.kernels import filter_stages as fs
    t, V, F = _probe_inputs(4, 32, 32, 64, 64, 4) if wide else probe_inputs
    if wide:
        assert fs.probe_stages_strip(32, 32, 64, 64) == 32
    F = None if stages == "rep" else F
    fs.counts.reset()
    out = fs.probe_stages(t, V, F, stages, zblk=zblk)
    ref = fs.probe_stages_plain(t, V, F, stages, zblk=zblk)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert fs.counts.launches[f"probe_stages[{stages}]"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("zblk", [1, 4])
def test_cuda_probe_bf16_and_copy_match_plain(probe_inputs, zblk):
    from dftk_tpu_torch.kernels import filter_stages as fs
    t, V, F = probe_inputs

    def rel(a, b):
        torch.cuda.synchronize()
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    plain = fs.probe_stages_plain(t, V, F, "full", "default")
    assert 10 * rel(fs.probe_stages(t, V, F, "full", "default", zblk), plain) \
        <= rel(plain, fs.probe_stages_plain(t, V, F, "full"))
    out, ref = fs.probe_copy(t, zblk), fs.probe_copy_plain(t)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    with pytest.raises(ValueError, match="zblk"):
        fs.probe_copy(t, 3)
    with pytest.raises(TypeError):
        fs.probe_stages(t.double(), V.double(), tuple(f.double() for f in F))


@pytest.mark.cuda
def test_cuda_split_scf_matches_cpu(gpu_basis):
    cpu = _si2("cpu")
    kw = dict(tol=1e-10, maxiter=60, n_bands=4, n_extra_bands=4, eigensolver="chefsi",
              chebyshev_degree=8, chefsi_cycles=2)
    U0 = torch.cat([dt.scf.driver.random_orbitals(cpu, 8, seed=5).real,
                    dt.scf.driver.random_orbitals(cpu, 8, seed=5).imag], dim=-1)
    res_c = dt.self_consistent_field_split(cpu, U0=U0, **kw)
    la.counts.reset()
    res_g = dt.self_consistent_field_split(gpu_basis, U0=U0, **kw)
    assert res_c["converged"] and res_g["converged"]
    assert abs(res_g["energies"]["total"] - res_c["energies"]["total"]) < 1e-9
    assert all(v > 0 for v in la.counts.launches.values())
    assert all(v == 0 for v in la.counts.plain.values())


def _rel(a, b):
    torch.cuda.synchronize()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("dims", [(8, 6, 4, 10, 8, 12), (4, 32, 32, 64, 64, 4)])
def test_cuda_probe_planar_matches_plain(dims, precision):
    """Small, unequal sizes (one strip), and the probe's plane sizes (two
    strips of 32 columns)."""
    from dftk_tpu_torch.kernels import filter_stages as fs
    from dftk_tpu_torch.tools.probe_harness import make_planar_inputs
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    t, V, P = make_planar_inputs(12, *dims, "cuda")
    fs.counts.reset()
    out = fs.probe_planar(t, V, P, precision)
    ref = fs.probe_planar_plain(t, V, P, precision)
    torch.cuda.synchronize()
    if precision == "highest":
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
        assert fs.counts.launches["probe_planar"] == 1
    else:
        assert 10 * _rel(out, ref) <= _rel(ref, fs.probe_planar_plain(t, V, P))
        assert fs.counts.launches["probe_planar[bf16]"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("K, NB, M, N", [(2, 3, 4, 8), (1, 5, 16, 16), (1, 6, 32, 64)])
def test_cuda_micro_match_plain(K, NB, M, N):
    """One application of micro_full within 1e-5 of max|out|, micro_swaponly
    exactly; the last case at the probe's band sizes."""
    from dftk_tpu_torch.kernels import fused_micro as fm
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    rng = np.random.default_rng(13)
    conv = lambda s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device="cuda")
    xr, xi, V = conv((K, NB, M, M, M)), conv((K, NB, M, M, M)), conv((K, N, N, N))
    F, G = conv((2 * M, 2 * N)), conv((2 * N, 2 * M))
    fm.counts.reset()
    out, ref = torch.stack(fm.micro_full(xr, xi, V, F, G)), torch.stack(
        fm.micro_full_plain(xr, xi, V, F, G))
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    out, ref = fm.micro_swaponly(xr, xi, N), fm.micro_swaponly_plain(xr, xi, N)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert fm.counts.launches == {"micro_full": 1, "micro_swaponly": 1}


@pytest.mark.cuda
def test_cuda_planar_and_micro_refuse_bad_inputs():
    from dftk_tpu_torch.kernels import filter_stages as fs
    from dftk_tpu_torch.kernels import fused_micro as fm
    from dftk_tpu_torch.tools.probe_harness import make_planar_inputs
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    t, V, P = make_planar_inputs(1, 4, 4, 4, 8, 8, 8, "cuda")
    strided = torch.zeros(t.shape[:-1] + (2 * t.shape[-1],), device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fs.probe_planar(strided, V, P)
    with pytest.raises(TypeError):
        fs.probe_planar(t.double(), V.double(), tuple(f.double() for f in P))
    with pytest.raises(ValueError, match="all tensors"):
        fs.probe_planar(t, V.cpu(), P)
    x = torch.zeros((1, 2, 4, 4, 4), device="cuda")
    V, F, G = (torch.zeros(s, device="cuda") for s in ((1, 8, 8, 8), (8, 16), (16, 8)))
    with pytest.raises(ValueError, match="contiguous"):
        fm.micro_full(x.transpose(-1, -2), x, V, F, G)
    with pytest.raises(TypeError):
        fm.micro_swaponly(x.double(), x.double(), 8)
    with pytest.raises(ValueError, match="all tensors"):
        fm.micro_full(x, x.cpu(), V, F, G)
    x3 = torch.zeros((1, 2, 3, 3, 3), device="cuda")
    with pytest.raises(ValueError, match="divide 128"):
        fm.micro_full(x3, x3, torch.zeros((1, 8, 8, 8), device="cuda"),
                      torch.zeros((6, 16), device="cuda"), torch.zeros((16, 6), device="cuda"))
    with pytest.raises(ValueError, match="below M"):
        fm.micro_swaponly(x, x, 2)


def _op_tensors(seed, *shapes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=s), dtype=torch.float32, device="cuda")
            for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("body, shape", [
    ("t2d", (32, 8192)), ("swap", (2048, 64, 2)), ("k_a", (2, 32, 32, 64)),
    ("k_b", (2, 32, 64, 64)),                        # the probes' shapes
    ("swap", (3, 37, 5)), ("swap", (5, 2, 67)), ("t2d", (1, 1000)), ("swap", (4, 100, 1)),
    ("k_a", (2, 3, 33, 65)), ("k_b", (3, 5, 7, 9))])   # ragged: no tile divides them
def test_cuda_op_transpose_equals_plain(body, shape):
    from dftk_tpu_torch.kernels import op_probes as op
    x, = _op_tensors(17, shape)
    op.counts.reset()
    out, ref = getattr(op, body)(x), getattr(op, f"{body}_plain")(x)
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.equal(out, ref)
    assert op.counts.launches[f"op_transpose[{body}]"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("a_shape, b_shape", [
    ((4096, 64), (64, 128)),                         # the probe's shapes
    ((100, 14), (14, 22)), ((37, 5), (5, 3)),        # ragged tiles
    ((3, 70, 20), (3, 20, 65)), ((3, 70, 20), (20, 65))])    # batched
def test_cuda_op_gemm_matches_plain(a_shape, b_shape):
    from dftk_tpu_torch.kernels import op_probes as op
    a, b = _op_tensors(18, a_shape, b_shape)
    op.counts.reset()
    out, ref = op.gemm(a, b), op.gemm_plain(a, b)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert op.counts.launches["op_gemm[gemm]"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape, n", [((2, 32, 32, 32), 64),    # the probe's shapes
                                      ((100, 7), 11), ((2, 5, 10, 3), 4)])
def test_cuda_op_k_c_matches_plain(shape, n):
    """P = Q = 2: the two halves of A and of C through their own pointers."""
    from dftk_tpu_torch.kernels import op_probes as op
    ar, ai, F = _op_tensors(19, shape, shape, (2 * shape[-1], 2 * n))
    op.counts.reset()
    out, ref = torch.stack(op.k_c(ar, ai, F)), torch.stack(op.k_c_plain(ar, ai, F))
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (2,) + shape[:-1] + (n,)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert op.counts.launches["op_gemm[k_c]"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("nb, m1, R", [(8, 32, 8192), (3, 5, 74), (2, 32, 140), (1, 1, 2)])
def test_cuda_op_fused_axis_matches_plain(nb, m1, R):
    """The probe's shapes, a small m1 and R, and a last tile of 6 of 64 pairs."""
    from dftk_tpu_torch.kernels import op_probes as op
    xb, F, V = _op_tensors(20, (nb, m1, R), (2 * m1, 2 * m1), (R // 2, 1, m1))
    op.counts.reset()
    out, ref = op.fused(xb, F / m1, V), op.fused_plain(xb, F / m1, V)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert op.counts.launches["op_fused_axis[fused]"] == 1


@pytest.mark.cuda
def test_cuda_op_probes_refuse_bad_inputs():
    from dftk_tpu_torch.kernels import op_probes as op
    x, F, V = _op_tensors(21, (2, 40, 8), (80, 80), (4, 1, 40))
    with pytest.raises(ValueError, match="contiguous"):
        op.swap(x.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        op.k_a(x[None].transpose(2, 3))
    with pytest.raises(ValueError, match="float32"):
        op.gemm(x[0].double(), F[:8].double())
    with pytest.raises(ValueError, match="all tensors"):
        op.gemm(x[0], F[:8].cpu())
    with pytest.raises(ValueError, match="above 32"):
        op.fused(x, F, V)


def _margin_real(out, ref, other):
    """The bf16 margin rule for the op probes' real tensors: kernel-vs-plain
    at least 10x below the plain 'default'-vs-'highest' difference
    (relative Frobenius norms in f64; `other` is the plain version at the
    other precision).  Named apart from `_margin`, which it shadowed, so
    that the complex kernels' checks keep their imaginary parts."""
    out, ref, other = out.double(), ref.double(), other.double()
    rel = lambda a, b: float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    return rel(out, ref) * 10 <= rel(ref, other)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, new", [
    ((64, 32, 128), (64, 4096)), ((2560, 64), (80, 32, 64)),
    ((64, 2, 32, 128), (128, 32, 128)),              # the probe's three reshapes
    ((3, 7, 5), (105,)), ((1,), (1, 1))])             # odd sizes: the scalar path
def test_cuda_op_reshape_copy_equals_plain(shape, new):
    from dftk_tpu_torch.kernels import op_probes as op
    x, = _op_tensors(22, shape)
    op.counts.reset()
    out = op.reshape_copy(x, new, "view1")
    torch.cuda.synchronize()
    assert out.data_ptr() != x.data_ptr()
    assert torch.equal(out, op.reshape_copy_plain(x, new, "view1"))
    assert op.counts.launches["op_transpose[view1]"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape, perm", [
    ((64, 2, 32, 128), (2, 1, 0, 3)),                 # the probe's permute
    ((5, 3, 7, 6), (2, 1, 0, 3)), ((3, 2, 9, 8), (2, 1, 0, 3)),   # P != Q, M, L > 1
    ((7, 5, 12), (1, 0, 2)), ((2, 3, 4, 5, 6), (0, 3, 2, 1, 4)), ((6, 4, 1), (0, 2, 1))])
def test_cuda_op_permute_equals_plain(shape, perm):
    from dftk_tpu_torch.kernels import op_probes as op
    x, = _op_tensors(23, shape)
    op.counts.reset()
    out, ref = op.permute(x, perm, "perm2"), op.permute_plain(x, perm, "perm2")
    buf = torch.empty(x.numel() + 1, device="cuda")   # 4 bytes off 16: the scalar path
    xs = buf[1:].view(shape).copy_(x)
    off = op.permute(xs, perm, "perm2")
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.equal(out, ref) and torch.equal(off, ref)
    assert op.counts.launches["op_transpose[perm2]"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("body, a_shape, b_shape", [
    ("dot3", (128, 64), (64, 4096)), ("dot4", (128, 64), (64, 32, 128)),
    ("dot6", (64, 128, 64), (64, 64, 64)), ("dot8", (128, 64), (64, 4096)),  # the probe's
    ("dot3", (37, 5), (5, 3)), ("dot4", (70, 20), (20, 3, 7)),
    ("dot6", (3, 70, 20), (3, 20, 65)), ("dot8", (100, 14), (14, 22))])   # ragged tiles
def test_cuda_op_mosaic_dot_matches_plain(body, a_shape, b_shape):
    """f32 at 1e-5 of max|out|, bf16 operands in memory likewise (their
    products are exact in f32), 'default' by the margin rule; on inputs of
    ones all exactly."""
    from dftk_tpu_torch.kernels import op_probes as op
    a, b = _op_tensors(24, a_shape, b_shape)
    prec = "default" if body in ("dot4", "dot6") else "highest"
    if body == "dot8":
        a, b = a.bfloat16(), b.bfloat16()
    op.counts.reset()
    out, ref = op.mosaic_dot(a, b, prec, body), op.mosaic_dot_plain(a, b, prec, body)
    ones = [torch.ones_like(t) for t in (a, b)]
    assert torch.equal(op.mosaic_dot(*ones, prec, body), op.mosaic_dot_plain(*ones, prec, body))
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == torch.float32
    if prec == "default":
        assert _margin_real(out, ref, op.mosaic_dot_plain(a, b, "highest", "dot3"))
    else:
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    name = [n for n in op.MOSAIC_NAMES if f"[{body}]" in n][0]
    assert op.counts.launches[name] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 3])
@pytest.mark.parametrize("Z, K, N", [
    (1, 128, 4096), (1, 64, 8192), (64, 64, 128),    # rep_dot and kern_d1 shapes
    (1, 50, 70), (3, 100, 33), (2, 1, 1), (1, 33, 4)])   # K, N off the tiles
def test_cuda_op_rep_gemm_matches_plain(Z, K, N, R):
    from dftk_tpu_torch.kernels import op_speed as osp
    acc, F = _op_tensors(25, (Z, K, N), (K, K))
    acc = acc[0] if Z == 1 else acc
    osp.counts.reset()
    body = "rep_dot_128x4096"            # a count name with both precisions
    for prec in ("highest", "default"):
        out = osp.rep_gemm(acc, F / K ** 0.5, R, body, prec)
        ref = osp.rep_gemm_plain(acc, F / K ** 0.5, R, body, prec)
        torch.cuda.synchronize()
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        other = "default" if prec == "highest" else "highest"
        assert _margin_real(out, ref, osp.rep_gemm_steps(acc, F / K ** 0.5, R, other))
        assert osp.counts.launches[osp.gemm_name(body, prec)] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 3])
@pytest.mark.parametrize("shape, perm", [
    ((64, 2, 64, 128), (2, 1, 0, 3)), ((64, 64, 128), (1, 0, 2)),
    ((64, 128, 128), (0, 2, 1)),                      # kern_tp, kern_tp2, kern_tp3
    ((37, 3, 37, 5), (2, 1, 0, 3)), ((2, 50, 50), (0, 2, 1)), ((3, 3, 33), (1, 0, 2)),
    ((1, 1, 1), (0, 2, 1))])                          # tiles off the axes
def test_cuda_op_rep_swap_equals_plain(shape, perm, R):
    """Each step moves and scales: exact, and an odd R is a swap."""
    from dftk_tpu_torch.kernels import op_speed as osp
    x, = _op_tensors(26, shape)
    osp.counts.reset()
    out, ref = osp.rep_swap(x, perm, R, "tp"), osp.rep_swap_plain(x, perm, R, "tp")
    torch.cuda.synchronize()
    assert out.shape == ref.shape and torch.equal(out, ref)
    assert osp.counts.launches["op_rep_swap[tp]"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 3, 100])
@pytest.mark.parametrize("shape", [(64, 2, 64, 128), (3, 5, 7, 9), (1, 1, 1, 1)])
def test_cuda_op_rep_vmul_equals_plain(shape, R):
    """Exact, subnormals included (no flush to zero)."""
    from dftk_tpu_torch.kernels import op_speed as osp
    x, V = _op_tensors(27, shape, (shape[0], shape[2]))
    osp.counts.reset()
    out, ref = osp.rep_vmul(x * 0.01, V * 0.01, R), osp.rep_vmul_plain(x * 0.01, V * 0.01, R)
    tiny, half = torch.full((1, 1, 1, 1), 1e-39), torch.full((1, 1), 0.5)   # subnormal
    sub = osp.rep_vmul(tiny.cuda(), half.cuda(), 1)
    torch.cuda.synchronize()
    assert torch.equal(out, ref)
    assert torch.equal(sub.cpu(), osp.rep_vmul_plain(tiny, half, 1)) and float(sub) != 0
    assert osp.counts.launches["op_rep_vmul[vm]"] == 2


@pytest.mark.cuda
def test_cuda_op_mosaic_refuse_bad_inputs():
    from dftk_tpu_torch.kernels import op_probes as op
    from dftk_tpu_torch.kernels import op_speed as osp
    x, F = _op_tensors(28, (4, 6, 6), (6, 6))
    with pytest.raises(ValueError, match="contiguous"):
        op.reshape_copy(x.transpose(1, 2), (36, 4), "view1")
    with pytest.raises(ValueError, match="contiguous"):
        op.permute(x.transpose(0, 1), (1, 0, 2), "perm2")
    with pytest.raises(ValueError, match="all tensors"):
        op.mosaic_dot(F, x[0].cpu(), "highest", "dot3")
    with pytest.raises(ValueError, match="contiguous"):
        osp.rep_gemm(x.transpose(1, 2), F, 1, "d1")
    with pytest.raises(ValueError, match="contiguous"):
        osp.rep_swap(x.transpose(1, 2), (0, 2, 1), 1, "tp3")
    with pytest.raises(ValueError, match="R must be"):
        osp.rep_vmul(x[None], F[:1, :6], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nk, nb, m, n", [
    (4, 3 * 11, (16, 16, 16), (27, 27, 27)),   # the SCAN golden: 4 k-points, 8 + 3 bands
    (4, 7, (16, 16, 16), (17, 17, 17)),        # TPSS / r2SCAN silicon: one block of 4 + 3
    (4, 3 * 7, (16, 16, 16), (17, 17, 17)),    # ... and its DivAgrad batch
    (1, 7, (8, 8, 8), (18, 18, 18)),           # SCAN + NLCC C2: one block of 4 + 3
    (1, 3 * 3 * 7, (8, 8, 8), (18, 18, 18)),   # SCAN + NLCC C2: a LOBPCG block of 3 x 7
    (1, 3 * 118, (32, 32, 32), (64, 64, 64))])  # Si54 SCAN: 108 + 10 bands
def test_cuda_divagrad_chain_at_mgga_shapes(nk, nb, m, n):
    """Kernels A and B and the A -> B -> A chain on the meta-GGA runs' band
    blocks, alone and as the DivAgrad batch (the three p_a-scaled copies of
    a band block stacked along the band axis, under Vtau), at the shapes of
    chip_smoke.py phase l:
    complex128 at 1e-11 of max|out|, bf16 by the margin rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    rng = np.random.default_rng(44)
    x = _c128(rng, (nk, nb) + m)
    Vtau = torch.as_tensor(np.abs(rng.normal(size=(nk, n[2], n[0], n[1]))), device="cuda")
    fac = la.LocalFactors(
        fwd=tuple(_c128(rng, (a, b), a ** -0.5) for a, b in zip(m, n)),
        bwd=tuple(_c128(rng, (b, a), b ** -0.5) for a, b in zip(m, n)))
    t = la.pruned_axis_dft_plain(x, fac.fwd[2], True).contiguous()
    la.counts.reset()
    assert _close_c128(la.pruned_axis_dft(x, fac.fwd[2], True),
                       la.pruned_axis_dft_plain(x, fac.fwd[2], True))
    assert _close_c128(la.local_plane(t, Vtau, fac), la.local_plane_plain(t, Vtau, fac))
    assert _close_c128(la.local_apply(x, Vtau, fac), la.local_apply_plain(x, Vtau, fac))
    c64 = lambda f: f.to(torch.complex64)
    x64, V32 = c64(x), Vtau.float()
    fac64 = la.LocalFactors(fwd=tuple(map(c64, fac.fwd)), bwd=tuple(map(c64, fac.bwd)))
    assert _margin(la.local_apply(x64, V32, fac64, "default"),
                   la.local_apply_plain(x64, V32, fac64, "default"),
                   la.local_apply_plain(x64, V32, fac64))
    assert la.counts.launches["local_plane"] == 2
    assert la.counts.launches["local_plane[bf16]"] == 1


@pytest.mark.cuda
def test_cuda_sphere_apply_matches_plain(monkeypatch):
    """The meta-GGA H apply on the GPU, on the SCAN + NLCC diamond of
    chip_smoke.py phase l3 (C_m.upf) with its guess density and von
    Weizsaecker tau: the exact apply (Vtau's DivAgrad term through the
    kernels) at 1e-11 of max|out| and the sphere filter's bf16 ('default')
    apply by the margin rule, each against the same apply through the
    plain versions on the card; the kernels launch, the plain versions are
    not called."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from torch_port_cells import C_POSITIONS, carbon_basis
    from dftk_tpu_torch.ops import hamiltonian as hamops
    from dftk_tpu_torch.ops.density import von_weizsaecker_tau
    from dftk_tpu_torch.ops.engine_split import sphere_filter_ops
    basis = carbon_basis(dt, C_POSITIONS, device="cuda")
    rho = dt.guess_density(basis)
    tau = von_weizsaecker_tau(rho, basis.terms.data.G_cart)
    V, Vtau, _ = hamops.total_potential(basis.terms, rho, basis.model.unit_cell_volume, tau=tau)
    ham = hamops.build_ham(basis.data, basis.terms.data, V, basis.pruned, Vtau=Vtau)
    psi = dt.scf.driver.random_orbitals(basis, 3 * 7, seed=9)
    la.counts.reset()
    default, exact = sphere_filter_ops(ham, ("default", "highest"))
    out, out_d = exact(psi), default(psi)
    torch.cuda.synchronize()
    launches = dict(la.counts.launches)
    assert launches["local_plane"] == 2 and launches["local_plane[bf16]"] == 2
    assert all(v == 0 for v in la.counts.plain.values())
    monkeypatch.setattr(hamops, "local_apply", la.local_apply_plain)
    ref, ref_d = exact(psi), default(psi)
    assert _close_c128(out, ref)
    assert _margin(out_d, ref_d, ref.to(torch.complex64))


@pytest.fixture(scope="module")
def si2_response_state():
    """The symmetric Si2 (Ecut 7, 3 irreducible k-points) on the CPU and on
    the card, and its LOBPCG SCF on the CPU to 1e-10."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    cpu, gpu = _si2_symmetric("cpu"), _si2_symmetric("cuda")
    res = dt.self_consistent_field(cpu, tol=1e-10, n_bands=4, seed=7)
    assert res.converged
    return cpu, gpu, res


@pytest.mark.cuda
def test_cuda_sternheimer_solve_matches_cpu(si2_response_state):
    """One Sternheimer solve of chi0 (15 CG steps, the Schur complement of
    the 3 unoccupied bands) on the card against the same solve on the CPU
    (1e-11 of max|dpsi|): every apply of H through the kernels, no plain
    version."""
    from dftk_tpu_torch.interop import scf_state_from_numpy
    from dftk_tpu_torch.ops import hamiltonian as hamops
    from dftk_tpu_torch.response.chi0 import apply_dV, make_chi0_context, sternheimer_solver
    cpu, gpu, res = si2_response_state
    state = scf_state_from_numpy(gpu, res.psi.numpy(), res.occupation, res.eigenvalues,
                                 res.epsF, res.rho.numpy())
    dV = np.random.default_rng(42).normal(size=(1,) + cpu.fft_size) * 0.1
    out = {}
    for basis, st in ((cpu, res), (gpu, state)):
        ctx = make_chi0_context(st, basis)
        occ_mask = ctx.occupation > 1e-8
        rhs = apply_dV(ctx.ham, ctx.psi, basis.tensor(dV), basis.data.kspin)
        la.counts.reset()
        out[basis.device.type] = sternheimer_solver(
            lambda p: hamops.apply_H(ctx.ham, p), ctx.psi * occ_mask[:, :, None],
            ctx.eigenvalues, rhs * occ_mask[:, :, None], ctx.ham.kin, basis.data.mask,
            tol=0.0, maxiter=15, psi_extra=ctx.psi * (~occ_mask)[:, :, None],
            eps_extra=ctx.eigenvalues, extra_mask=~occ_mask)
    assert la.counts.launches["pruned_axis_dft"] > 0 and la.counts.launches["local_plane"] > 0
    assert all(v == 0 for v in la.counts.plain.values())
    assert _close_c128(out["cuda"], out["cpu"].cuda())


@pytest.mark.cuda
def test_cuda_omega_plus_k_apply_matches_cpu(si2_response_state):
    """(Omega + K) dpsi on the card against the CPU's (1e-11 of max|out|)
    on the occupied bands of the Si2 state and a seeded dpsi: the H apply
    and dV psi through the kernels, the XC kernel by double backward on
    the card, no plain version."""
    cpu, gpu, res = si2_response_state
    psi, occ = res.psi[:, :4], res.occupation[:, :4]
    rng = np.random.default_rng(43)
    dpsi = (rng.normal(size=psi.shape) + 1j * rng.normal(size=psi.shape)) * cpu.mask_np[:, None]
    out = {}
    for basis in (cpu, gpu):
        OmegaK, _, _ = dt.make_omega_plus_k(basis, psi.to(basis.device), occ)
        la.counts.reset()
        out[basis.device.type] = OmegaK(basis.tensor(dpsi, basis.dtype))
    assert la.counts.launches["pruned_axis_dft"] > 0 and la.counts.launches["local_plane"] > 0
    assert all(v == 0 for v in la.counts.plain.values())
    assert _close_c128(out["cuda"], out["cpu"].cuda())


@pytest.mark.cuda
def test_cuda_dynmat_dfpt_gamma_matches_cpu():
    """dynmat_dfpt_gamma of Gamma Si2 (Ecut 5, the SCF to 1e-12 on the CPU)
    on the card against the same on the CPU with the plain versions (1e-9
    of max|C|): the bare and induced dV psi, every Sternheimer apply of H
    and the clamped-ion Hessian on the card, kernels A and B launched and
    no plain version called."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    from dftk_tpu_torch.interop import scf_state_from_numpy
    from dftk_tpu_torch.response.phonon_dfpt import dynmat_dfpt_gamma
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dt.model_DFT(SI_LATTICE, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                         functionals=["lda_x", "lda_c_vwn"])
    cpu, gpu = (dt.PlaneWaveBasis(model, Ecut=5.0, kgrid=(1, 1, 1), device=d)
                for d in ("cpu", "cuda"))
    res = dt.self_consistent_field(cpu, tol=1e-12, maxiter=60)
    state = scf_state_from_numpy(gpu, res.psi.numpy(), res.occupation, res.eigenvalues,
                                 res.epsF, res.rho.numpy())
    C_cpu = dynmat_dfpt_gamma(res, tol=1e-7, sternheimer_tol=1e-10)
    la.counts.reset()
    C_gpu = dynmat_dfpt_gamma(state, tol=1e-7, sternheimer_tol=1e-10)
    assert la.counts.launches["pruned_axis_dft"] > 0 and la.counts.launches["local_plane"] > 0
    assert all(v == 0 for v in la.counts.plain.values())
    assert np.isfinite(C_gpu).all()
    assert np.abs(C_gpu - C_cpu).max() <= 1e-9 * np.abs(C_cpu).max()


@pytest.mark.cuda
def test_cuda_perm_ham_and_dv_q_match_plain(gpu_basis, monkeypatch):
    """At q = X on Si2's 8 k-points: H at k+q through the permuted Ham (the
    pruned sphere maps permuted with the rest) against H at k_perm, and the
    complex dV_q psi of `response/chi0.py::apply_dV_q` (Re and Im of the
    phased potential as two local applies on kernels A -> B -> A, gathered on
    the k+q spheres) against the same with the plain versions, both within
    1e-14 of max|out|; 4 launches of A and 2 of B for the dV_q psi, no
    plain version called on the card."""
    from dftk_tpu_torch.ops import hamiltonian as hamops
    from dftk_tpu_torch.response import chi0 as chi0_mod
    from dftk_tpu_torch.response import phonon_q as pq
    basis = gpu_basis
    qctx = pq.QContext(basis, [0.5, 0.0, 0.0])
    assert (qctx.G0 != 0).any()
    rng = np.random.default_rng(44)
    grid = (1,) + basis.fft_size
    V = basis.tensor(rng.normal(size=grid))
    dv = basis.tensor(rng.normal(size=grid) + 1j * rng.normal(size=grid), basis.dtype)
    shape = (basis.n_kpoints, 6, basis.nG_max)
    psi = basis.tensor((rng.normal(size=shape) + 1j * rng.normal(size=shape))
                       * basis.mask_np[:, None], basis.dtype)
    ham = hamops.build_ham(basis.data, basis.terms.data, V, basis.pruned)
    p = qctx.perm_t
    la.counts.reset()
    hq = hamops.apply_H(pq._perm_ham(ham, p), psi[p])
    out = chi0_mod.apply_dV_q(ham, psi, dv, basis.data.kspin, p, qctx.phase)
    torch.cuda.synchronize()
    assert la.counts.launches["pruned_axis_dft"] == 6 and la.counts.launches["local_plane"] == 3
    assert all(v == 0 for v in la.counts.plain.values())
    want_hq = hamops.apply_H(ham, psi)[p]
    monkeypatch.setattr(chi0_mod, "local_apply", la.local_apply_plain)
    ref = chi0_mod.apply_dV_q(ham, psi, dv, basis.data.kspin, p, qctx.phase)
    for a, b in ((hq, want_hq), (out, ref)):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-14 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gamma", "kgrid"])
def test_cuda_exchange_and_ace_match_cpu(case):
    """The bare exchange apply (torch.fft over cuFFT) and the ACE build and
    apply (Cholesky and two GEMMs) on the card against the same on the CPU,
    within 1e-12 of max|out|: HF helium at Gamma (L = 8, Ecut 8) and on the
    (2, 1, 1) k-grid with the truncated kernel, on seeded orthonormal
    orbitals with occupations 2 and 0.5 on the first two bands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from dftk_tpu_torch.ops import hamiltonian as hamops
    from dftk_tpu_torch.ops.exx_ace import apply_ace, build_ace
    He = dt.ElementPsp.from_symbol("He", psp="lda/he-q2")

    def basis(device):
        if case == "gamma":
            model = dt.model_HF(np.eye(3) * 8.0, [He], [np.array([0.5, 0.5, 0.5])],
                                symmetries=False)
            return dt.PlaneWaveBasis(model, Ecut=8.0, kgrid=(1, 1, 1), device=device)
        terms = [dt.Kinetic(), dt.AtomicLocal(), dt.AtomicNonlocal(), dt.Ewald(),
                 dt.PspCorrection(), dt.Hartree(),
                 dt.ExactExchange(kernel=dt.SphericallyTruncatedCoulomb(rc=4.0))]
        model = dt.Model(np.eye(3) * 8.0, [He], [np.array([0.5, 0.5, 0.5])],
                         term_types=terms, symmetries=False)
        return dt.PlaneWaveBasis(model, Ecut=5.0, kgrid=(2, 1, 1), fft_size=(16, 16, 16),
                                 device=device)

    outs = {}
    for device in ("cpu", "cuda"):
        b = basis(device)
        rng = np.random.default_rng(8)
        shape = (b.n_kpoints, 4, b.nG_max)
        X = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * b.mask_np[:, None]
        X = np.stack([np.linalg.qr(x.T)[0].T for x in X])
        psi = b.tensor(X, b.dtype)
        occ = torch.zeros((b.n_kpoints, 4), dtype=torch.float64, device=device)
        occ[:, 0], occ[:, 1] = 2.0, 0.5
        exx = hamops.make_exchange(b.data, b.terms.data, psi, occ, 2.0,
                                   b.model.unit_cell_volume)
        assert (exx.iq is None) == (case == "gamma")
        outs[device] = [t.cpu() for t in (hamops.apply_exchange(exx, psi),
                                          apply_ace(build_ace(exx), psi))]
    for a, ref in zip(outs["cuda"], outs["cpu"]):
        assert bool(torch.isfinite(a).all())
        assert float((a - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("nk, nb, m, n", [
    (1, 9, (32, 32, 8), (64, 64, 1)),       # 2D Fock-Darwin / rotating GP: a plane, n3 = 1
    (1, 12, (32, 32, 8), (60, 60, 1)),      # 2D anyons (Ecut 20, a = 14)
    (1, 3, (32, 32, 8), (64, 64, 1)),       # ... a short LOBPCG block
    (1, 4, (104, 8, 8), (216, 1, 1)),       # 1D GP (Ecut 500): a line, n2 = n3 = 1
    (1, 12, (104, 8, 8), (216, 1, 1))])     # ... its LOBPCG block of 3 x 4
def test_cuda_kernels_on_unit_axes(nk, nb, m, n):
    """Kernels A and B and the A -> B -> A chain on the 2D cells' planes
    (n3 = 1) and the 1D cell's line (n2 = n3 = 1), where the compact axes
    padded to 8 are longer than their grid axes: complex128 at 1e-11 of
    max|out|, bf16 by the margin rule, with the pruned factors of such an
    axis (one live row of all ones, seven zero rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    rng = np.random.default_rng(45)

    def factor(a, b, fwd):
        F = np.zeros((a, b), dtype=complex) if b == 1 else None
        if F is not None:
            F[0, 0] = 1.0
            return torch.as_tensor(F if fwd else F.T.copy(), device="cuda")
        return _c128(rng, (a, b) if fwd else (b, a), (a if fwd else b) ** -0.5)

    x = _c128(rng, (nk, nb) + m)
    V = torch.as_tensor(rng.normal(size=(nk, n[2], n[0], n[1])), device="cuda")
    fac = la.LocalFactors(fwd=tuple(factor(a, b, True) for a, b in zip(m, n)),
                          bwd=tuple(factor(a, b, False) for a, b in zip(m, n)))
    t = la.pruned_axis_dft_plain(x, fac.fwd[2], True).contiguous()
    la.counts.reset()
    assert _close_c128(la.pruned_axis_dft(x, fac.fwd[2], True),
                       la.pruned_axis_dft_plain(x, fac.fwd[2], True))
    assert _close_c128(la.pruned_axis_dft(t, fac.bwd[2], False),
                       la.pruned_axis_dft_plain(t, fac.bwd[2], False))
    assert _close_c128(la.local_plane(t, V, fac), la.local_plane_plain(t, V, fac))
    assert _close_c128(la.local_apply(x, V, fac), la.local_apply_plain(x, V, fac))
    c64 = lambda f: f.to(torch.complex64)
    x64, t64, V32 = c64(x), c64(t), V.float()
    fac64 = la.LocalFactors(fwd=tuple(map(c64, fac.fwd)), bwd=tuple(map(c64, fac.bwd)))
    for kern, plain in (
            (lambda p: la.pruned_axis_dft(x64, fac64.fwd[2], True, p),
             lambda p: la.pruned_axis_dft_plain(x64, fac64.fwd[2], True, p)),
            (lambda p: la.pruned_axis_dft(t64, fac64.bwd[2], False, p),
             lambda p: la.pruned_axis_dft_plain(t64, fac64.bwd[2], False, p)),
            (lambda p: la.local_plane(t64, V32, fac64, precision=p),
             lambda p: la.local_plane_plain(t64, V32, fac64, p)),
            (lambda p: la.local_apply(x64, V32, fac64, p),
             lambda p: la.local_apply_plain(x64, V32, fac64, p))):
        assert _margin(kern("default"), plain("default"), plain("highest"))
    assert la.counts.launches["pruned_axis_dft"] == 4
    assert la.counts.launches["local_plane"] == 2
    assert la.counts.launches["pruned_axis_dft[bf16]"] == 4
    assert la.counts.launches["local_plane[bf16]"] == 2


def _post_bases():
    """name -> (basis on the card, band block) of the postprocess paths'
    new shapes: the Si54 fine basis of the two-grid refinement (Ecut 15,
    grid 80^3, compact cube 40^3; its SCF's block of 118 bands) and
    examples/band_structure_dos.py's silicon (Ecut 12, grid 30^3) at two
    band-path k-points off Gamma (X, and 2/7 of the way from Gamma to L)
    with compute_bands' block of 8 + 3 bands."""
    from dftk_tpu_torch.tools.run_si_big import build_bench_basis
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dt.model_DFT(SI_LATTICE, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                         functionals=["lda_x", "lda_c_vwn"])
    path = dt.PlaneWaveBasis(model, Ecut=12.0, fft_size=(30, 30, 30), device="cuda",
                             kgrid=dt.ExplicitKpoints([[0.5, 0.0, 0.5], [2 / 7, 2 / 7, 2 / 7]]),
                             use_symmetries_for_kpoint_reduction=False)
    return {"si54_ecut15": (build_bench_basis(3, 15.0, "cuda"), 118), "band_path": (path, 11)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["si54_ecut15", "band_path"])
@pytest.mark.parametrize("dtype, bar", [(torch.complex128, 1e-11), (torch.complex64, 1e-5)])
def test_cuda_kernels_at_post_shapes(case, dtype, bar):
    """Kernels A (forward and back), B and the A -> B -> A chain against
    their plain versions with the basis' own pruned factors at the
    postprocess paths' shapes (phase 3's bars: complex128 1e-11 and
    complex64 1e-5 of max|out|), on seeded orbitals and potentials."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    b, nb = _post_bases()[case]
    m, n = b.pruned.m_shape, b.fft_size
    fac = la.LocalFactors(fwd=tuple(f.to(dtype) for f in b.pruned.factors.fwd),
                          bwd=tuple(f.to(dtype) for f in b.pruned.factors.bwd))
    rdt = torch.float64 if dtype == torch.complex128 else torch.float32
    rng = np.random.default_rng(20)
    xc = _c128(rng, (b.n_kpoints, nb) + m).to(dtype)
    V = torch.as_tensor(rng.normal(size=(b.n_kpoints, n[2], n[0], n[1])), device="cuda").to(rdt)

    def close(out, ref):
        torch.cuda.synchronize()
        assert out.shape == ref.shape and bool(torch.isfinite(out).all())
        return float((out - ref).abs().max()) <= bar * float(ref.abs().max())

    la.counts.reset()
    t = la.pruned_axis_dft(xc, fac.fwd[2], forward=True)
    assert close(t, la.pruned_axis_dft_plain(xc, fac.fwd[2], True))
    assert close(la.pruned_axis_dft(t, fac.bwd[2], forward=False),
                 la.pruned_axis_dft_plain(t, fac.bwd[2], False))
    assert close(la.local_plane(t, V, fac), la.local_plane_plain(t, V, fac))
    assert close(la.local_apply(xc, V, fac), la.local_apply_plain(xc, V, fac))
    assert sum(la.counts.launches.values()) >= 6
