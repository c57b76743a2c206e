"""dftk_tpu_torch's CUDA kernels on the GPU (skipped without one).

Imports only torch and the port, so that it runs on a machine without jax:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: tests/conftest.py configures jax).  The kernels are held
against their plain PyTorch versions, complex128 at 1e-11 and complex64 at
1e-5 of max|out|; the bf16 ('default') instantiations so that the
kernel-vs-plain difference is at least 10x below the plain
'default'-vs-'highest' difference (relative Frobenius norms: both round the
same operands and sum in other orders).  The Si2 SCF and the Si2 split
CheFSI SCF ("mixed" filter) on the GPU are held against the same SCFs on
the CPU (1e-9 Ha).
"""
import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.kernels import local_apply as la

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])


def _si2(device):
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dt.model_DFT(SI_LATTICE, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
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
    for strip in (None, 5):
        assert close(la.local_plane(t, V, fac, strip=strip),
                     la.local_plane_plain(t, V, fac))
    assert close(la.local_apply(xc, V, fac), la.local_apply_plain(xc, V, fac))


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
            (la.local_plane(t, V, fac, strip=7, precision="default"),
             la.local_plane_plain(t, V, fac, "default"), la.local_plane_plain(t, V, fac)),
            (la.local_apply(xc, V, fac, "default"),
             la.local_apply_plain(xc, V, fac, "default"), la.local_apply_plain(xc, V, fac))):
        assert 10 * rel(kern, plain) <= rel(plain, highest)
    assert la.counts.launches["pruned_axis_dft[bf16]"] == 3
    assert la.counts.launches["local_plane[bf16]"] == 2
    with pytest.raises(TypeError, match="complex64"):
        la.local_plane(t.to(torch.complex128), V.double(), b.pruned.factors,
                       precision="default")


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
