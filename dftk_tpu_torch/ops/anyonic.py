"""The anyonic term: average-field almost-bosonic anyons in 2D.

Port of `dftk_tpu/ops/anyonic.py` (reference src/terms/anyonic.jl,
arXiv:1901.10739).  The electrons couple to the self-consistent
Chern-Simons gauge field

    curl A = 2 pi rho,   div A = 0
    =>  A_hat(G) = 2 pi i (G_2, -G_1, 0) / |G|^2  rho_hat(G)

through  E[psi] = sum_n f_n <psi_n| 2 hbar beta A.p + beta^2 |A|^2 |psi_n>
(the kinetic term comes separately, with scaling_factor=2, as in the
reference example examples/anyons.jl).

A = A_SR[rho - rho_ref] + A_ref, the reference's long/short-range split
(anyonic.jl:13-41): rho_ref is a mass-M Gaussian at the cell centre and
A_ref its analytic gauge field, projected divergence-free in the finite
basis (anyonic.jl:44-61); the spectral solve then acts on a zero-mass
density.  The reference fields are host numpy, made once at setup.

The term is an energy functional of the orbitals: `scf/direct.py`
minimizes it with the torch.autograd gradient, which carries the current-
response potential -2 beta xperp/|x|^2 * (hbar J + beta rho A) by itself.
`apply_anyonic` keeps the reference's hand-derived operator
(anyonic.jl:103-152).  torch's gradient of a real function of complex psi
is the conjugate of jax.grad's, so the autograd gradient of
`anyonic_energy` equals 2 w f (H_anyonic psi), without a conjugation
(ROADMAP "Known differences: Complex gradients").

All the FFT work is torch.fft over the whole cube (cuFFT on the card), as
the JAX package's is XLA FFTs outside Pallas.  Gamma only, n_dim == 2, a
square lattice, one spin component (as the reference, anyonic.jl:68-76).
"""
import math

import numpy as np
import torch

from .fft import gather_from_cube, scatter_to_cube

SIGMA_REF = 2.0


def reference_fields(lattice, fft_size, M, sigma=SIGMA_REF):
    """(rho_ref [grid], Aref [grid, 2]), numpy: a mass-M Gaussian at the
    cell centre and its analytic gauge field (curl Aref = 2 pi rho_ref)."""
    n1, n2, n3 = fft_size
    red = np.stack(np.meshgrid(np.arange(n1) / n1, np.arange(n2) / n2,
                               np.arange(n3) / max(n3, 1), indexing="ij"), axis=-1)
    red = red - np.array([0.5, 0.5, 0.0])
    rcart = np.einsum("ab,ijkb->ijka", np.asarray(lattice, dtype=float), red)
    x, y = rcart[..., 0], rcart[..., 1]
    r2 = x * x + y * y
    rho_ref = M * np.exp(-r2 / (2 * sigma ** 2)) / (2 * math.pi * sigma ** 2)
    # curl(phi(r) (-y, x)) = 2 phi + r phi'; the smooth solution of
    # r phi' + 2 phi = 2 pi rho_ref (anyonic.jl:25-41)
    alpha = 1.0 / (2 * sigma ** 2)
    C = M / sigma ** 2
    with np.errstate(invalid="ignore", divide="ignore"):
        phi = np.where(r2 > 1e-14,
                       0.5 * C / alpha / np.where(r2 > 1e-14, r2, 1.0) * (1 - np.exp(-alpha * r2)),
                       0.5 * C)
    return rho_ref, phi[..., None] * np.stack([-y, x], axis=-1)


def nyquist_mask(fft_size):
    """[grid] numpy mask that zeroes the Nyquist planes of even in-plane
    axes: there G(-k) != -G(k), so the real-field identities (curl/div,
    a Hermitian A.p) cannot hold, and the field solves project them out."""
    m = np.ones(fft_size)
    for ax in range(2):
        n = fft_size[ax]
        if n % 2 == 0:
            sl = [slice(None)] * 3
            sl[ax] = n // 2
            m[tuple(sl)] = 0.0
    return m


def make_div_free(A, G_cube_cart):
    """A [grid, 2] (numpy) projected onto divergence-free fields: the
    G-parallel component removed in Fourier space, G = 0 kept, the Nyquist
    planes zeroed (anyonic.jl:44-61)."""
    Gx, Gy = np.asarray(G_cube_cart[..., 0]), np.asarray(G_cube_cart[..., 1])
    G2 = Gx * Gx + Gy * Gy
    inv = np.where(G2 > 0, 1.0 / np.where(G2 > 0, G2, 1.0), 0.0)
    nyq = nyquist_mask(Gx.shape)
    Ax = np.fft.fftn(A[..., 0]) * nyq
    Ay = np.fft.fftn(A[..., 1]) * nyq
    dot = Gx * Ax + Gy * Ay
    Ax = Ax - dot * Gx * inv
    Ay = Ay - dot * Gy * inv
    return np.stack([np.fft.ifftn(Ax).real, np.fft.ifftn(Ay).real], axis=-1)


def _inv_G2(G_cart):
    G2 = G_cart[..., 0] ** 2 + G_cart[..., 1] ** 2
    return torch.where(G2 > 0, 1.0 / torch.where(G2 > 0, G2, torch.ones_like(G2)),
                       torch.zeros_like(G2))


def gauge_field(rho_tot, rho_ref, Aref, G_cart):
    """A [grid, 2] with curl A = 2 pi rho_tot, div A = 0 (differentiable in
    rho_tot [grid]): the spectral solve on rho_tot - rho_ref plus Aref;
    rho_ref [grid], Aref [grid, 2] and G_cart [grid, 3] are tensors."""
    Gx, Gy = G_cart[..., 0], G_cart[..., 1]
    inv = _inv_G2(G_cart)
    nyq = torch.as_tensor(nyquist_mask(tuple(rho_tot.shape)), dtype=rho_tot.dtype,
                          device=rho_tot.device)
    d_G = torch.fft.fftn(rho_tot - rho_ref) * nyq
    Ax = torch.fft.ifftn(2j * math.pi * Gy * inv * d_G).real
    Ay = torch.fft.ifftn(-2j * math.pi * Gx * inv * d_G).real
    return torch.stack([Ax, Ay], dim=-1) + Aref


def _psi_real(bd, psi, fft_size, volume):
    """psi [nk, nb, nG] on the real-space grid [nk, nb, n1, n2, n3]."""
    scale = math.prod(fft_size) / math.sqrt(volume)
    return torch.fft.ifftn(scatter_to_cube(psi, bd.Gidx, bd.mask, fft_size),
                           dim=(-3, -2, -1)) * scale


def anyonic_energy(bd, psi, occupation, rho_tot, rho_ref, Aref, G_cart, hbar, beta,
                   fft_size, volume):
    """E = sum_kn w f <psi| 2 hbar beta A.p + beta^2 |A|^2 |psi>, with rho_tot
    [grid] the density of psi (for the variational property; passed so the
    caller reuses its density)."""
    A = gauge_field(rho_tot, rho_ref, Aref, G_cart)
    dvol = volume / math.prod(fft_size)
    w = (bd.kweights[:, None] * occupation)[:, :, None, None, None]
    psir = _psi_real(bd, psi, fft_size, volume)
    E = torch.sum(w * (psir.real ** 2 + psir.imag ** 2) * (beta ** 2)
                  * torch.sum(A * A, dim=-1)) * dvol
    for a in range(2):
        pa = _psi_real(bd, bd.Gpk_cart[:, None, :, a] * psi, fft_size, volume)
        E = E + 2 * hbar * beta * torch.sum(w * (psir.conj() * pa).real * A[..., a]) * dvol
    return E


def current_density(bd, psi, occupation, fft_size, volume, n_axes=2):
    """J [n_axes, grid] = sum w f Im(psi* grad psi) (hbar factored out), its
    first n_axes Cartesian components (`postprocess/current.py` takes all
    three)."""
    psir = _psi_real(bd, psi, fft_size, volume)
    w = bd.kweights[:, None] * occupation
    out = []
    for a in range(n_axes):
        da = _psi_real(bd, 1j * bd.Gpk_cart[:, None, :, a] * psi, fft_size, volume)
        out.append(torch.einsum("kn,knxyz->xyz", w.to(psir.real.dtype),
                                (psir.conj() * da).imag))
    return torch.stack(out, dim=0)


def effective_potential(J_eff, G_cart):
    """The real potential of the current J_eff [2, grid]:
    V_hat = -4 pi i (G_2 J_1 - G_1 J_2) / |G|^2 (anyonic.jl:136-152); the
    caller applies the beta prefactor."""
    inv = _inv_G2(G_cart)
    nyq = torch.as_tensor(nyquist_mask(tuple(J_eff.shape[1:])), dtype=J_eff.dtype,
                          device=J_eff.device)
    ec1 = torch.fft.fftn(J_eff[0]) * nyq
    ec2 = torch.fft.fftn(J_eff[1]) * nyq
    pot_G = (-4j * math.pi) * (G_cart[..., 1] * ec1 - G_cart[..., 0] * ec2) * inv
    return torch.fft.ifftn(pot_G).real


def apply_anyonic(bd, psi, occupation, rho_tot, rho_ref, Aref, G_cart, hbar, beta,
                  fft_size, volume):
    """(H_anyonic psi) [nk, nb, nG]: 2 hbar beta sym(A.p) + beta^2 |A|^2 and
    the current-response potential (the reference's hand operator)."""
    A = gauge_field(rho_tot, rho_ref, Aref, G_cart)
    J = current_density(bd, psi, occupation, fft_size, volume)
    eff = torch.stack([hbar * J[a] + beta * rho_tot * A[..., a] for a in range(2)], dim=0)
    Vloc = (beta ** 2) * torch.sum(A * A, dim=-1) + beta * effective_potential(eff, G_cart)
    scale = math.prod(fft_size) / math.sqrt(volume)
    psir = _psi_real(bd, psi, fft_size, volume)

    def back(cube_r):
        return gather_from_cube(torch.fft.fftn(cube_r / scale, dim=(-3, -2, -1)),
                                bd.Gidx, bd.mask)

    out = back(Vloc * psir)
    for a in range(2):
        pa = _psi_real(bd, bd.Gpk_cart[:, None, :, a] * psi, fft_size, volume)
        # the symmetrised hbar beta {A_a, p_a} == 2 hbar beta A.p for a div-free A
        out = out + hbar * beta * back(A[..., a] * pa)
        out = out + hbar * beta * bd.Gpk_cart[:, None, :, a] * back(A[..., a] * psir)
    return out * bd.mask[:, None, :]
