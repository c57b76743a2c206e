"""Transfer of Bloch waves and densities between plane-wave bases.

Port of `dftk_tpu/transfer.py` (reference `src/transfer.jl`,
`src/interpolation.jl`): both bases index their spheres by integer G
vectors, so a transfer is a gather with zero fill for the G outside the
source sphere, exact when the basis grows (Ecut_out >= Ecut_in) and a
spectral truncation otherwise.  Densities transfer through the Fourier cube
the same way, on `torch.fft`.

The index maps are built on the host: each sphere's integer G vectors are
encoded as one int64 key per G, and a sorted search finds every output G
in the input sphere (the JAX package looks them up in one Python dict per
k-point; the indices are the same).
"""
import numpy as np
import torch

from .ops import fft as fftops
from .parallel.mesh import refuse_distributed


def _keys(G, span):
    """One int64 per integer G vector [n, 3] whose components lie in
    (-span, span)."""
    G = np.asarray(G, dtype=np.int64) + span
    return (G[:, 0] * (2 * span) + G[:, 1]) * (2 * span) + G[:, 2]


def _sphere_lookup(G_in, G_out):
    """For each row of G_out [m, 3] its row in G_in [n, 3], or -1."""
    if len(G_in) == 0 or len(G_out) == 0:
        return np.full(len(G_out), -1, dtype=np.int64)
    span = int(max(np.abs(G_in).max(), np.abs(G_out).max())) + 1
    k_in, k_out = _keys(G_in, span), _keys(G_out, span)
    order = np.argsort(k_in, kind="stable")
    pos = np.clip(np.searchsorted(k_in[order], k_out), 0, len(k_in) - 1)
    hit = k_in[order][pos] == k_out
    return np.where(hit, order[pos], -1)


def transfer_mapping(basis_in, basis_out):
    """For each (k, G_out) the padded index into the k-sphere of basis_in.

    Returns (idx [nk, nG_out] int64 numpy pointing into nG_in (nG_in means
    missing), valid [nk, nG_out] float 1/0).  Requires identical k-point
    lists.
    """
    refuse_distributed(basis_in, "transfer_mapping")
    assert basis_in.n_kpoints == basis_out.n_kpoints
    nk = basis_in.n_kpoints
    nG_in = basis_in.nG_max
    idx = np.full((nk, basis_out.nG_max), nG_in, dtype=np.int64)
    for ik in range(nk):
        n_in, n_out = int(basis_in.mask_np[ik].sum()), int(basis_out.mask_np[ik].sum())
        src = _sphere_lookup(basis_in.Gred_np[ik, :n_in], basis_out.Gred_np[ik, :n_out])
        idx[ik, :n_out] = np.where(src >= 0, src, nG_in)
    valid = (idx < nG_in).astype(np.float64)
    return idx, valid


def transfer_blochwave(psi, basis_in, basis_out):
    """psi [nk, nb, nG_in] -> [nk, nb, nG_out] (zero-padded / truncated),
    on basis_out's device."""
    refuse_distributed(basis_in, "transfer_blochwave")
    idx, valid = transfer_mapping(basis_in, basis_out)
    psi = torch.as_tensor(psi, device=basis_out.device)
    nk, nb = psi.shape[:2]
    psi_pad = torch.cat([psi, psi.new_zeros((nk, nb, 1))], dim=-1)
    index = torch.as_tensor(idx, device=psi.device)[:, None, :].expand(nk, nb, idx.shape[1])
    out = torch.gather(psi_pad, 2, index)
    return out * torch.as_tensor(valid, device=psi.device, dtype=psi.real.dtype)[:, None, :]


def transfer_density(rho, basis_in, basis_out):
    """Fourier-space transfer of a density [..., n1, n2, n3] between the
    real-space grids of two bases (the same integral on both)."""
    rho = torch.as_tensor(rho, device=basis_out.device)
    rho_G = torch.fft.fftn(rho, dim=(-3, -2, -1))
    lead = tuple(rho.shape[:-3])
    idx_out = fftops.index_G_vectors(basis_out.fft_size, basis_in.G_cube.reshape(-1, 3))
    sel = idx_out >= 0
    N_out = int(np.prod(basis_out.fft_size))
    src = rho_G.reshape(lead + (-1,))[..., torch.as_tensor(np.nonzero(sel)[0],
                                                          device=rho.device)]
    out_flat = torch.zeros(lead + (N_out,), dtype=rho_G.dtype, device=rho.device)
    out_flat[..., torch.as_tensor(idx_out[sel], device=rho.device)] = src
    scale = N_out / np.prod(basis_in.fft_size)
    return torch.fft.ifftn(out_flat.reshape(lead + tuple(basis_out.fft_size)),
                           dim=(-3, -2, -1)).real * scale


def interpolate_kpoint(psi_k, basis_in, ik_in, basis_out, ik_out):
    """Transfer one k-point's orbitals [nb, nG_in] between (possibly
    different) k-points of two bases, G vectors matched by integer value;
    a tensor [nb, nG_out] on basis_out's device."""
    n_in = int(basis_in.mask_np[ik_in].sum())
    n_out = int(basis_out.mask_np[ik_out].sum())
    src = _sphere_lookup(basis_in.Gred_np[ik_in, :n_in], basis_out.Gred_np[ik_out, :n_out])
    psi_k = torch.as_tensor(psi_k, device=basis_out.device)
    out = psi_k.new_zeros((psi_k.shape[0], basis_out.nG_max))
    hit = np.nonzero(src >= 0)[0]
    out[:, torch.as_tensor(hit, device=out.device)] = \
        psi_k[:, torch.as_tensor(src[hit], device=out.device)]
    return out
