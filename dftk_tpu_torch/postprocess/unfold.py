"""Unfold an IBZ SCF result onto the full (reducible) Brillouin zone.

Port of `dftk_tpu/postprocess/unfold.py` (reference `src/symmetry.jl:
360-430`): given a result on the irreducible wedge, rebuild the basis with
`use_symmetries_for_kpoint_reduction=False` and generate the Bloch
orbitals at every reducible k-point by applying the symmetry operations:

    phi(x) = psi_k(W x + w)  is a Bloch state at  k' = S k  (S = W^T) with
    c'_{S G + G0} = c_G * e^{2 pi i (G + k) . w},   G0 = k' - S k integer,

plus complex conjugation for k-points only reachable through time reversal
(k' = -S k).  The index maps, phases and conjugation flags are built on
the host from the integer sphere vectors; the gather of psi runs on the
basis' device.
"""
import dataclasses
import math

import numpy as np
import torch

from ..symmetry import SYMMETRY_TOLERANCE
from ..parallel.mesh import refuse_distributed


def _canon(k, tol=SYMMETRY_TOLERANCE):
    kk = np.asarray(k, float)
    kk = kk - np.round(kk)
    return tuple(np.round(kk / tol).astype(np.int64))


def _find_source(basis, k_red):
    """(ik_irr, op, tr) with tr S k_irr = k_red (mod 1), the first in the
    order of the model's operations, then tr = 1, -1, then the irreducible
    k-points."""
    for op in basis.model.symmetries:
        for tr in (1, -1):
            for ik_irr, k_irr in enumerate(basis.kcoords):
                if _canon(tr * (op.S @ k_irr)) == _canon(k_red):
                    return ik_irr, op, tr
    raise AssertionError(f"no symmetry maps any irr k to {k_red}")


def _replace(scfres, **fields):
    if dataclasses.is_dataclass(scfres):
        return dataclasses.replace(scfres, **fields)
    return scfres._replace(**fields)        # interop.SCFState


def unfold_bz(scfres):
    """A new result on the full reducible k-grid (equal k-weights): its
    basis, psi (a tensor on the basis' device), eigenvalues and occupation
    (numpy where the result's are, else tensors); the density and the other
    fields are the result's.  A result already on the full grid is
    returned as it is."""
    refuse_distributed(scfres.basis, "unfold_bz")
    from ..basis import PlaneWaveBasis

    basis = scfres.basis
    model = basis.model
    if basis.n_irreducible_kpoints == len(basis.kgrid.reducible_kcoords()):
        return scfres

    new_basis = PlaneWaveBasis(
        model, Ecut=basis.Ecut, kgrid=basis.kgrid, fft_size=basis.fft_size,
        device=basis.device, dtype=basis.dtype,
        symmetries_respect_rgrid=basis.symmetries_respect_rgrid,
        use_symmetries_for_kpoint_reduction=False)

    nk_irr = basis.n_irreducible_kpoints
    nk_red = new_basis.n_irreducible_kpoints
    nspin = model.n_spin_components
    nk_new, nG_new = new_basis.n_kpoints, new_basis.nG_max

    src_row = np.zeros(nk_new, dtype=np.int64)
    conj = np.zeros(nk_new, dtype=bool)
    idx = np.zeros((nk_new, nG_new), dtype=np.int64)
    phase = np.zeros((nk_new, nG_new), dtype=np.complex128)
    for ik_new in range(nk_red):
        ik_irr, op, tr = _find_source(basis, new_basis.kcoords[ik_new])
        Sinv = np.round(np.linalg.inv(op.S)).astype(int)
        k_irr = basis.kcoords[ik_irr]
        G0 = np.round(new_basis.kcoords[ik_new] - tr * (op.S @ k_irr)).astype(int)
        for ispin in range(nspin):
            row, src = ik_new + ispin * nk_red, ik_irr + ispin * nk_irr
            n_new = int(new_basis.mask_np[row].sum())
            # momentum match: tr S (G_src + k_irr) = G'' + k_red
            #   => G_src = tr S^-1 (G'' + G0)
            Gsrc = (tr * (new_basis.Gred_np[row, :n_new] + G0)) @ Sinv.T
            n_src = int(basis.mask_np[src].sum())
            src_index = {tuple(g): j for j, g in enumerate(basis.Gred_np[src, :n_src])}
            idx[row, :n_new] = [src_index[tuple(g)] for g in Gsrc]
            phase[row, :n_new] = np.exp(2j * math.pi * ((Gsrc + k_irr) @ op.wvec))
            src_row[row], conj[row] = src, tr == -1

    dev = new_basis.device
    psi = torch.as_tensor(scfres.psi, device=dev).to(new_basis.dtype)
    rows = torch.as_tensor(src_row, device=dev)
    nb = psi.shape[1]
    gather = torch.as_tensor(idx, device=dev)[:, None, :].expand(-1, nb, -1)
    psi_new = torch.gather(psi[rows], 2, gather) * new_basis.tensor(phase, new_basis.dtype)[:, None]
    flip = torch.as_tensor(conj, device=dev)[:, None, None]
    psi_new = torch.where(flip, psi_new.conj(), psi_new)

    def rows_of(a):
        if torch.is_tensor(a):
            return torch.as_tensor(a, device=dev)[rows]
        return np.asarray(a)[src_row]

    return _replace(scfres, basis=new_basis, psi=psi_new,
                    eigenvalues=rows_of(scfres.eigenvalues),
                    occupation=rows_of(scfres.occupation))
