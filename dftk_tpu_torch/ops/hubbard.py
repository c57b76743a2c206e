"""DFT+U (the rotationally invariant Dudarev form).

Port of `dftk_tpu/ops/hubbard.py` (reference src/terms/hubbard.jl): a
Hubbard correction on manifolds of pseudo-atomic orbitals (the UPF
pseudo-wavefunctions),

    E_U = sum_sigma U/2 Tr[ n^sigma (1 - n^sigma) ],
    n^sigma_mm' = sum_{kn in sigma} w_k f_kn <psi_kn|phi_m><phi_m'|psi_kn>

with the potential V_U = sum_mm' U (1/2 delta - n)_mm' |phi_m><phi_m'|,
applied like a nonlocal projector pair (two more GEMMs in H psi).  The SCF
loops build n from the orbitals and occupations that enter the step, as
for the exchange operator.  Where the k-points are the irreducible wedge,
n is averaged over the crystal's operations, each rotating the real
spherical harmonics of the manifold (`real_sph_rotation`).

The `*_split` functions keep the JAX package's split-engine API, realified
orbitals and projectors [nk, n, 2nG] and the Hermitian split (nr, ni) of n,
at the boundary only: they compute on complex tensors through the
functions above (the realified algebra is a TPU workaround, ROADMAP "Not
to port").
"""
import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from ..parallel.mesh import ksum, local_rows
from ..utils.special import LM_INDEX, solid_harmonics_real


@dataclasses.dataclass(frozen=True)
class HubbardManifold:
    atom_index: int
    l: int
    U: float            # Hubbard U (Hartree)
    i: int = 1          # which radial pswfc of that l (1-based)


def build_hubbard_projectors(basis, manifolds: Sequence[HubbardManifold]):
    """(Phi [nk, nG, n_orb] on the basis' device, slices): the atomic-orbital
    projectors, each normalised on the discrete basis, in manifold order
    with m = -l..l within each; slices[i] = (start, stop) of manifold i."""
    model = basis.model
    sqrt_vol = math.sqrt(model.unit_cell_volume)
    Gpk = basis.Gpk_cart_np
    Gpk_norm = np.linalg.norm(Gpk, axis=-1)
    Gred_pk = basis.Gred_np.astype(float) + basis.kcoords_spin[:, None, :]
    cols, slices = [], []
    for mf in manifolds:
        psp = model.atoms[mf.atom_index].psp
        if not hasattr(psp, "pswfc_fourier"):
            raise ValueError("Hubbard manifolds need pseudo-atomic orbitals "
                             "(UPF pseudopotentials)")
        rad = psp.pswfc_fourier(mf.i, mf.l, Gpk_norm)
        Y = solid_harmonics_real(Gpk, mf.l)
        sf = np.exp(-2j * math.pi * (Gred_pk @ np.asarray(model.positions[mf.atom_index])))
        start = len(cols)
        for m in range(-mf.l, mf.l + 1):
            col = (sf * rad * (-1j) ** mf.l * Y[..., LM_INDEX[(mf.l, m)]] / sqrt_vol) \
                * basis.mask_np
            nrm = np.sqrt(np.sum(np.abs(col) ** 2, axis=1, keepdims=True))
            cols.append(col / np.maximum(nrm, 1e-300))
        slices.append((start, len(cols)))
    return basis.tensor(np.stack(cols, axis=-1), basis.dtype), slices


def _proj(Phi, psi):
    """<phi_m|psi_n>: [nk, nb, n_orb]."""
    return psi @ Phi.conj()


def occupation_matrix(Phi, psi, occupation, kweights, kspin, n_spin, comm=None):
    """n^sigma_mm' [nspin, n_orb, n_orb] (Hermitian; summed over the "kpts"
    axis of comm)."""
    proj = _proj(Phi, psi.to(Phi.dtype))
    w = (kweights[:, None] * occupation).to(proj.dtype)
    nk_mat = torch.einsum("kn,knm,knp->kmp", w, proj, proj.conj())
    sel = torch.nn.functional.one_hot(kspin, n_spin).to(nk_mat.dtype)
    n = ksum(torch.einsum("ks,kmp->smp", sel, nk_mat), comm)
    return (n + n.conj().transpose(1, 2)) / 2


def _blocks(n, manifolds, slices, filled):
    """(manifold, spin, a, b, n_sigma of the block) with n per spin channel:
    without spin the occupations carry filled = 2, and each channel holds
    half of n."""
    scale = filled if n.shape[0] == 1 else 1.0
    for mf, (a, b) in zip(manifolds, slices):
        for s in range(n.shape[0]):
            yield mf, s, a, b, n[s, a:b, a:b] / scale, scale


def hubbard_energy(n, manifolds, slices, filled):
    """E_U = sum_sigma sum_manifolds U/2 Tr[n (1 - n)]."""
    E = torch.zeros((), dtype=n.real.dtype, device=n.device)
    for mf, _, _, _, ns, scale in _blocks(n, manifolds, slices, filled):
        E = E + scale * mf.U / 2 * torch.diagonal(ns - ns @ ns).sum().real
    return E


def hubbard_potential_matrix(n, manifolds, slices, filled):
    """V_mm' [nspin, n_orb, n_orb]: U (1/2 delta - n) on each manifold."""
    V = torch.zeros_like(n)
    for mf, s, a, b, ns, _ in _blocks(n, manifolds, slices, filled):
        V[s, a:b, a:b] = mf.U * (0.5 * torch.eye(b - a, dtype=n.dtype, device=n.device) - ns)
    return V


def apply_hubbard(Phi, Vmat, kspin, psi):
    """sum_mm' V_mm' |phi_m><phi_m'|psi>: [nk, nb, nG]."""
    coeff = _proj(Phi, psi.to(Phi.dtype)) @ Vmat[kspin].transpose(1, 2)   # [nk, nb, n_orb]
    return coeff @ Phi.transpose(1, 2)


# ---------------------------------------------------------------------------
# Symmetrization of the occupation matrix (reference terms/hubbard.jl:
# symmetrize_nhubbard; needed where the k-points are the irreducible wedge)
# ---------------------------------------------------------------------------

def real_sph_rotation(l, Wcart):
    """D[m', m] with  Y_m(W^-1 r) = sum_m' D[m', m] Y_m'(r).

    Built by sampling: exact for orthogonal Wcart, since the real solid
    harmonics of one l span an invariant subspace."""
    if l == 0:
        return np.ones((1, 1))
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(8 * (2 * l + 1), 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    Y = solid_harmonics_real(pts, l)[:, l * l:(l + 1) * (l + 1)]
    Yr = solid_harmonics_real(pts @ np.linalg.inv(Wcart).T, l)[:, l * l:(l + 1) * (l + 1)]
    D, *_ = np.linalg.lstsq(Y, Yr, rcond=None)
    return D


def build_occupation_symmetrization(basis, manifolds, slices):
    """Per manifold, [(source slice, D), ...] over the basis' symmetries:
    the manifold of the preimage atom and the rotation of its orbitals."""
    model = basis.model
    L = model.lattice
    Linv = np.linalg.inv(L)
    plan = [[] for _ in manifolds]
    for op in basis.symmetries:
        W, w = op.Wmat, op.wvec
        Wcart = L @ W @ Linv
        for fi, mf in enumerate(manifolds):
            # preimage atom j:  W pos_j + w == pos_I (mod 1)
            target = np.linalg.solve(W, np.asarray(model.positions[mf.atom_index],
                                                   dtype=float) - w)
            src = None
            for mf2, sl2 in zip(manifolds, slices):
                if (mf2.l, mf2.i, mf2.U) != (mf.l, mf.i, mf.U):
                    continue
                d = np.asarray(model.positions[mf2.atom_index]) - target
                d -= np.round(d)
                if np.abs(d).max() < 1e-4:
                    src = sl2
                    break
            if src is None:
                raise ValueError(
                    "Hubbard manifold set is not closed under the crystal "
                    "symmetries; add the equivalent atoms or disable symmetries")
            plan[fi].append((src, real_sph_rotation(mf.l, Wcart)))
    return plan


def symmetrize_occupation_matrix(n, slices, plan):
    """Average each manifold's block of n over its symmetry plan."""
    out = n.clone()
    for (a, b), ops in zip(slices, plan):
        acc = 0.0
        for (a2, b2), D in ops:
            Dt = torch.as_tensor(D, dtype=n.dtype, device=n.device)
            acc = acc + Dt.conj().T @ n[:, a2:b2, a2:b2] @ Dt
        out[:, a:b, a:b] = acc / len(ops)
    return out


class HubbardSetup:
    """The +U term of a basis: projectors, manifolds and the occupation
    symmetrization plan, built once per SCF."""

    def __init__(self, basis, basis_data=None):
        model = basis.model
        self.bd = basis.data if basis_data is None else basis_data
        self.manifolds = basis.terms.hubbard_manifolds
        self.Phi, self.slices = build_hubbard_projectors(basis, self.manifolds)
        self.Phi = local_rows(basis, self.Phi).to(self.bd.Gpk_cart.dtype.to_complex())
        self.comm = basis.comm
        self.plan = build_occupation_symmetrization(basis, self.manifolds, self.slices)
        self.nspin = model.n_spin_components
        self.filled = model.filled_occupation

    def occupation(self, psi, occupation):
        """The symmetrized occupation matrix of psi at `occupation`."""
        n = occupation_matrix(self.Phi, psi, occupation, self.bd.kweights, self.bd.kspin,
                              self.nspin, self.comm)
        return symmetrize_occupation_matrix(n, self.slices, self.plan)

    def potential_apply(self, psi, occupation):
        """psi' -> V_U psi' with n from psi at `occupation`."""
        V = hubbard_potential_matrix(self.occupation(psi, occupation), self.manifolds,
                                     self.slices, self.filled)
        return lambda p: apply_hubbard(self.Phi, V, self.bd.kspin, p).to(p.dtype)

    def energy(self, psi, occupation):
        return hubbard_energy(self.occupation(psi, occupation), self.manifolds, self.slices,
                              self.filled)


# ---------------------------------------------------------------------------
# The split-engine API (realified rows [x; y], the Hermitian split of n)
# ---------------------------------------------------------------------------

def _rows(X):
    return torch.cat([X.real, X.imag], dim=-1)


def _cplx(U):
    nG = U.shape[-1] // 2
    return torch.complex(U[..., :nG], U[..., nG:])


def realify_projectors(Phi, dtype=None):
    """Complex Phi [nk, nG, n_orb] -> realified rows [nk, n_orb, 2nG]."""
    out = _rows(torch.as_tensor(Phi).transpose(1, 2))
    return out if dtype is None else out.to(dtype)


def _phi(Phi_r):
    """Realified rows [nk, n_orb, 2nG] -> complex Phi [nk, nG, n_orb]."""
    return _cplx(Phi_r).transpose(1, 2)


def occupation_matrix_split(Phi_r, U, occupation, kweights, kspin, n_spin):
    """(nr, ni) [nspin, n_orb, n_orb]: the real (symmetric) and imaginary
    (antisymmetric) parts of `occupation_matrix` of the realified bands U."""
    n = occupation_matrix(_phi(Phi_r), _cplx(U), occupation, kweights, kspin, n_spin)
    return n.real, n.imag


def hubbard_energy_split(nr, ni, manifolds, slices, filled):
    return hubbard_energy(torch.complex(nr, ni), manifolds, slices, filled)


def hubbard_potential_matrix_split(nr, ni, manifolds, slices, filled):
    """(Vr, Vi): the parts of U (1/2 delta - n)."""
    V = hubbard_potential_matrix(torch.complex(nr, ni), manifolds, slices, filled)
    return V.real, V.imag


def apply_hubbard_split(Phi_r, Vr, Vi, kspin, U):
    """V_U applied to realified bands U [nk, nb, 2nG]."""
    return _rows(apply_hubbard(_phi(Phi_r), torch.complex(Vr, Vi), kspin, _cplx(U)))


def symmetrize_occupation_matrix_split(nr, ni, slices, plan):
    n = symmetrize_occupation_matrix(torch.complex(nr, ni), slices, plan)
    return n.real, n.imag
