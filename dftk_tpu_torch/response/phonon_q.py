"""Analytic DFPT dynamical matrices at a commensurate q.

Port of `dftk_tpu/response/phonon_q.py` (reference src/transfer.jl k+q
machinery and src/response/chi0.jl at q), on PR 16's Gamma path
(`response/phonon_dfpt.py`):

  * k+q without a second basis: on a full (unfolded) k-grid that contains
    q, wrap(k+q) = k_perm is another grid point, and the response
    delta psi_{n,k+q} lives in k_perm's Bloch sector.  The only extra
    bookkeeping is the integer shift G0 = k + q - k_perm, applied as the
    phase e^{2 pi i G0.x} on the real-space grid (`kpq_maps`, host numpy).
  * H at k+q is H with every per-k field of its `Ham` permuted, the pruned
    transforms' sphere maps among them (`_perm_ham`), so every Sternheimer
    apply at k+q runs kernels A -> B -> A as at k.
  * dV_q psi (`dv_times_psi_q`) goes through `response/chi0.py::apply_dV_q`:
    the complex potential times the sector phase, as two real local
    applies (Re and Im) on the kernels, gathered on the k+q spheres.
  * delta rho_q(x) = 2 sum_kn w f conj(u_nk) delta u_{n,k+q} e^{-2 pi i
    G0.x} (`drho_q_from_dpsi`, torch.fft, as the Gamma density derivative).
  * The kernel at q: Hartree at |q+G| (no G = 0 singularity at q != 0)
    and the XC kernel, real and local, applied to the real and imaginary
    parts of delta rho_q (`ops/hamiltonian.py::xc_potential_derivative`,
    NLCC core included).
  * The Ewald dynamical matrix at q in reciprocal plus real space
    (`dynmat_ewald_q`, host numpy, copied).

Insulators and metals (the divided-difference pairs at (k+q, k); q = 0 at
T > 0 goes to the Gamma code); psps with an NLCC core density raise, as in
the reference (its bare perturbation has no core term at q).  Collinear
spin follows the reference's `kpq_maps`, which pairs every row with the
first row at k+q, a spin-up one (ROADMAP Queue 3).
"""
import math

import numpy as np
import torch
from scipy.special import erfc

from ..ops import hamiltonian as hamops
from ..ops.ewald import default_eta, energy_ewald, ewald_sum_bounds
from ..ops.terms import Hartree, refuse_terms
from .chi0 import apply_dV_q, make_chi0_context, sternheimer_solver
from .phonon_dfpt import _atom_of_projector_column, _nonlocal_derivative, clamped_ion_hessian
from ..parallel.mesh import refuse_distributed


# ---------------------------------------------------------------------------
# Ewald dynamical matrix at q  (smooth convention: phases carry tau)
# ---------------------------------------------------------------------------

def dynmat_ewald_q(lattice, charges, positions, q, eta=None, Gbox=None, Rbox=None):
    """Ewald contribution to the dynamical matrix, Cartesian [na,3,na,3],
    numpy complex.

    "Smooth" convention: D_ab(q) = sum_R Phi(a0,bR) e^{2 pi i q.(x_b+R-x_a)}
    (related to the e^{iqR} gauge by diag(e^{-2 pi i q.x_a}); frequencies
    are identical).  Reciprocal part over K = B(G+q); real part over the
    erfc images; the q-independent self-force-constant sum enforces the
    acoustic sum rule at q = 0 exactly."""
    lattice = np.asarray(lattice, dtype=float)
    charges = np.asarray(charges, dtype=float)
    x = np.asarray(positions, dtype=float)            # [na, 3] reduced
    q = np.asarray(q, dtype=float)
    na = len(charges)
    if eta is None:
        eta = default_eta(lattice)
    if Gbox is None or Rbox is None:
        Gbox, Rbox = ewald_sum_bounds(lattice, x, eta)
    B = 2 * math.pi * np.linalg.inv(lattice.T)
    vol = abs(np.linalg.det(lattice))

    D = np.zeros((na, 3, na, 3), dtype=complex)

    # ---- reciprocal part ---------------------------------------------------
    def rec_sum(shift):
        """sum over K = B(G + shift) of KiKj w(K) e^{2 pi i G.dx}: the phase
        carries only the integer G part (the smooth convention, consistent
        with the real-space sum below)."""
        Gint = Gbox.astype(float)                     # [ng, 3] reduced
        Kc = (Gint + shift) @ B.T                     # cartesian
        K2 = np.sum(Kc * Kc, axis=1)
        keep = K2 > 1e-18
        Kc, K2, Gint = Kc[keep], K2[keep], Gint[keep]
        w = np.exp(-K2 / (4 * eta ** 2)) / K2         # [ng]
        dx = x[:, None, :] - x[None, :, :]            # [na, na, 3]
        ph = np.exp(2j * math.pi * np.einsum("gd,abd->gab", Gint, dx))
        KK = Kc[:, :, None] * Kc[:, None, :]          # [ng, 3, 3]
        return np.einsum("g,gij,gab->aibj", w, KK, ph)

    pref = 4 * math.pi / vol
    ZZ = charges[:, None] * charges[None, :]
    D += pref * np.einsum("ab,aibj->aibj", ZZ, rec_sum(q))
    # self term (q-independent): -delta_ab sum_c Z_a Z_c Re S0
    self_rec = pref * np.einsum("ac,aicj->aij", ZZ, rec_sum(np.zeros(3)).real)
    for a in range(na):
        D[a, :, a, :] -= self_rec[a]

    # ---- real-space part ---------------------------------------------------
    # phi(r) = erfc(eta r)/r; H_ij = d^2 phi/dr_i dr_j
    def Hij(dcart):
        d2 = np.sum(dcart * dcart, axis=-1)
        d = np.sqrt(d2)
        u = eta * d
        expf = np.exp(-u * u)
        phi1 = -(erfc(u) / d2 + 2 * eta / math.sqrt(math.pi) * expf / d)  # phi'
        phi2 = (2 * erfc(u) / (d2 * d)
                + 4 * eta / math.sqrt(math.pi) * expf / d2
                + 4 * eta ** 3 / math.sqrt(math.pi) * expf)               # phi''
        dh = dcart / d[..., None]
        eye = np.eye(3)
        return (phi2[..., None, None] * dh[..., :, None] * dh[..., None, :]
                + (phi1 / d)[..., None, None] * (eye - dh[..., :, None] * dh[..., None, :]))

    R = Rbox.astype(float)                            # [nr, 3] reduced
    for a in range(na):
        for b in range(na):
            dred = x[a] - x[b] - R                    # [nr, 3]
            dredk = dred[np.sum(dred * dred, axis=1) > 1e-18]
            if len(dredk) == 0:
                continue
            H = Hij(dredk @ lattice.T)                # [nr', 3, 3]
            phase = np.exp(-2j * math.pi * (dredk @ q))
            # pair term: -Z_a Z_b sum_R e^{-2 pi i q.(x_a-x_b-R)} H
            D[a, :, b, :] += -ZZ[a, b] * np.einsum("r,rij->ij", phase, H)
            # self term: +delta_ab contribution from all neighbours of a
            D[a, :, a, :] += ZZ[a, b] * np.einsum("rij->ij", H)
    return D


# ---------------------------------------------------------------------------
# k+q index maps
# ---------------------------------------------------------------------------

def kpq_maps(basis, q, tol=1e-8):
    """perm[ik] = index of wrap(k_ik + q) in the k list; G0[ik] the integer
    shift with k + q = k_perm + G0 (numpy).  Requires a q-commensurate
    unfolded grid.  Under collinear spin the first matching row is taken,
    a spin-up one, as in the reference."""
    refuse_distributed(basis, "kpq_maps")
    kcoords = np.asarray(basis.kcoords_spin, dtype=float)
    q = np.asarray(q, dtype=float)
    nk = len(kcoords)
    perm = np.zeros(nk, dtype=int)
    G0 = np.zeros((nk, 3), dtype=int)
    for ik in range(nk):
        d = (kcoords[ik] + q)[None, :] - kcoords      # [nk, 3]
        dint = np.round(d)
        js = np.nonzero(np.all(np.abs(d - dint) < tol, axis=1))[0]
        if len(js) == 0:
            raise ValueError(
                f"k-point grid is not commensurate with q={q}: no partner for "
                f"k={kcoords[ik]} (unfold the BZ and use a grid containing q)")
        perm[ik] = js[0]
        G0[ik] = dint[js[0]].astype(int)
    return perm, G0


def _r_cube(fft_size):
    """Reduced real-space grid points j / n [n1, n2, n3, 3]."""
    axes = [np.arange(n) / n for n in fft_size]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


def _phase_grids(basis, G0):
    """e^{2 pi i G0.x} on the real grid per k-point [nk, n1, n2, n3], a
    complex tensor on the basis' device."""
    ph = np.exp(2j * np.pi * np.einsum("kd,xyzd->kxyz", G0.astype(float),
                                       _r_cube(basis.fft_size)))
    return basis.tensor(ph, basis.dtype)


def _perm_ham(ham, perm):
    """H at k+q: every per-k field of `ham` taken at perm (a long tensor),
    the pruned transforms' sphere maps (Gidx_c, inv_idx) among them, so
    that H applies on the k+q spheres through the same kernels."""
    def take(t):
        return None if t is None else t[perm]
    pruned = ham.pruned._replace(Gidx_c=ham.pruned.Gidx_c[perm],
                                 inv_idx=ham.pruned.inv_idx[perm])
    return ham._replace(mask=ham.mask[perm], kin=ham.kin[perm], V_zxy=ham.V_zxy[perm],
                        P=ham.P[perm], pruned=pruned, Vtau_zxy=take(ham.Vtau_zxy),
                        Gpk=take(ham.Gpk))


# ---------------------------------------------------------------------------
# chi0 / kernel at q
# ---------------------------------------------------------------------------

def _hartree_scaling(model):
    for term in model.term_types:
        if isinstance(term, Hartree):
            return term.scaling_factor
    return 0.0


def apply_kernel_q(basis, rho0, drho_q, q):
    """K(q) drho_q [nspin, grid] complex: Hartree at |q+G| plus the local XC
    kernel.  drho_q [nspin, grid] complex (periodic part at +q).  The XC
    kernel is real and local, so it acts on the real and imaginary parts
    apart; the Hartree coefficients lose their G = 0 singularity at
    q != 0 (masked where |q+G|^2 < 1e-14)."""
    model = basis.model
    terms = basis.terms
    B = 2 * np.pi * np.linalg.inv(np.asarray(model.lattice).T)
    Gq = (basis.G_cube.astype(float) + np.asarray(q, dtype=float)) @ B.T
    Gq2 = np.sum(Gq * Gq, axis=-1)
    coeffs = basis.tensor(np.where(Gq2 > 1e-14, 4 * math.pi / np.where(Gq2 > 1e-14, Gq2, 1), 0.0))
    dVH = torch.fft.ifftn(coeffs * torch.fft.fftn(torch.sum(drho_q, dim=0)))
    dVH = dVH[None] * _hartree_scaling(model)
    rho0 = torch.as_tensor(rho0, dtype=basis.rdtype, device=basis.device)
    vol = model.unit_cell_volume
    dVxc = torch.complex(hamops.xc_potential_derivative(terms, rho0, drho_q.real, vol),
                         hamops.xc_potential_derivative(terms, rho0, drho_q.imag, vol))
    return dVH + dVxc


class QContext:
    """Precomputed k+q bookkeeping for one (basis, q): kpq_maps' perm (numpy,
    and `perm_t` on the basis' device) and G0, the sector phases
    e^{+2 pi i G0.x}, and whether q and every G0 are zero."""

    def __init__(self, basis, q):
        self.q = np.asarray(q, dtype=float)
        self.perm, self.G0 = kpq_maps(basis, q)
        self.perm_t = basis.tensor(self.perm, torch.int64)
        self.phase = _phase_grids(basis, self.G0)
        self.is_gamma = bool(np.allclose(self.q, 0) and np.all(self.G0 == 0))


def sternheimer_q(ctx, basis, qctx: QContext, rhs_sector, tol=1e-10, occupation_threshold=1e-8):
    """Solve the k+q Sternheimer equations (+ the metallic explicit
    divided-difference pairs when T > 0).

    rhs_sector [nk, nb, nG]: dH_q psi_nk already in the wrap(k+q) sector
    (slot ik holds a vector on the sphere of k_perm[ik]).  Returns dpsi in
    the same sector layout."""
    model = basis.model
    p = qctx.perm_t
    hamq = _perm_ham(ctx.ham, p)
    occ_mask = ctx.occupation > occupation_threshold
    m3 = occ_mask[:, :, None]
    psi_occ_q = (ctx.psi * m3)[p]                           # projector at k+q
    dpsi = sternheimer_solver(lambda v: hamops.apply_H(hamq, v), psi_occ_q, ctx.eigenvalues,
                              rhs_sector * m3, hamq.kin, basis.data.mask[p], tol=tol) * m3

    # metallic explicit pairs among the partially occupied bands of (m at
    # k+q, n at k): alpha_mn = ratio f_n / (f_n^2 + f_m^2), ratio the
    # occupation divided difference; m == n is included at q != 0
    # (reference chi0.jl:399-412, no separate delta-occ/Fermi term)
    smearing = model.smearing
    T = model.temperature
    if T > 0 and smearing is not None:
        from ..models.smearing import NoSmearing, occupation_divided_difference
        if not isinstance(smearing, NoSmearing):
            eps_kq, occ_kq = ctx.eigenvalues[p], ctx.occupation[p]   # [k, m] at k+q
            nb = ctx.psi.shape[1]
            em = eps_kq[:, :, None].expand(-1, -1, nb)
            en = ctx.eigenvalues[:, None, :].expand(-1, nb, -1)
            ratio = occupation_divided_difference(smearing, em, en, ctx.epsF, T) \
                * model.filled_occupation
            fm, fn = occ_kq[:, :, None], ctx.occupation[:, None, :]
            alpha = ratio * fn / torch.clamp(fn ** 2 + fm ** 2, min=1e-30)
            pair_mask = (occ_kq > occupation_threshold)[:, :, None] & occ_mask[:, None, :]
            if qctx.is_gamma:
                eye = torch.eye(nb, dtype=torch.bool, device=pair_mask.device)
                pair_mask = pair_mask & ~eye[None]
            alpha = torch.where(pair_mask, alpha, 0.0)
            psi_kq = ctx.psi[p]
            dots = torch.einsum("kmg,kng->kmn", psi_kq.conj(), rhs_sector)
            dpsi = dpsi + torch.einsum("kmn,kmg->kng", alpha.to(dots.dtype) * dots, psi_kq) * m3
    return dpsi


def drho_q_from_dpsi(ctx, basis, qctx: QContext, dpsi_sector, occupation_threshold=1e-8):
    """delta rho_q(x) [nspin, grid] complex = 2 sum w f conj(u_nk)
    du_sector e^{-2 pi i G0.x}."""
    from ..ops.fft import scatter_to_cube
    bd = basis.data
    fft_size = basis.fft_size
    nspin = basis.model.n_spin_components
    p = qctx.perm_t
    occ_w = torch.where(ctx.occupation > occupation_threshold, ctx.occupation, 0.0)
    psir = torch.fft.ifftn(scatter_to_cube(ctx.psi, bd.Gidx, bd.mask, fft_size),
                           dim=(-3, -2, -1))
    dpsir = torch.fft.ifftn(scatter_to_cube(dpsi_sector, bd.Gidx[p], bd.mask[p], fft_size),
                            dim=(-3, -2, -1))
    N = int(np.prod(fft_size))
    scale = (N / math.sqrt(basis.model.unit_cell_volume)) ** 2
    # factor 2: the -q branch (driven by u*) contributes the time-reversal
    # partner of each +q term to delta rho_q (QE's classic factor; reduces
    # to the Gamma code's 2 Re(psi* dpsi) as q -> 0)
    contrib = 2 * scale * psir.conj() * dpsir * qctx.phase.conj()[:, None]
    w = (bd.kweights[:, None] * occ_w).to(contrib.dtype)
    drho_k = torch.einsum("kn,knxyz->kxyz", w, contrib)
    if nspin == 1:
        return drho_k.sum(0)[None]
    sel = torch.nn.functional.one_hot(bd.kspin, nspin).to(drho_k.dtype)
    return torch.einsum("ks,kxyz->sxyz", sel, drho_k)


def dv_times_psi_q(ctx, basis, qctx: QContext, dv_grid):
    """(e^{2 pi i q.x} dv_per) psi_nk gathered on the wrap(k+q) spheres,
    sector phase included; dv_grid [nspin, grid] complex periodic part.
    Kernels A -> B -> A on a CUDA tensor (`response/chi0.py::apply_dV_q`)."""
    return apply_dV_q(ctx.ham, ctx.psi, dv_grid.to(basis.dtype), basis.data.kspin,
                      qctx.perm_t, qctx.phase)


# ---------------------------------------------------------------------------
# bare perturbations at q
# ---------------------------------------------------------------------------

def _dvloc_q_grids(basis, q):
    """Periodic part of dV_loc/du_{s,alpha} at +q: complex grids [na, 3, n1,
    n2, n3] on the basis' device; Fourier coefficients at wavevectors q+G."""
    model = basis.model
    Gq_red = basis.G_cube.reshape(-1, 3).astype(float) + np.asarray(q, float)
    B = 2 * np.pi * np.linalg.inv(np.asarray(model.lattice).T)
    Gq_cart = Gq_red @ B.T
    Gq_norm = np.linalg.norm(Gq_cart, axis=-1)
    N = int(np.prod(basis.fft_size))
    sqrt_vol = math.sqrt(model.unit_cell_volume)
    out = torch.zeros((len(model.atoms), 3) + tuple(basis.fft_size), dtype=basis.dtype,
                      device=basis.device)
    Gq_t = basis.tensor(Gq_cart)
    ff_cache = {}
    for s, at in enumerate(model.atoms):
        if not hasattr(at, "local_potential_fourier"):
            continue
        if at not in ff_cache:
            ff_cache[at] = np.asarray(at.local_potential_fourier(Gq_norm))
        phase = np.exp(-2j * math.pi * (Gq_red @ np.asarray(model.positions[s])))
        base = basis.tensor(ff_cache[at] * phase / sqrt_vol, basis.dtype)
        dv = (-1j * Gq_t.T) * base                                      # [3, N]
        out[s] = torch.fft.ifftn(dv.reshape((3,) + tuple(basis.fft_size)),
                                 dim=(-3, -2, -1)) * (N / sqrt_vol)
    return out


def _bare_rhs_q(basis, ctx, qctx: QContext, dvloc_q):
    """rhs[(s, alpha)] [nk, nb, nG] = (dH_q^{(s, alpha)} psi) in the
    wrap(k+q) sector: the local part through `dv_times_psi_q` (the kernels),
    the nonlocal part |dP_{k+q}> D <P_k| + |P_{k+q}> D <dP_k| with
    P_{k+q} = P[perm] (`response/phonon_dfpt.py::_nonlocal_derivative`)."""
    bd = basis.data
    p = qctx.perm_t
    psi = ctx.psi
    nspin = basis.model.n_spin_components
    P, D = ctx.ham.P, ctx.ham.D.to(psi.dtype)
    have_nl = P is not None and P.shape[-1] > 0
    if have_nl:
        atom_col = _atom_of_projector_column(basis)
        Pq, Gpk_q = P[p], bd.Gpk_cart[p]                # k_perm + G, Cartesian
    mask_q = bd.mask[p][:, None, :]

    rhs = []
    for s in range(dvloc_q.shape[0]):
        # No extra q- or sector-phases: with the P convention (structure
        # factor e^{-2 pi i G.x_s}, derivative factor -i(kappa+G)) the
        # cross-sector perturbation carries them implicitly (the reference
        # checked it against a supercell finite difference).
        for alpha in range(3):
            dv = dvloc_q[s, alpha].expand((nspin,) + tuple(basis.fft_size))
            r = dv_times_psi_q(ctx, basis, qctx, dv)
            if have_nl:
                sel = basis.tensor((atom_col == s).astype(float))[None, None, :]
                dPq = (-1j) * Gpk_q[:, :, alpha, None] * Pq * sel
                dPk = (-1j) * bd.Gpk_cart[:, :, alpha, None] * P * sel
                r = r + _nonlocal_derivative(P, dPk, D, psi, P_out=Pq, dP_out=dPq)
            rhs.append(r * mask_q)
    return rhs


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------

def _ewald_hessian(basis):
    """d2 E_Ewald / dr dr' [na, 3, na, 3] (fractional positions) by double
    backward, at the bounds the forces' position energy uses, numpy."""
    model = basis.model
    charges = np.array([at.charge_ionic() for at in model.atoms], dtype=float)
    pos_np = np.stack(model.positions)
    eta = default_eta(model.lattice)
    Gbox, Rbox = ewald_sum_bounds(model.lattice, pos_np, eta)
    positions = torch.as_tensor(pos_np, dtype=torch.float64, device=basis.device)
    with torch.enable_grad():
        H = torch.autograd.functional.hessian(
            lambda pos: energy_ewald(model.lattice, charges, pos, eta=eta, device=basis.device,
                                     Gbox=Gbox, Rbox=Rbox), positions)
    return H.cpu().numpy(), charges, eta, Gbox, Rbox


def dynmat_dfpt_q(scfres, q, tol=1e-7, sternheimer_tol=1e-10, maxiter=40, verbose=False):
    """Cartesian force-constant matrix [3na, 3na] (numpy complex Hermitian,
    the e^{iqR} gauge) at reduced q by DFPT.  q = 0 at T > 0 takes the
    Gamma code (its occupation and Fermi-level terms); psps with an NLCC
    core density raise NotImplementedError, as in the reference."""
    refuse_distributed(scfres.basis, "dynmat_dfpt_q")
    from ..postprocess.unfold import unfold_bz
    from .hessian import gmres
    from .phonon_dfpt import dynmat_dfpt_gamma, refuse_pairwise
    refuse_pairwise(scfres.basis.model, "dynmat_dfpt_q")
    if np.allclose(np.asarray(q, dtype=float), 0) and scfres.basis.model.temperature > 0:
        return dynmat_dfpt_gamma(scfres, tol=tol, sternheimer_tol=sternheimer_tol,
                                 acoustic_sum_rule=False, verbose=verbose).astype(complex)
    refuse_terms(scfres.basis.model, "dynmat_dfpt_q", ["Magnetic", "LocalNonlinearity"],
                 "the JAX package's H at k+q keeps the k-point's k+G in the magnetic "
                 "apply (dftk_tpu/response/phonon_q.py::_perm_ham) and its kernel at q "
                 "has no nonlinearity (::apply_kernel_q)")
    scfres = unfold_bz(scfres)
    basis = scfres.basis
    model = basis.model
    if basis.terms.rho_core_np is not None:
        raise NotImplementedError("q != 0 DFPT with NLCC not implemented (nor in the "
                                  "reference: its bare perturbation has no core term)")
    na = len(model.atoms)
    rho0 = torch.as_tensor(scfres.rho, dtype=basis.rdtype, device=basis.device)
    ctx = make_chi0_context(scfres, basis)
    qctx = QContext(basis, q)

    # ---- clamped-ion part --------------------------------------------------
    # the electronic clamped term is diagonal in atoms and q-independent
    # (E_loc linear, E_nl quadratic in a single atom's structure factor)
    H_full = clamped_ion_hessian(scfres, basis).cpu().numpy()
    H_ew, charges, eta, Gbox, Rbox = _ewald_hessian(basis)
    Linv = np.linalg.inv(model.lattice)
    C_el = np.einsum("aA,satb,bB->sAtB", Linv, H_full - H_ew, Linv)
    C = np.zeros((na, 3, na, 3), dtype=complex)
    for a in range(na):
        C[a, :, a, :] = C_el[a, :, a, :]              # diagonal blocks only
    positions = np.stack(model.positions)
    D_ew = dynmat_ewald_q(model.lattice, charges, positions, q, eta=eta, Gbox=Gbox, Rbox=Rbox)
    # the Ewald part from the smooth to the gauge (e^{iqR}) convention of
    # the electronic response and the IFC route
    ph = np.exp(2j * math.pi * (positions @ np.asarray(q, dtype=float)))
    C += np.einsum("a,aibj,b->aibj", ph, D_ew, ph.conj())

    # ---- response part (gauge convention: u_sR = u_s e^{iqR}) --------------
    rhs_list = _bare_rhs_q(basis, ctx, qctx, _dvloc_q_grids(basis, q))

    def chi0_q(dv):
        dpsi = sternheimer_q(ctx, basis, qctx, dv_times_psi_q(ctx, basis, qctx, dv),
                             tol=sternheimer_tol)
        return drho_q_from_dpsi(ctx, basis, qctx, dpsi)

    def kernel_q(drho):
        return apply_kernel_q(basis, rho0, drho, q)

    def matvec(drho):
        return drho - chi0_q(kernel_q(drho))

    dpsi_all = []
    for j, rhs in enumerate(rhs_list):
        dpsi_b = sternheimer_q(ctx, basis, qctx, rhs, tol=sternheimer_tol)
        drho = gmres(matvec, drho_q_from_dpsi(ctx, basis, qctx, dpsi_b), tol=tol,
                     maxiter=maxiter, verbose=verbose)
        rhs_tot = rhs + dv_times_psi_q(ctx, basis, qctx, kernel_q(drho))
        dpsi_all.append(sternheimer_q(ctx, basis, qctx, rhs_tot, tol=sternheimer_tol))
        if verbose:
            print(f"  q-perturbation {j + 1}/{len(rhs_list)} solved")

    w = (basis.data.kweights[:, None] * ctx.occupation).to(basis.dtype)
    R, dP = torch.stack(rhs_list), torch.stack(dpsi_all)
    C_resp = (torch.einsum("kn,skng,tkng->st", w, R.conj(), dP)
              + torch.einsum("kn,skng,tkng->st", w, dP.conj(), R)).cpu().numpy()
    C = C.reshape(3 * na, 3 * na) + C_resp
    return (C + C.conj().T) / 2


def phonon_modes_dfpt_q(scfres, q, **kwargs):
    """Frequencies (Ha, negatives = imaginary) + eigenvectors at q from the
    DFPT dynmat."""
    from ..postprocess.phonon import AMU_TO_ME, ATOMIC_MASSES_U
    C = dynmat_dfpt_q(scfres, q, **kwargs)
    masses = np.array([ATOMIC_MASSES_U[at.symbol] * AMU_TO_ME
                       for at in scfres.basis.model.atoms])
    msqrt = np.repeat(np.sqrt(masses), 3)
    D = C / np.outer(msqrt, msqrt)
    w2, vecs = np.linalg.eigh((D + D.conj().T) / 2)
    return np.sign(w2) * np.sqrt(np.abs(w2)), vecs
