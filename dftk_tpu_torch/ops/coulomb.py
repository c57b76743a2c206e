"""Coulomb interaction kernels in Fourier space (reference src/coulomb.jl).

Port of `dftk_tpu/ops/coulomb.py`, numpy on the host as there: the kernels
are built once, where the ExactExchange term is instantiated
(`ops/terms.py`), and their cubes move to the basis' device with the other
term tables.  Kernels map |G|^2 -> v(G) (bohr^3 Ha).  Interaction models
(reference src/coulomb.jl:55-288):
  * Coulomb: bare 4 pi/G^2
  * ShortRangeCoulomb / LongRangeCoulomb: erfc/erf range separation (HSE)
  * SphericallyTruncatedCoulomb: 4 pi (1 - cos(|G| Rc))/G^2 (finite at G=0)
  * WignerSeitzTruncatedCoulomb: truncation at the Wigner-Seitz cell
    boundary via erfc/erf splitting + an FFT of the truncated long-range
    part (Sundararaman & Arias, PRB 87, 165122; coulomb.jl:176-288)
Singularity regularisations for the long-range kernels
(coulomb.jl:291-390, ext/DFTKFastGaussQuadratureExt.jl):
  * ProbeCharge: Gygi-Baldereschi / Massidda probe-charge Ewald method
  * ReplaceSingularity: pin the G+q=0 element to a given value
  * VoxelAveraged: average the kernel over the BZ voxel of each grid
    point (surface-reduction integral at the singularity + Gauss-Legendre
    quadrature elsewhere)

Protocol: ``eval_fourier(Gsq)`` is the raw mathematical kernel (singular
at 0 for long-range models); ``fourier_cube(basis)`` evaluates it on the
full FFT cube of a PlaneWaveBasis with the singularity regularised --
this is what the ExactExchange term consumes.  The legacy
``fourier(Gsq, volume)`` form (spherical-cell DC estimate) is kept for
basis-free evaluation.  ``exx_q_kernels`` gives the kernels at G + q for
every k-point difference q of a k-grid.
"""
import dataclasses
import math

import numpy as np
from scipy.special import erf, erfc  # noqa: F401  (erfc used in WS check)


def _safe(Gsq):
    return np.where(Gsq > 0, Gsq, 1.0)


# ---------------------------------------------------------------------------
# Singularity regularisations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProbeCharge:
    """Gygi-Baldereschi probe-charge Ewald regularisation of the G=0 term
    (reference coulomb.jl:291-341; Massidda et al., PRB 48, 5058).

    v(0) = (1/Gamma) int_BZ v(q) e^{-alpha q^2} dq
           - sum_{G != 0, |G|^2 <= 2 Ecut} v(G) e^{-alpha |G|^2}
    with alpha = pi^2/Ecut (VASP default) unless given.
    """
    alpha: float = None

    def dc_value(self, kernel, basis):
        alpha = self.alpha if self.alpha is not None else \
            math.pi ** 2 / basis.Ecut
        omega = basis.model.unit_cell_volume
        gamma = (2 * math.pi) ** 3 / omega          # recip cell volume
        Gsq = np.sum(basis.G_cube_cart ** 2, axis=-1).ravel()
        # the reference sums over the Gamma-point G-sphere (coulomb.jl:332:
        # kernel_fourier[2:end] evaluated on qpt.G_vectors)
        sphere = (Gsq > 0) & (Gsq <= 2 * basis.Ecut)
        Gsq_s = Gsq[sphere]
        probe_sum = float(np.sum(kernel.eval_fourier(Gsq_s)
                                 * np.exp(-alpha * Gsq_s)))
        integral = kernel.probe_charge_integral(alpha) / gamma
        return integral - probe_sum


@dataclasses.dataclass(frozen=True)
class ReplaceSingularity:
    """Pin the G+q=0 element to a fixed value (coulomb.jl:344-366)."""
    value: float = 0.0

    def dc_value(self, kernel, basis):
        return float(self.value)


@dataclasses.dataclass(frozen=True)
class VoxelAveraged:
    """Average the kernel over the BZ voxel of each grid point
    (reference coulomb.jl:369-390 + ext/DFTKFastGaussQuadratureExt.jl;
    J. Chem. Phys. 160, 051101 (2024)).  Good for anisotropic cells.

    The 4 pi/q^2 part of the singular voxel integral is reduced exactly
    to a smooth surface integral over the voxel faces; everything else
    uses an n^3-point Gauss-Legendre product rule.  Voxels = reciprocal
    cell / Monkhorst-Pack grid.
    """
    n_quadrature_points: int = 12

    def average_cube(self, kernel, basis):
        """Full-cube voxel-averaged kernel (handles DC and near-origin
        voxels; far voxels use the midpoint value)."""
        model = basis.model
        kgrid_size = np.array(getattr(basis.kgrid, "kgrid_size", (1, 1, 1)),
                              dtype=float)
        voxel = model.recip_lattice / kgrid_size[None, :]   # columns = edges
        voxel_vol = abs(np.linalg.det(voxel))

        nodes, weights = np.polynomial.legendre.leggauss(
            self.n_quadrature_points)
        nodes, weights = nodes / 2.0, weights / 2.0          # [-1/2, 1/2]

        # 3D product rule offsets inside the voxel
        xx, yy, zz = np.meshgrid(nodes, nodes, nodes, indexing="ij")
        frac = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
        q_loc = frac @ voxel.T                               # [nq, 3]
        wx, wy, wz = np.meshgrid(weights, weights, weights, indexing="ij")
        w_loc = (wx * wy * wz).ravel()

        G_int = basis.G_cube.reshape(-1, 3)
        G_cart = basis.G_cube_cart.reshape(-1, 3)
        Gsq = np.sum(G_cart ** 2, axis=-1)
        out = np.asarray(kernel.eval_fourier(_safe(Gsq)), dtype=float)

        # near-origin voxels: |G_int| <= 10 (hard-coded like the reference)
        near = np.linalg.norm(G_int, axis=-1) <= 10
        sing = Gsq <= 1e-14
        near_ns = near & ~sing
        if np.any(near_ns):
            Gn = G_cart[near_ns]                             # [m, 3]
            Gtot = Gn[:, None, :] + q_loc[None, :, :]
            Gtot_sq = np.sum(Gtot ** 2, axis=-1)
            vals = kernel.eval_fourier(Gtot_sq)
            out[near_ns] = vals @ w_loc

        if np.any(sing):
            # surface reduction of int_voxel 4 pi/q^2 dV: for each pair of
            # faces at +-u_i/2, contribution 2 h A <1/r^2>_face
            integral = 0.0
            for i in range(3):
                u_i = voxel[:, i]
                u_j = voxel[:, (i + 1) % 3]
                u_k = voxel[:, (i + 2) % 3]
                normal = np.cross(u_j, u_k)
                area = np.linalg.norm(normal)
                h = abs(np.dot(u_i, normal)) / (2 * area)
                a = nodes[:, None, None]
                b = nodes[None, :, None]
                r_vec = (0.5 * u_i[None, None, :] + a * u_j[None, None, :]
                         + b * u_k[None, None, :])
                r_sq = np.sum(r_vec ** 2, axis=-1)
                face = np.sum(weights[:, None] * weights[None, :] / r_sq)
                integral += 2 * h * area * face
            dc = 4 * math.pi * integral / voxel_vol
            # + quadrature of the SMOOTH remainder kernel - 4 pi/q^2
            q_sq = np.sum(q_loc ** 2, axis=-1)
            rem = kernel.eval_fourier_minus_coulomb(q_sq)
            dc += float(rem @ w_loc)
            out[sing] = dc
        return out.reshape(basis.fft_size)

    def dc_value(self, kernel, basis):  # pragma: no cover - cube path used
        cube = self.average_cube(kernel, basis)
        return float(cube.reshape(-1)[0])


def _regularized_cube(kernel, reg, basis):
    """Evaluate `kernel` on the FFT cube with regularisation `reg` at G=0."""
    if isinstance(reg, VoxelAveraged):
        return reg.average_cube(kernel, basis)
    Gsq = np.sum(basis.G_cube_cart ** 2, axis=-1)
    out = np.asarray(kernel.eval_fourier(_safe(Gsq)), dtype=float)
    out = np.where(Gsq > 0, out, reg.dc_value(kernel, basis))
    return out


# ---------------------------------------------------------------------------
# Interaction kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Coulomb:
    """Bare 4 pi / G^2 (reference coulomb.jl:55-63).

    `v0` (legacy) overrides the G=0 element, equivalent to
    regularization=ReplaceSingularity(v0).
    """
    v0: float = None
    regularization: object = ProbeCharge()

    def eval_fourier(self, Gsq):
        return 4 * math.pi / Gsq

    def eval_fourier_minus_coulomb(self, Gsq):
        return np.zeros_like(np.asarray(Gsq, dtype=float))

    def probe_charge_integral(self, alpha):
        return 8 * math.pi ** 2 * math.sqrt(math.pi / alpha)

    def fourier_cube(self, basis):
        reg = ReplaceSingularity(self.v0) if self.v0 is not None \
            else self.regularization
        return _regularized_cube(self, reg, basis)

    def fourier(self, Gsq, volume):
        """Basis-free legacy form: spherical-cell estimate 2 pi Rc^2 at DC
        (Rc the radius of the sphere with the cell volume)."""
        out = np.where(Gsq > 0, 4 * math.pi / _safe(Gsq), 0.0)
        if self.v0 is not None:
            return np.where(Gsq > 0, out, self.v0)
        Rc = (3 * volume / (4 * math.pi)) ** (1 / 3)
        return np.where(Gsq > 0, out, 2 * math.pi * Rc ** 2)


@dataclasses.dataclass(frozen=True)
class SphericallyTruncatedCoulomb:
    """Coulomb truncated beyond Rc (Spencer & Alavi, PRB 77, 193110;
    reference coulomb.jl:149-173).  Default Rc: sphere of the cell volume.
    Finite DC limit 2 pi Rc^2."""
    rc: float = None

    def _rc(self, volume):
        return self.rc or (3 * volume / (4 * math.pi)) ** (1 / 3)

    def fourier(self, Gsq, volume):
        rc = self._rc(volume)
        G = np.sqrt(np.maximum(Gsq, 0.0))
        return np.where(
            Gsq > 0,
            4 * math.pi * (1 - np.cos(np.where(Gsq > 0, G, 1.0) * rc))
            / _safe(Gsq),
            2 * math.pi * rc ** 2)

    def fourier_cube(self, basis):
        Gsq = np.sum(basis.G_cube_cart ** 2, axis=-1)
        return self.fourier(Gsq, basis.model.unit_cell_volume)


@dataclasses.dataclass(frozen=True)
class ShortRangeCoulomb:
    """erfc(mu r)/r: v(G) = 4 pi/G^2 (1 - e^{-G^2/(4 mu^2)}) (HSE
    screening; reference coulomb.jl:67-82).  Finite DC limit pi/mu^2."""
    mu: float = 0.11   # HSE06 screening in bohr^-1

    def fourier(self, Gsq, volume):
        safe = _safe(Gsq)
        return np.where(
            Gsq > 0,
            -4 * math.pi / safe * np.expm1(-safe / (4 * self.mu ** 2)),
            math.pi / self.mu ** 2)   # exact G->0 limit

    def fourier_cube(self, basis):
        Gsq = np.sum(basis.G_cube_cart ** 2, axis=-1)
        return self.fourier(Gsq, basis.model.unit_cell_volume)


@dataclasses.dataclass(frozen=True)
class LongRangeCoulomb:
    """erf(mu r)/r: v(G) = 4 pi/G^2 e^{-G^2/(4 mu^2)} (reference
    coulomb.jl:86-103).  Long-range => needs a regularisation; the legacy
    `fourier` keeps the zero-DC convention."""
    mu: float = 0.11
    regularization: object = ProbeCharge()

    def eval_fourier(self, Gsq):
        return 4 * math.pi / Gsq * np.exp(-Gsq / (4 * self.mu ** 2))

    def eval_fourier_minus_coulomb(self, Gsq):
        # 4 pi/G^2 (e^{-x} - 1) = 4 pi expm1(-x)/G^2, smooth at 0
        x = Gsq / (4 * self.mu ** 2)
        small = Gsq <= 1e-14
        out = 4 * math.pi * np.expm1(-x) / _safe(Gsq)
        return np.where(small, -math.pi / self.mu ** 2, out)

    def probe_charge_integral(self, alpha):
        return 8 * math.pi ** 2 * math.sqrt(
            math.pi / (alpha + 1 / (4 * self.mu ** 2)))

    def fourier_cube(self, basis):
        return _regularized_cube(self, self.regularization, basis)

    def fourier(self, Gsq, volume):
        safe = _safe(Gsq)
        return np.where(Gsq > 0,
                        4 * math.pi / safe * np.exp(-safe / (4 * self.mu ** 2)),
                        0.0)


class WignerSeitzTruncatedCoulomb:
    """Coulomb truncated at the Wigner-Seitz cell boundary (Sundararaman &
    Arias, PRB 87, 165122; reference coulomb.jl:176-288).

    1/r = erfc(w r)/r + erf(w r)/r with w chosen from the grid's Nyquist
    frequency so that the short-range part is unaffected by truncation:
    eps = exp(-G_Nyq R_in / 2), w = sqrt(-log eps)/R_in with R_in the
    WS-cell inradius.  The SR part has the analytic transform
    4 pi/G^2 (1 - e^{-G^2/4w^2}); the truncated LR part erf(w r)/r
    (minimum-image, zero outside the WS cell) is transformed by FFT.
    """

    def fourier_cube(self, basis):
        model = basis.model
        lattice = np.asarray(model.lattice, dtype=float)
        volume = model.unit_cell_volume

        # --- WS inradius: min over nonzero integer lattice vectors of |R|/2
        L_min = np.linalg.norm(lattice, axis=0).min()
        inv_t = np.linalg.inv(lattice.T)
        lims = np.linalg.norm(inv_t, axis=0) * L_min
        nx, ny, nz = [max(1, int(math.ceil(x - 1e-8))) for x in lims]
        shifts = np.array([(i, j, k)
                           for i in range(-nx, nx + 1)
                           for j in range(-ny, ny + 1)
                           for k in range(-nz, nz + 1)
                           if (i, j, k) != (0, 0, 0)], dtype=float)
        R_in = 0.5 * np.linalg.norm(shifts @ lattice.T, axis=-1).min()

        # --- range separation from the Nyquist frequency
        recip = np.asarray(model.recip_lattice, dtype=float)
        G_nyq = min(basis.fft_size[d] / 2 * np.linalg.norm(recip[:, d])
                    for d in range(3))
        w = math.sqrt(0.5 * G_nyq * R_in) / R_in   # = sqrt(-log eps)/R_in
        eps_actual = erfc(w * R_in)
        if eps_actual > 1e-8:
            import warnings
            warnings.warn("Coarse FFT grid for Wigner-Seitz truncation; "
                          f"effective error {eps_actual:.2e}")

        # --- LR part on the real grid, minimum-image over neighbour cells
        r_frac = basis.r_cube.reshape(-1, 3)
        r_c = r_frac - np.round(r_frac)
        d_min = np.linalg.norm(r_c @ lattice.T, axis=-1)
        for s in shifts:
            d = np.linalg.norm((r_c - s[None, :]) @ lattice.T, axis=-1)
            d_min = np.minimum(d_min, d)
        with np.errstate(divide="ignore", invalid="ignore"):
            V_lr = np.where(d_min > 1e-8,
                            erf(w * d_min) / np.where(d_min > 0, d_min, 1.0),
                            2 * w / math.sqrt(math.pi))
        V_lr = V_lr.reshape(basis.fft_size)
        N = np.prod(basis.fft_size)
        # physical Fourier integral over the cell: (Omega/N) sum e^{-iGr}
        k_lr = np.real(np.fft.fftn(V_lr)) * (volume / N)

        # --- analytic SR + FFT'd LR
        Gsq = np.sum(basis.G_cube_cart ** 2, axis=-1)
        sr = np.where(Gsq > 0,
                      -4 * math.pi / _safe(Gsq)
                      * np.expm1(-_safe(Gsq) / (4 * w ** 2)),
                      math.pi / w ** 2)
        return sr + k_lr


def kernel_fourier_cube(kernel, basis):
    """Kernel on the full FFT cube (the ExactExchange term's input):
    dispatch to fourier_cube when available, legacy fourier otherwise."""
    if hasattr(kernel, "fourier_cube"):
        return kernel.fourier_cube(basis)
    Gsq = np.sum(basis.G_cube_cart ** 2, axis=-1)
    return kernel.fourier(Gsq, basis.model.unit_cell_volume)


# ---------------------------------------------------------------------------
# k-grid exact exchange: kernels on the shifted grids G + q
# ---------------------------------------------------------------------------

class _BvkShim:
    """Duck-typed stand-in for ``fourier_cube`` evaluation on the
    Born-von-Karman supercell (lattice columns scaled by the k-grid dims,
    FFT grid scaled likewise).  Provides exactly the attributes the kernel
    classes read (model.lattice/recip_lattice/unit_cell_volume, fft_size,
    r_cube, G_cube_cart)."""

    class _M:
        pass

    def __init__(self, lattice, fft_size):
        from . import fft as fftops
        lattice = np.asarray(lattice, dtype=float)
        m = self._M()
        m.lattice = lattice
        m.recip_lattice = 2 * math.pi * np.linalg.inv(lattice).T
        m.unit_cell_volume = abs(np.linalg.det(lattice))
        self.model = m
        self.fft_size = tuple(int(n) for n in fft_size)
        self.r_cube = fftops.r_vectors(self.fft_size)
        G = fftops.G_vectors_cube(self.fft_size).astype(float)
        self.G_cube_cart = np.einsum("ab,xyzb->xyza", m.recip_lattice, G)


def _wrap_frac(x):
    """Fractional coordinates wrapped to [0, 1) rounded to 8 digits, with
    values straddling the 0/1 seam (>= 1 - 1e-8) folded back to 0 so that
    -1e-9 and +1e-9 dedup to the same point."""
    w = np.round(np.mod(np.asarray(x, dtype=float), 1.0), 8)
    return np.where(w >= 1.0 - 1e-8, 0.0, w)


def _infer_kgrid_dims(kc_spatial):
    """Diagonal Monkhorst-Pack dims (n1, n2, n3) from the spatial k-point
    fractional coordinates; None if the set is not a full diagonal grid."""
    nk = len(kc_spatial)
    dims = []
    for d in range(3):
        vals = np.unique(_wrap_frac(kc_spatial[:, d]))
        dims.append(len(vals))
        # the axis values must be an equispaced 1/n_d grid (possibly shifted)
        if len(vals) > 1:
            step = np.diff(vals)
            if not np.allclose(step, 1.0 / len(vals), atol=1e-8):
                return None
    if int(np.prod(dims)) != nk:
        return None
    return tuple(dims)


def exx_q_kernels(kernel, basis):
    """Exchange kernels for a k-point grid: (vq, iq) with
    ``vq[iq[ik, jk]]`` the kernel cube evaluated at ``|G + k_ik - k_jk|^2``.

    Born-von-Karman conventions (the standard route to k-converged hybrid
    energies, Spencer & Alavi PRB 77, 193110): truncated kernels take their
    truncation radius / truncation cell from the BvK supercell
    (``nk_spatial`` unit cells), and the only singular element -- G+q = 0,
    which occurs for q = 0 only -- carries the kernel's own finite DC
    convention at the BvK volume.  At nk_spatial == 1 this reduces exactly
    to ``kernel_fourier_cube`` (the Gamma-only path, byte-identical).

    WignerSeitzTruncatedCoulomb is handled by building the Sundararaman-
    Arias kernel once on the BvK supercell grid and SLICING the shifted
    sub-grids out: the BvK reciprocal lattice points are exactly the
    {G + q} set.  Requires a full diagonal Monkhorst-Pack q-difference set.

    Returns (vq [nq, n1, n2, n3] float64, iq [nk, nk] int32) with nk the
    spin-duplicated k-point count (q depends on the spatial part only).

    Reference context: DFTK restricts exact exchange to Gamma
    (src/terms/exact_exchange.jl:52) and names the k-point generalisation
    a TODO (src/terms/exact_exchange.jl:31); this implements it.
    """
    kc = np.asarray(basis.kcoords_spin, dtype=float)         # [nk, 3] frac
    nk = len(kc)
    # unique spatial k-points (collinear spin duplicates the list)
    kc_sp = np.unique(_wrap_frac(kc), axis=0)
    nk_spatial = len(kc_sp)

    # the generator sum over k' is only complete on the FULL (unreduced)
    # uniform grid: a symmetry-reduced set -- even one with equal weights,
    # e.g. time-reversal-only reduction -- silently misses folded-out k'
    # points.  Require a complete diagonal Monkhorst-Pack set (possibly
    # shifted); this also guarantees the BvK volume below is right.
    dims = _infer_kgrid_dims(kc_sp) if nk_spatial > 1 else (1, 1, 1)
    if dims is None:
        raise ValueError(
            "k-grid ExactExchange needs the full (unreduced) diagonal "
            f"Monkhorst-Pack k-point set; the {nk_spatial} spatial k-points "
            "stored in the basis do not form a complete grid (build the "
            "basis with symmetries=False)")

    # ---- unique difference set q = k - k' ---------------------------------
    # UNWRAPPED differences of the stored representatives: the periodic
    # parts' Fourier labels are relative to those representatives, so the
    # kernel must be evaluated at the literal G + (k - k') (wrapping q by a
    # reciprocal vector would shift the cube and change the aliasing at the
    # cube boundary).
    dq = kc[:, None, :] - kc[None, :, :]
    keys = np.round(dq, 8).reshape(nk * nk, 3)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    iq = inv.reshape(nk, nk).astype(np.int32)
    nq = len(uniq)

    B = np.asarray(basis.model.recip_lattice, dtype=float)
    vol_bvk = basis.model.unit_cell_volume * nk_spatial
    Gf = np.asarray(basis.G_cube, dtype=float)                # integer freqs

    if isinstance(kernel, WignerSeitzTruncatedCoulomb):
        if dims == (1, 1, 1):
            return (kernel.fourier_cube(basis)[None], iq)
        lat_bvk = np.asarray(basis.model.lattice, float) * np.array(dims)
        grid_bvk = tuple(n * d for n, d in zip(basis.fft_size, dims))
        K = kernel.fourier_cube(_BvkShim(lat_bvk, grid_bvk))
        vq = np.empty((nq,) + tuple(basis.fft_size))
        for a, q in enumerate(uniq):
            m = np.round(Gf * np.array(dims) + q * np.array(dims))
            m = m.astype(int) % np.array(grid_bvk)
            vq[a] = K[m[..., 0], m[..., 1], m[..., 2]]
        return vq, iq

    if nk_spatial == 1:
        # exact Gamma-only parity: same cube, same regularisation
        return np.asarray(kernel_fourier_cube(kernel, basis))[None], iq

    # the kernel's configured singularity regularisation, if any (long-range
    # kernels: Coulomb, LongRangeCoulomb); the legacy v0 override wins
    reg = getattr(kernel, "regularization", None)
    if getattr(kernel, "v0", None) is not None:
        reg = ReplaceSingularity(kernel.v0)
    dc = _bvk_dc_value(kernel, reg, basis, dims) if reg is not None else None

    vq = np.empty((nq,) + tuple(basis.fft_size))
    for a, q in enumerate(uniq):
        Gpq = np.einsum("ab,xyzb->xyza", B, Gf + q)
        Gsq = np.sum(Gpq * Gpq, axis=-1)
        if dc is not None and np.all(np.abs(q) < 1e-9):
            # the only singular element across all cubes is G+q = 0 in the
            # q = 0 cube; it carries the kernel's CONFIGURED regularisation
            # evaluated at the BvK cell (not the legacy spherical-cell
            # estimate), so the DC convention is continuous between
            # kgrid=(1,1,1) and larger grids
            out = np.asarray(kernel.eval_fourier(_safe(Gsq)), dtype=float)
            vq[a] = np.where(Gsq > 1e-14, out, dc)
        else:
            vq[a] = kernel.fourier(Gsq, vol_bvk)
    return vq, iq


def _bvk_dc_value(kernel, reg, basis, dims):
    """Regularised G+q = 0 element for k-grid exact exchange.

    ProbeCharge (Gygi-Baldereschi / Massidda) at the Born-von-Karman level:
    the probe sum runs over ALL shifted grids {G + q} for q in the wrapped
    q-difference grid -- together these are exactly the BvK reciprocal
    lattice -- and the integral is normalised by the BvK reciprocal-cell
    volume.  At dims == (1,1,1) this reduces to ProbeCharge.dc_value.
    """
    if isinstance(reg, ReplaceSingularity):
        return float(reg.value)
    if not isinstance(reg, ProbeCharge):
        raise NotImplementedError(
            f"{type(reg).__name__} regularization is not supported for "
            "k-grid exact exchange; use ProbeCharge, ReplaceSingularity, "
            "or a truncated kernel (WignerSeitz/SphericallyTruncated)")
    alpha = reg.alpha if reg.alpha is not None else math.pi ** 2 / basis.Ecut
    nq_grid = int(np.prod(dims))
    vol_bvk = basis.model.unit_cell_volume * nq_grid
    gamma_bvk = (2 * math.pi) ** 3 / vol_bvk
    B = np.asarray(basis.model.recip_lattice, dtype=float)
    Gf = np.asarray(basis.G_cube, dtype=float).reshape(-1, 3)
    acc = 0.0
    for i in range(dims[0]):
        for j in range(dims[1]):
            for k in range(dims[2]):
                q = np.array([i / dims[0], j / dims[1], k / dims[2]])
                Gsq = np.sum(((Gf + q) @ B.T) ** 2, axis=-1)
                m = (Gsq > 1e-14) & (Gsq <= 2 * basis.Ecut)
                acc += float(np.sum(kernel.eval_fourier(Gsq[m])
                                    * np.exp(-alpha * Gsq[m])))
    return kernel.probe_charge_integral(alpha) / gamma_bvk - acc
