"""The JAX package's CPU float64 values that tests/data/torch_port_terms.json
records for the port's model-Hamiltonian terms: the kinetic blow-ups, the
External* potentials, LocalNonlinearity, Magnetic with the current, the
Anyonic term and pairwise potentials.

    DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python tests/data/make_torch_port_terms.py ENTRY

prints one JSON line: the entry's values, its `command` and its CPU
seconds (wall seconds of the run on the host).  Run from the repository
root.  The cells' constructors take the package as `dftk` (`dftk_tpu`
here; the port in tests/test_torch_terms*.py, which pass device="cpu",
and in chip_smoke.py phase q, which loads this file), and every start is
numpy: `seeded_orbitals` of make_torch_port_exx.py, the winding start of
examples/anyons.py (`winding_start`).  The users' callables are written so
that they take numpy (External*, Magnetic) or either package's arrays
(LocalNonlinearity, PairwisePotential: `**` and arithmetic only).  This
script imports the JAX package, so it lives outside both packages.
"""
import json
import pathlib
import sys
import time

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
sys.path[:0] = [str(_HERE), str(_HERE.parents[1])]      # tests/data, the repository root
from make_torch_port_exx import (SI_LATTICE, _c, seeded_orbitals,  # noqa: E402
                                 table_summary)

FD_CELL, FD_W0, FD_B = 14.0, 1.0, 0.4            # tests/test_magnetic.py
ANYON_CELL, ANYON_BETA = 14.0, 5.0               # tests/test_anyonic.py
GP2D_CELL, GP2D_OMEGA, GP2D_C = 15.0, 0.6, 250.0  # examples/gross_pitaevskii_2D.py
LJ_PARAMS = {("Si", "Si"): (1e-3, 4.0)}          # Lennard-Jones (eps, sigma) between Si
LJ_RADIUS = 20.0
SI2_DISPLACED = [np.array([0.13, 0.12, 0.125]), -np.ones(3) / 8]


# ---------------------------------------------------------------------------
# the cells (any package)
# ---------------------------------------------------------------------------

def fock_darwin_basis(dftk, Ecut=24.0, **kw):
    """tests/test_magnetic.py: two spinless electrons in a 2D trap of
    frequency 1 under a field B = 0.4 (symmetric gauge), |A|^2 / 2 in the
    external potential."""
    c = FD_CELL / 2

    def pot(r):
        x, y = r[..., 0] - c, r[..., 1] - c
        return (FD_W0 ** 2 / 2 + FD_B ** 2 / 8) * (x ** 2 + y ** 2)

    def Apot(r):
        x, y = r[..., 0] - c, r[..., 1] - c
        return np.stack([-FD_B / 2 * y, FD_B / 2 * x, np.zeros_like(x)], axis=-1)

    m = dftk.Model(np.diag([FD_CELL, FD_CELL, 0.0]), [], [], n_electrons=2,
                   spin_polarization="spinless", symmetries=False,
                   term_types=[dftk.Kinetic(), dftk.ExternalFromReal(pot),
                               dftk.Magnetic(Apot=Apot)])
    return dftk.PlaneWaveBasis(m, Ecut=Ecut, kgrid=(1, 1, 1), **kw)


def gp2d_basis(dftk, Ecut=20.0, **kw):
    """examples/gross_pitaevskii_2D.py: the rotating 2D Gross-Pitaevskii
    condensate (trap, C rho^2 with C = 250, A = 0.6 (y, -x, 0))."""
    c = GP2D_CELL / 2

    def pot(r):
        x, y = r[..., 0] - c, r[..., 1] - c
        return (x ** 2 + y ** 2) / 2

    def Apot(r):
        x, y = r[..., 0] - c, r[..., 1] - c
        return GP2D_OMEGA * np.stack([y, -x, np.zeros_like(x)], axis=-1)

    m = dftk.Model(np.diag([GP2D_CELL, GP2D_CELL, 0.0]), [], [], n_electrons=1,
                   spin_polarization="spinless", symmetries=False,
                   term_types=[dftk.Kinetic(), dftk.ExternalFromReal(pot),
                               dftk.LocalNonlinearity(lambda rho: GP2D_C * rho ** 2),
                               dftk.Magnetic(Apot=Apot)])
    return dftk.PlaneWaveBasis(m, Ecut=Ecut, kgrid=(1, 1, 1), **kw)


def gp3d_basis(dftk, Ecut=30.0, **kw):
    """examples/gross_pitaevskii.py: one particle in a 3D harmonic trap with
    5 rho^2."""
    def pot(r):
        return ((r[..., 0] - 5.0) ** 2 + (r[..., 1] - 5.0) ** 2 + (r[..., 2] - 5.0) ** 2) / 2

    m = dftk.Model(np.eye(3) * 10.0, [], [], n_electrons=1, spin_polarization="spinless",
                   symmetries=False,
                   term_types=[dftk.Kinetic(), dftk.ExternalFromReal(pot),
                               dftk.LocalNonlinearity(lambda rho: 5.0 * rho ** 2)])
    return dftk.PlaneWaveBasis(m, Ecut=Ecut, kgrid=(1, 1, 1), **kw)


class GaussianNucleus:
    """examples/custom_potential.py's element: V(r) = -alpha / (sqrt(2 pi) L)
    exp(-(r / L)^2 / 2), no charges."""
    symbol = "X"

    def __init__(self, alpha=1.0, L=0.5):
        self.alpha, self.L = alpha, L

    def local_potential_fourier(self, p):
        return -self.alpha * np.exp(-(np.asarray(p) * self.L) ** 2 / 2)

    def charge_ionic(self):
        return 0

    def charge_nuclear(self):
        return 0


def gp1d_basis(dftk, Ecut=500.0, **kw):
    """examples/custom_potential.py: the 1D Gross-Pitaevskii equation (rho^2)
    with two Gaussian nuclei at x = 0.2 and 0.8 of a 10-bohr line."""
    g = GaussianNucleus()
    m = dftk.Model(np.diag([10.0, 0.0, 0.0]), [g, g],
                   [np.array([0.2, 0.0, 0.0]), np.array([0.8, 0.0, 0.0])], n_electrons=1,
                   spin_polarization="spinless", symmetries=False,
                   term_types=[dftk.Kinetic(), dftk.AtomicLocal(),
                               dftk.LocalNonlinearity(lambda rho: 1.0 * rho ** 2.0)])
    return dftk.PlaneWaveBasis(m, Ecut=Ecut, kgrid=(1, 1, 1), **kw)


def anyon_basis(dftk, Ecut=8.0, **kw):
    """tests/test_anyonic.py: one particle in a 2D trap with the anyonic
    gauge field (beta 5) and Kinetic(scaling_factor=2)."""
    c = ANYON_CELL / 2
    pot = lambda r: (r[..., 0] - c) ** 2 + (r[..., 1] - c) ** 2
    m = dftk.Model(np.diag([ANYON_CELL, ANYON_CELL, 0.0]), [], [], n_electrons=1,
                   spin_polarization="spinless", symmetries=False,
                   term_types=[dftk.Kinetic(scaling_factor=2.0), dftk.ExternalFromReal(pot),
                               dftk.Anyonic(hbar=1.0, beta=ANYON_BETA)])
    return dftk.PlaneWaveBasis(m, Ecut=Ecut, kgrid=(1, 1, 1), **kw)


def winding_start(basis, m=-1):
    """examples/anyons.py's start (numpy [1, 1, nG]): the winding-m Gaussian
    vortex (x + i sgn(m) y)^|m| exp(-r^2 / 2) about the cell centre,
    normalised."""
    n1, n2, n3 = basis.fft_size
    xs = (np.arange(n1) / n1 - 0.5) * ANYON_CELL
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    psi_r = (((X + 1j * np.sign(m) * Y) ** abs(m)) * np.exp(-(X ** 2 + Y ** 2) / 2))[:, :, None]
    cube = np.fft.fftn(psi_r).ravel()
    psi = cube[np.asarray(basis.Gidx_np)[0]] * np.asarray(basis.mask_np)[0]
    return (psi / np.linalg.norm(psi))[None, None, :]


def smooth_external(lattice):
    """A smooth periodic external potential on a crystal cell:
    0.05 sum_a cos(2 pi x_a) of the reduced coordinates x = L^-1 r."""
    Linv = np.linalg.inv(np.asarray(lattice, dtype=float))

    def pot(r):
        x = np.einsum("ab,...b->...a", Linv, r)
        return 0.05 * np.sum(np.cos(2 * np.pi * x), axis=-1)
    return pot


def si_terms(dftk, lattice, external=False, pairwise=False):
    """The extra terms of the silicon cells: a smooth external potential and
    the Lennard-Jones pairwise term between the Si atoms."""
    from importlib import import_module
    lj = import_module(dftk.__name__ + ".ops.pairwise").lennard_jones
    terms = []
    if external:
        terms.append(dftk.ExternalFromReal(smooth_external(lattice)))
    if pairwise:
        terms.append(dftk.PairwisePotential(V=lj, params=LJ_PARAMS, max_radius=LJ_RADIUS))
    return terms


def si2_basis(dftk, blowup=None, external=False, pairwise=False, positions=SI2_DISPLACED,
              **kw):
    """LDA Si2 (HGH lda/si-q4) at Ecut 7, Gamma, no symmetry, atom 0 moved
    off its site, with a kinetic blow-up and the extra terms."""
    Si = dftk.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dftk.model_DFT(SI_LATTICE, [Si, Si], list(positions),
                           functionals=["lda_x", "lda_c_vwn"], symmetries=False,
                           kinetic_blowup=blowup,
                           extra_terms=si_terms(dftk, SI_LATTICE, external, pairwise))
    return dftk.PlaneWaveBasis(model, Ecut=7.0, kgrid=(1, 1, 1), **kw)


def si54_q1_basis(dftk, shift=0.0, **kw):
    """chip_smoke.py phase q1: bench.py's Si54 (LDA, HGH lda/si-q4, Ecut 10,
    Gamma, no symmetry) with BlowupCHV, the smooth external potential and
    the Lennard-Jones term; atom 0 moved by `shift` bohr along x."""
    a = 5.131570667152971
    lattice = np.array([[0.0, a, a], [a, 0.0, a], [a, a, 0.0]]) * 3
    Si = dftk.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    positions = [(b + np.array([i, j, k])) / 3 for i in range(3) for j in range(3)
                 for k in range(3) for b in (np.ones(3) / 8, -np.ones(3) / 8)]
    positions[0] = positions[0] + np.linalg.inv(lattice) @ np.array([shift, 0.0, 0.0])
    model = dftk.model_DFT(lattice, [Si] * len(positions), positions,
                           functionals=["lda_x", "lda_c_vwn"], symmetries=False,
                           kinetic_blowup=dftk.BlowupCHV(),
                           extra_terms=si_terms(dftk, lattice, True, True))
    return dftk.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1), **kw)


def external_bases(dftk, **kw):
    """One small cubic cell (L = 6, Ecut 5, no atoms) per External* form."""
    L = 6.0
    values = np.random.default_rng(11).normal(size=(15, 15, 15)) * 0.1
    forms = {"real": dftk.ExternalFromReal(lambda r: np.sin(r[..., 0]) * np.cos(2 * r[..., 1])
                                           + 0.1 * r[..., 2]),
             "fourier": dftk.ExternalFromFourier(
                 lambda G: np.exp(-np.sum(G * G, axis=-1) / 4) * (1 + 0.5j * G[..., 0])),
             "values": dftk.ExternalFromValues(values)}
    out = {}
    for name, term in forms.items():
        m = dftk.Model(np.eye(3) * L, [], [], n_electrons=2, symmetries=False,
                       term_types=[dftk.Kinetic(), term])
        out[name] = dftk.PlaneWaveBasis(m, Ecut=5.0, kgrid=(1, 1, 1), fft_size=(15, 15, 15),
                                        **kw)
    return out


def dv_psi(basis, psi, dV):
    """dV psi on the spheres (numpy) for orbitals psi [nk, nb, nG] and a
    local potential dV [n1, n2, n3], by numpy FFTs (both packages' psi)."""
    psi = np.asarray(psi)
    idx, mask, shape = np.asarray(basis.Gidx_np), np.asarray(basis.mask_np), basis.fft_size
    out = np.zeros_like(psi)
    for k in range(psi.shape[0]):
        cube = np.zeros((psi.shape[1], int(np.prod(shape))), dtype=complex)
        cube[:, idx[k]] = psi[k] * mask[k]
        r = np.fft.ifftn(cube.reshape((-1,) + tuple(shape)), axes=(1, 2, 3)) * dV
        out[k] = np.fft.fftn(r, axes=(1, 2, 3)).reshape(psi.shape[1], -1)[:, idx[k]] * mask[k]
    return out


def hessian_quadratic_form(OmegaK, Pc, basis, psi, dV):
    """sum_n Re <d_n|(Omega + K) d_n> with d = P_c dV psi: invariant under
    the phases and the rotations within degenerate levels of psi."""
    d = Pc(dv_psi(basis, psi, dV))          # Pc takes numpy, returns its package's array
    return float(np.real(np.vdot(np.asarray(d), np.asarray(OmegaK(d)))))


# ---------------------------------------------------------------------------
# JAX helpers
# ---------------------------------------------------------------------------

def _jnp(a):
    import jax.numpy as jnp
    return jnp.asarray(a)


def _energies(res):
    return {k: float(v) for k, v in res.energies.items()}


def _forces(res):
    from dftk_tpu.postprocess.forces import compute_forces
    return np.asarray(compute_forces(res)).tolist()


def seeded_density(basis, psi, occ):
    import jax.numpy as jnp
    from dftk_tpu.ops.density import compute_density
    return np.asarray(compute_density(basis.data, jnp.asarray(psi), jnp.asarray(occ),
                                      basis.fft_size, basis.model.unit_cell_volume,
                                      basis.model.n_spin_components))


def jax_split(basis, n_bands, psi0, tol=1e-10):
    """The JAX split SCF in float64 with LOBPCG from the complex start psi0."""
    import jax.numpy as jnp
    from dftk_tpu.ops.engine_split import self_consistent_field_split
    U0 = np.concatenate([psi0.real, psi0.imag], axis=-1)
    res = self_consistent_field_split(
        basis, tol=tol, maxiter=60, n_bands=n_bands, n_extra_bands=psi0.shape[1] - n_bands,
        dtype=jnp.float64, eigensolver="lobpcg", is_converged="density",
        U0=jnp.asarray(U0), diagtol_min=1e-12)
    return dict(energies={k: float(v) for k, v in res["energies"].items()},
                n_iter=int(res["n_iter"]), converged=bool(res["converged"]))


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------

def entry_setup():
    """The terms' instantiation: vloc of external_bases' three forms; the
    explicit kinetic of si2_basis with BlowupCHV, BlowupAbinit and of
    anyon_basis (Kinetic(scaling_factor=2)); Apot of fock_darwin_basis at
    Ecut 10; the anyonic rho_ref and Aref of anyon_basis; E and F of the
    pairwise term of si2_basis(pairwise=True)."""
    import dftk_tpu as dftk
    out = {"vloc": {k: np.asarray(b.terms.vloc_np).tolist()
                    for k, b in external_bases(dftk).items()}}
    kin = {}
    for name, bl in (("chv", dftk.BlowupCHV()), ("abinit", dftk.BlowupAbinit())):
        kin[name] = np.asarray(si2_basis(dftk, blowup=bl).terms.kin_np).tolist()
    ab = anyon_basis(dftk)
    kin["scaled"] = np.asarray(ab.terms.kin_np).tolist()
    out["kin"] = kin
    out["Apot"] = table_summary(fock_darwin_basis(dftk, Ecut=10.0).terms.Apot_np)
    _, _, rho_ref, Aref = ab.terms.anyonic
    out["anyonic"] = dict(fft_size=list(ab.fft_size), rho_ref=table_summary(rho_ref),
                          Aref=table_summary(Aref))
    bp = si2_basis(dftk, pairwise=True)
    out["pairwise"] = dict(E=float(bp.terms.E_pairwise),
                           F=np.asarray(bp.terms.pairwise_forces).tolist())
    return out


def entry_applies():
    """On seeded orbitals: apply_H of fock_darwin_basis (Ecut 10) at its
    static potential to seeded_orbitals(mask, 4, 21) and the Kinetic and
    Magnetic energies and the current of occupations (1, 1, 0.5, 0); of
    gp2d_basis (Ecut 8) at the density of seeded_orbitals(mask, 2, 22)
    with occupations (0.7, 0.3): the LocalNonlinearity energy and V, H psi
    and the response kernel along a seeded drho; of anyon_basis (Ecut 8)
    on seeded_orbitals(mask, 1, 23): the anyonic energy and the hand
    operator apply_anyonic."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops import hamiltonian as H
    from dftk_tpu.ops.anyonic import anyonic_energy, apply_anyonic
    from dftk_tpu.postprocess.current import compute_current
    from dftk_tpu.response.hessian import apply_kernel
    out = {}
    b = fock_darwin_basis(dftk, Ecut=10.0)
    psi = seeded_orbitals(b.mask_np, 4, 21)
    occ = np.array([[1.0, 1.0, 0.5, 0.0]])
    V = jnp.asarray(b.terms.vloc_np)[None]
    ham = H.build_ham(b.data, b.terms.data, V)
    Hpsi = H.apply_H(ham, _jnp(psi), b.fft_size, b.model.unit_cell_volume)
    en = H.psi_energies(ham, b.terms, _jnp(psi), _jnp(occ), b.data.kweights, b.fft_size)
    J = compute_current(type("S", (), dict(psi=psi, occupation=occ, basis=b))())
    out["fock_darwin"] = dict(Hpsi=_c(Hpsi), energies={k: float(v) for k, v in en.items()},
                              J=table_summary(J))
    b = gp2d_basis(dftk, Ecut=8.0)
    psi = seeded_orbitals(b.mask_np, 2, 22)
    occ = np.array([[0.7, 0.3]])
    rho = seeded_density(b, psi, occ)
    Gcart = jnp.asarray(b.G_cube_cart)
    V, energies = H.total_potential(b.terms, jnp.asarray(rho), Gcart, b.model.unit_cell_volume)
    ham = H.build_ham(b.data, b.terms.data, V)
    Hpsi = H.apply_H(ham, _jnp(psi), b.fft_size, b.model.unit_cell_volume)
    en = H.psi_energies(ham, b.terms, _jnp(psi), _jnp(occ), b.data.kweights, b.fft_size)
    drho = np.random.default_rng(24).normal(size=rho.shape) * 1e-3
    K = apply_kernel(b, jnp.asarray(rho), jnp.asarray(drho))
    out["gp2d"] = dict(fft_size=list(b.fft_size), rho=table_summary(rho),
                       energies={k: float(v) for k, v in {**energies, **en}.items()},
                       V=table_summary(V), Hpsi=_c(Hpsi), K=table_summary(K))
    b = anyon_basis(dftk)
    psi = seeded_orbitals(b.mask_np, 1, 23)
    occ = np.ones((1, 1))
    rho = seeded_density(b, psi, occ)
    hbar, beta, rho_ref, Aref = b.terms.anyonic
    args = (_jnp(occ), jnp.asarray(rho).sum(0), _jnp(rho_ref), _jnp(Aref),
            jnp.asarray(b.G_cube_cart), hbar, beta, b.fft_size, b.model.unit_cell_volume)
    out["anyonic"] = dict(E=float(anyonic_energy(b.data, _jnp(psi), *args)),
                          Hpsi=_c(apply_anyonic(b.data, _jnp(psi), *args)))
    return out


def entry_fock_darwin():
    """fock_darwin_basis at Ecut 10: the LOBPCG SCF (n_bands 6, density tol
    1e-10, maxiter 30) from seeded_orbitals(mask, 9, 25), its eigenvalues,
    energies and the L_z of its current (tests/test_magnetic.py's
    integral); then direct minimization (tol 1e-10, maxiter 400) from the
    first two of those orbitals."""
    import dftk_tpu as dftk
    from dftk_tpu.postprocess.current import compute_current
    b = fock_darwin_basis(dftk, Ecut=10.0)
    psi0 = seeded_orbitals(b.mask_np, 9, 25)
    res = dftk.self_consistent_field(b, tol=1e-10, n_bands=6, maxiter=30, psi=_jnp(psi0))
    J = compute_current(res)
    out = dict(fft_size=list(b.fft_size), eigenvalues=np.asarray(res.eigenvalues)[0].tolist(),
               energies=_energies(res), n_iter=res.n_iter, converged=bool(res.converged),
               Lz=lz(b, J))
    d = dftk.direct_minimization(b, tol=1e-10, maxiter=400, psi=_jnp(psi0[:, :2]))
    out["direct"] = dict(energies=_energies(d), n_iter=d.n_iter, converged=bool(d.converged))
    return out


def lz(basis, J):
    """L_z = int (x J_y - y J_x) about the cell centre (tests/test_magnetic.py)."""
    n1, n2, _ = basis.fft_size
    xs = (np.arange(n1) / n1) * FD_CELL - FD_CELL / 2
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    J = np.asarray(J)
    return float(np.sum(X[:, :, None] * J[1] - Y[:, :, None] * J[0]) * basis.dvol)


def entry_gp1d():
    """gp1d_basis (examples/custom_potential.py, Ecut 500): the LOBPCG SCF
    from rho = 0 and seeded_orbitals(mask, 4, 26) (density tol 1e-10,
    maxiter 60), its energies and forces."""
    import dftk_tpu as dftk
    b = gp1d_basis(dftk)
    psi0 = seeded_orbitals(b.mask_np, 4, 26)
    res = dftk.self_consistent_field(b, tol=1e-10, maxiter=60, psi=_jnp(psi0),
                                     rho=_jnp(np.zeros((1,) + b.fft_size)))
    return dict(fft_size=list(b.fft_size), energies=_energies(res), n_iter=res.n_iter,
                converged=bool(res.converged), forces=_forces(res))


def entry_si2():
    """si2_basis with BlowupCHV, with BlowupAbinit, and with the external
    and pairwise terms: the LOBPCG SCF (density tol 1e-10, maxiter 40) from
    seeded_orbitals(mask, 7, 27), its energies (and forces for the last),
    and the float64 split SCF (LOBPCG, density tol 1e-10) from the same
    orbitals."""
    import dftk_tpu as dftk
    out = {}
    for name, kw in (("chv", dict(blowup=dftk.BlowupCHV())),
                     ("abinit", dict(blowup=dftk.BlowupAbinit())),
                     ("ext_pair", dict(external=True, pairwise=True))):
        b = si2_basis(dftk, **kw)
        psi0 = seeded_orbitals(b.mask_np, 7, 27)
        res = dftk.self_consistent_field(b, tol=1e-10, maxiter=40, n_bands=4,
                                         psi=_jnp(psi0))
        out[name] = dict(energies=_energies(res), n_iter=res.n_iter,
                         converged=bool(res.converged), split=jax_split(b, 4, psi0))
        if name == "ext_pair":
            out[name]["forces"] = _forces(res)
    return out


def entry_anyons():
    """anyon_basis at Ecut 8: direct minimization (tol 1e-10, maxiter 3000)
    from winding_start(basis, -1): its energies and iterations."""
    import dftk_tpu as dftk
    b = anyon_basis(dftk)
    res = dftk.direct_minimization(b, tol=1e-10, maxiter=3000, psi=_jnp(winding_start(b)))
    return dict(fft_size=list(b.fft_size), energies=_energies(res), n_iter=res.n_iter,
                converged=bool(res.converged))


def entry_gp_direct():
    """chip_smoke.py phase q2 and q4's direct minimizations: gp2d_basis
    (Ecut 20, tol 1e-6, maxiter 600) from seeded_orbitals(mask, 1, 1), and
    gp3d_basis (Ecut 30, tol 1e-9, maxiter 300) from
    seeded_orbitals(mask, 1, 2): energies, iterations."""
    import dftk_tpu as dftk
    out = {}
    for name, b, tol, maxiter, seed in (("gp2d", gp2d_basis(dftk), 1e-6, 600, 1),
                                        ("gp3d", gp3d_basis(dftk), 1e-9, 300, 2)):
        t0 = time.time()
        res = dftk.direct_minimization(b, tol=tol, maxiter=maxiter,
                                       psi=_jnp(seeded_orbitals(b.mask_np, 1, seed)))
        out[name] = dict(fft_size=list(b.fft_size), energies=_energies(res),
                         n_iter=res.n_iter, converged=bool(res.converged),
                         seconds=time.time() - t0)
        print(f"{name}: {res.total_energy!r}, {res.n_iter} iterations, "
              f"{time.time() - t0:.1f} s", file=sys.stderr, flush=True)
    return out


DV_SEED = 3


def seeded_potential(basis, seed=DV_SEED, scale=0.01):
    return np.random.default_rng(seed).normal(size=basis.fft_size) * scale


def entry_consumers():
    """The consumers of Ham and Terms with the new terms: the energy
    evaluation of gp2d_basis (Ecut 8: Magnetic, LocalNonlinearity) at
    seeded_orbitals(mask, 1, 22); potential mixing (tol 1e-10, maxiter 40)
    and Newton (tol 1e-10) of gp3d_basis at Ecut 10 (External*,
    LocalNonlinearity: K carries its second derivative); chi0 of
    seeded_potential on fock_darwin_basis at Ecut 10 (Magnetic; the SCF of
    2 bands to 1e-12 from seeded_orbitals(mask, 5, 25), Sternheimer tol
    1e-11); the SCF Hessian's quadratic form (hessian_quadratic_form) of
    si2_basis with BlowupCHV (the SCF of 4 bands to 1e-12 from
    seeded_orbitals(mask, 7, 27)) along P_c seeded_potential psi."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.response.chi0 import apply_chi0, make_chi0_context
    from dftk_tpu.response.hessian import make_omega_plus_k
    from dftk_tpu.scf.energy_eval import evaluate_total_energy
    from dftk_tpu.scf.newton import newton
    from dftk_tpu.scf.potential_mixing import scf_potential_mixing
    out = {}
    b = gp2d_basis(dftk, Ecut=8.0)
    out["evaluate"] = evaluate_total_energy(b, _jnp(seeded_orbitals(b.mask_np, 1, 22)),
                                            np.ones((1, 1)))
    b = gp3d_basis(dftk, Ecut=10.0)
    res = scf_potential_mixing(b, tol=1e-10, maxiter=40)
    out["potential_mixing"] = dict(energies=_energies(res), n_iter=res.n_iter)
    res = newton(b, tol=1e-10)
    out["newton"] = dict(energies=_energies(res), n_iter=res.n_iter,
                         converged=bool(res.converged))
    b = fock_darwin_basis(dftk, Ecut=10.0)
    res = dftk.self_consistent_field(b, tol=1e-12, n_bands=2, maxiter=40,
                                     psi=_jnp(seeded_orbitals(b.mask_np, 5, 25)))
    drho = apply_chi0(make_chi0_context(res, b), b, _jnp(seeded_potential(b)[None]), tol=1e-11)
    out["chi0"] = dict(drho=table_summary(np.asarray(drho)),
                       max=float(np.abs(np.asarray(drho)).max()))
    b = si2_basis(dftk, blowup=dftk.BlowupCHV())
    res = dftk.self_consistent_field(b, tol=1e-12, n_bands=4, maxiter=60,
                                     psi=_jnp(seeded_orbitals(b.mask_np, 7, 27)))
    psi, occ = np.asarray(res.psi)[:, :4], np.asarray(res.occupation)[:, :4]
    OmegaK, Pc, _ = make_omega_plus_k(b, _jnp(psi), _jnp(occ))
    out["hessian"] = dict(q=hessian_quadratic_form(OmegaK, lambda d: Pc(_jnp(d)), b, psi,
                                                   seeded_potential(b)),
                          energies=_energies(res))
    return out


def entry_si54_q1():
    """chip_smoke.py phase q1: si54_q1_basis's H at the guess density applied
    to seeded_orbitals(mask, 8, 54) (band diagonal <psi_n|H psi_n> and a
    fingerprint of H psi), its explicit kinetic's fingerprint, and the
    pairwise E and F."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops import hamiltonian as H
    b = si54_q1_basis(dftk)
    rho = dftk.guess_density(b)
    V, _ = H.total_potential(b.terms, rho, jnp.asarray(b.G_cube_cart), b.model.unit_cell_volume)
    ham = H.build_ham(b.data, b.terms.data, V)
    psi = seeded_orbitals(b.mask_np, 8, 54)
    Hpsi = np.asarray(H.apply_H(ham, _jnp(psi), b.fft_size, b.model.unit_cell_volume))
    return dict(fft_size=list(b.fft_size), nG=int(b.nG_max),
                diag=np.einsum("kng,kng->kn", psi.conj(), Hpsi).real[0].tolist(),
                Hpsi_re=table_summary(Hpsi.real), Hpsi_im=table_summary(Hpsi.imag),
                kin=table_summary(b.terms.kin_np), E_pairwise=float(b.terms.E_pairwise),
                F_pairwise=np.asarray(b.terms.pairwise_forces).tolist())


if __name__ == "__main__":
    name = sys.argv[1]
    t0 = time.time()
    values = globals()["entry_" + name]()
    values["description"] = " ".join(globals()["entry_" + name].__doc__.split())
    values["cpu_seconds"] = time.time() - t0
    values["command"] = ("DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python "
                         f"tests/data/make_torch_port_terms.py {name}")
    print(json.dumps({name: values}, default=float), flush=True)
