"""The JAX package's CPU float64 values that tests/data/torch_port_exx.json
records for the port's exact-exchange, hybrid and DFT+U checks.

    DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python tests/data/make_torch_port_exx.py ENTRY

prints one JSON line: the entry's values, its `command` and its CPU
seconds (wall seconds of the run on the host).  Run from the repository
root.  The cells' constructors (any package: `dftk` is `dftk_tpu` here,
the port in tests/test_torch_exx.py and tests/test_torch_hubbard.py, which
pass device="cpu") and the seeded orbitals (`seeded_orbitals`, numpy only)
are imported by the tests and copied by `chip_smoke.py` phase p.
This script imports the JAX package, so it lives outside both packages.
"""
import json
import math
import pathlib
import sys
import time

import numpy as np

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
SI_POSITIONS = [np.ones(3) / 8, -np.ones(3) / 8]
HE_POS = [np.array([0.5, 0.5, 0.5])]
KGRID_L, KGRID_RC, KGRID_ECUT = 8.0, 4.0, 5.0      # tests/test_exx_kgrid.py
C_UPF = str(pathlib.Path(__file__).resolve().parent / "pseudos" / "C_m.upf")
HUBBARD_U = 0.15                                     # examples/hubbard.py
SI54_N_BANDS, SI54_N_OCC, SI54_SEED = 118, 108, 54


def seeded_orbitals(mask, n_bands, seed):
    """Orthonormal complex orbitals [nk, n_bands, nG] (numpy), zero on the
    padding of mask [nk, nG]: normal real and imaginary parts from
    numpy.random.default_rng(seed), each k block orthonormalised by QR."""
    rng = np.random.default_rng(seed)
    shape = (mask.shape[0], n_bands, mask.shape[1])
    psi = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * mask[:, None, :]
    out = np.empty_like(psi)
    for k in range(psi.shape[0]):
        out[k] = np.linalg.qr(psi[k].T)[0].T
    return out


def aufbau(n_kpoints, n_bands, n_occ, filled=2.0):
    """Occupations [nk, n_bands]: `filled` on the first n_occ bands."""
    occ = np.zeros((n_kpoints, n_bands))
    occ[:, :n_occ] = filled
    return occ


def table_summary(a, n_sample=48):
    """A compact fingerprint of a real table a (any shape): its first
    element (the G = 0 one of a cube), its sum, its sum against seeded
    uniform weights, and its values at n_sample seeded flat indices."""
    a = np.asarray(a, dtype=float).ravel()
    rng = np.random.default_rng(a.size)
    w = rng.uniform(size=a.size)
    idx = rng.choice(a.size, size=min(n_sample, a.size), replace=False)
    return dict(size=int(a.size), first=float(a[0]), sum=float(a.sum()),
                wsum=float(w @ a), sample=a[idx].tolist())


def as_complex(d):
    return np.array(d["re"]) + 1j * np.array(d["im"])


def _c(a):
    a = np.asarray(a)
    return dict(re=a.real.tolist(), im=a.imag.tolist())


def free_basis(dftk, L, Ecut=8.0, **kw):
    """tests/test_coulomb_kernels.py::_free_basis: an empty cubic cell."""
    m = dftk.Model(np.eye(3) * L, [], [], term_types=[dftk.Kinetic()], n_electrons=2,
                   symmetries=False)
    return dftk.PlaneWaveBasis(m, Ecut=Ecut, kgrid=(1, 1, 1), **kw)


def coulomb_kernels(dftk):
    """name -> the kernels of tests/test_coulomb_kernels.py and
    tests/test_exx.py, each regularisation of the long-range ones."""
    return {
        "coulomb_probe": dftk.Coulomb(),
        "coulomb_v0": dftk.Coulomb(v0=3.25),
        "coulomb_voxel": dftk.Coulomb(regularization=dftk.VoxelAveraged(n_quadrature_points=8)),
        "spherical": dftk.SphericallyTruncatedCoulomb(),
        "spherical_rc": dftk.SphericallyTruncatedCoulomb(rc=KGRID_RC),
        "short_range": dftk.ShortRangeCoulomb(mu=0.3),
        "long_range_probe": dftk.LongRangeCoulomb(mu=0.3),
        "long_range_zero": dftk.LongRangeCoulomb(
            mu=0.3, regularization=dftk.ReplaceSingularity(0.0)),
        "long_range_voxel": dftk.LongRangeCoulomb(
            mu=0.3, regularization=dftk.VoxelAveraged(n_quadrature_points=6)),
        "wigner_seitz": dftk.WignerSeitzTruncatedCoulomb(),
    }


def q_kernels(dftk):
    """name -> the kernels whose exx_q_kernels tables are recorded."""
    return {"coulomb_probe": dftk.Coulomb(),
            "coulomb_v0": dftk.Coulomb(v0=1.5),
            "spherical_rc": dftk.SphericallyTruncatedCoulomb(rc=KGRID_RC),
            "short_range": dftk.ShortRangeCoulomb(mu=0.11),
            "wigner_seitz": dftk.WignerSeitzTruncatedCoulomb()}


def hf_terms(dftk, kernel):
    """The base terms with full exact exchange through `kernel`."""
    return [dftk.Kinetic(), dftk.AtomicLocal(), dftk.AtomicNonlocal(), dftk.Ewald(),
            dftk.PspCorrection(), dftk.Hartree(),
            dftk.ExactExchange(scaling_factor=1.0, kernel=kernel)]


def he_kgrid_bases(dftk, **kw):
    """tests/test_exx_kgrid.py's HF helium with the truncated kernel of a
    fixed radius: (primitive cell on the (2, 1, 1) grid, doubled cell at
    Gamma)."""
    He = dftk.ElementPsp.from_symbol("He", psp="lda/he-q2")
    kern = dftk.SphericallyTruncatedCoulomb(rc=KGRID_RC)
    prim = dftk.Model(np.diag([KGRID_L] * 3), [He], HE_POS, term_types=hf_terms(dftk, kern),
                      symmetries=False)
    sc = dftk.Model(np.diag([2 * KGRID_L, KGRID_L, KGRID_L]), [He, He],
                    [np.array([.25, .5, .5]), np.array([.75, .5, .5])],
                    term_types=hf_terms(dftk, kern), symmetries=False)
    return (dftk.PlaneWaveBasis(prim, Ecut=KGRID_ECUT, kgrid=(2, 1, 1),
                                fft_size=(16, 16, 16), **kw),
            dftk.PlaneWaveBasis(sc, Ecut=KGRID_ECUT, kgrid=(1, 1, 1),
                                fft_size=(32, 16, 16), **kw))


def he_box_basis(dftk, model_fn, L=8.0, Ecut=8.0, **kw):
    """tests/test_exx.py's helium in a cubic box (lda/he-q2, Gamma, no
    symmetry) under model_fn (model_HF, PBE0, HSE06)."""
    He = dftk.ElementPsp.from_symbol("He", psp="lda/he-q2")
    model = model_fn(np.eye(3) * L, [He], HE_POS, symmetries=False)
    return dftk.PlaneWaveBasis(model, Ecut=Ecut, kgrid=(1, 1, 1), **kw)


def si2_hse_basis(dftk, **kw):
    """examples/hse_r2scan_silicon.py's HSE06 silicon (pbe/si-q4, Ecut 10,
    Gamma, the default symmetries)."""
    Si = dftk.ElementPsp.from_symbol("Si", psp="pbe/si-q4")
    model = dftk.HSE06(10.26 / 2 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]]), [Si, Si],
                       SI_POSITIONS)
    return dftk.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1), **kw)


def c2_hubbard_basis(dftk, U=HUBBARD_U, **kw):
    """examples/hubbard.py's carbon in the silicon cell (C_m.upf, PBE, +U on
    the p manifold of both atoms, Ecut 10, kgrid 2^3, the default
    symmetries, so the occupation matrix is symmetrized)."""
    C = dftk.ElementPsp.from_symbol("C", psp=C_UPF)
    mfs = (dftk.HubbardManifold(atom_index=0, l=1, U=U),
           dftk.HubbardManifold(atom_index=1, l=1, U=U))
    model = dftk.model_DFT(SI_LATTICE, [C, C], SI_POSITIONS, functionals="PBE",
                           extra_terms=[dftk.Hubbard(manifolds=mfs)])
    return dftk.PlaneWaveBasis(model, Ecut=10.0, kgrid=(2, 2, 2), **kw)


def si54_hse_basis(dftk, **kw):
    """bench.py's Si54 geometry (n_rep 3) under HSE06 with pbe/si-q4, Ecut
    10, Gamma, no symmetry (64^3 grid)."""
    a = A_SI
    lattice = np.array([[0.0, a, a], [a, 0.0, a], [a, a, 0.0]]) * 3
    Si = dftk.ElementPsp.from_symbol("Si", psp="pbe/si-q4")
    positions = [(b + np.array([i, j, k])) / 3 for i in range(3) for j in range(3)
                 for k in range(3) for b in SI_POSITIONS]
    model = dftk.HSE06(lattice, [Si] * len(positions), positions, symmetries=False)
    return dftk.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1), **kw)


# ---------------------------------------------------------------------------
# entries (JAX package)
# ---------------------------------------------------------------------------

def _jax_exchange(basis, kern, iq, psi, occ):
    """JAX: (Vx psi [nk, nb, nG], band diagonal [nk, nb], E_x) with the
    generators psi at weights w_k occ / filled."""
    import jax
    import jax.numpy as jnp
    from dftk_tpu.ops import hamiltonian as hamops
    bd, model = basis.data, basis.model
    V0 = jnp.zeros((model.n_spin_components,) + tuple(basis.fft_size))
    ham = hamops.build_ham(bd, basis.terms.data, V0, exx_kernel=jnp.asarray(kern),
                           exx_psi=jnp.asarray(psi),
                           exx_occ=bd.kweights[:, None] * jnp.asarray(occ)
                           / model.filled_occupation,
                           exx_iq=None if iq is None else jnp.asarray(iq))
    vx = jax.jit(lambda h, p: hamops._apply_exchange(h, p, basis.fft_size,
                                                     model.unit_cell_volume))(ham, jnp.asarray(psi))
    diag = np.asarray(jnp.einsum("kng,kng->kn", jnp.conj(jnp.asarray(psi)), vx).real)
    E = 0.5 * float(np.sum(np.asarray(bd.kweights)[:, None] * occ * diag))
    return np.asarray(vx), diag, E


def entry_coulomb():
    """Every Coulomb kernel and regularisation of tests/test_coulomb_kernels.py
    on the free cubic cell L = 10 (Ecut 8) through kernel_fourier_cube (each
    cube as its table_summary), the
    legacy basis-free `fourier` forms at tests/test_exx.py's |G|^2 samples
    (volume 500), and exx_q_kernels (vq, iq) on HF helium L = 8, Ecut 5,
    fft 16^3, at kgrid (2, 2, 1) and at Gamma (each cube of vq as its
    table_summary)."""
    import dftk_tpu as dftk
    from dftk_tpu.ops.coulomb import exx_q_kernels, kernel_fourier_cube
    basis = free_basis(dftk, 10.0)
    cubes = {name: table_summary(kernel_fourier_cube(k, basis))
             for name, k in coulomb_kernels(dftk).items()}
    Gsq = np.array([0.0, 0.3, 1.7, 9.0])
    legacy = {name: np.asarray(k.fourier(Gsq, 500.0)).tolist()
              for name, k in coulomb_kernels(dftk).items() if hasattr(k, "fourier")}
    He = dftk.ElementPsp.from_symbol("He", psp="lda/he-q2")
    kern = dftk.SphericallyTruncatedCoulomb(rc=KGRID_RC)
    m = dftk.Model(np.diag([KGRID_L] * 3), [He], HE_POS, term_types=hf_terms(dftk, kern),
                   symmetries=False)
    tables = {}
    for kg in ((2, 2, 1), (1, 1, 1)):
        b = dftk.PlaneWaveBasis(m, Ecut=KGRID_ECUT, kgrid=kg, fft_size=(16, 16, 16))
        for name, k in q_kernels(dftk).items():
            vq, iq = exx_q_kernels(k, b)
            tables[f"{name}@{kg[0]}{kg[1]}{kg[2]}"] = dict(
                vq=[table_summary(v) for v in np.asarray(vq)], shape=list(np.shape(vq)),
                iq=np.asarray(iq).tolist())
    return dict(fft_size=list(basis.fft_size), cubes=cubes, legacy_Gsq=Gsq.tolist(),
                legacy=legacy, q_tables=tables)


def entry_wpbeh():
    """gga_x_wpbeh (omega 0.11 and 0.3): the energy density and its
    jax.grad in rho and sigma on seeded samples (rho log-uniform in
    [1e-6, 10], sigma = (s 2 kF rho)^2 with s uniform in [0, 4] and a few
    s = 0 and s = 60 points), unpolarised and collinear."""
    import jax
    import jax.numpy as jnp
    import dftk_tpu  # noqa: F401  (float64)
    from dftk_tpu.ops.xc.functionals import make_gga_x_wpbeh
    rho1, sig1, rho2, sig2 = wpbeh_samples()
    out = {}
    for omega in (0.11, 0.3):
        f = make_gga_x_wpbeh(omega)
        for tag, rho, sig in (("unpol", rho1, sig1), ("pol", rho2, sig2)):
            E = lambda r, s: jnp.sum(f.energy(r, s))
            e = np.asarray(f.energy(jnp.asarray(rho), jnp.asarray(sig)))
            vr, vs = jax.grad(E, argnums=(0, 1))(jnp.asarray(rho), jnp.asarray(sig))
            out[f"{omega:g}_{tag}"] = dict(e=e.tolist(), vrho=np.asarray(vr).tolist(),
                                           vsigma=np.asarray(vs).tolist())
    return out


def wpbeh_samples(n=64, seed=3):
    """(rho [1, n], sigma [1, n], rho [2, n], sigma [3, n]) of entry_wpbeh."""
    rng = np.random.default_rng(seed)

    def one(m):
        rho = 10.0 ** rng.uniform(-6, 1, size=m)
        s = rng.uniform(0, 4, size=m)
        s[:3] = 0.0
        s[3:5] = 60.0
        kf = (3 * math.pi ** 2 * rho) ** (1 / 3)
        return rho, (s * 2 * kf * rho) ** 2
    r, s = one(n)
    ra, sa = one(n)
    rb, sb = one(n)
    sab = rng.uniform(-1, 1, size=n) * np.sqrt(sa * sb)
    return r[None], s[None], np.stack([ra, rb]), np.stack([sa, sab, sb])


def entry_he_gamma():
    """HF helium (L = 8, Ecut 8, Gamma): on seeded_orbitals(mask, 4, 1) with
    aufbau occupations (2 on band 0, plus 0.5 on band 1 as a generator with
    a fractional weight), the exchange apply Vx psi, its band diagonal and
    E_x for the bare Coulomb (ProbeCharge) and the HSE06 kernel
    (ShortRangeCoulomb(0.11) x 0.25); then the HF SCF from
    seeded_orbitals(mask, 4, 2) (density tol 1e-10, maxiter 100, ACE): its
    energy history and converged energies."""
    import dftk_tpu as dftk
    from dftk_tpu.models.standard import model_HF
    from dftk_tpu.ops.coulomb import ShortRangeCoulomb, exx_q_kernels
    basis = he_box_basis(dftk, model_HF)
    psi = seeded_orbitals(basis.mask_np, 4, 1)
    occ = aufbau(1, 4, 1)
    occ[:, 1] = 0.5
    out = dict(fft_size=list(basis.fft_size), nG=int(basis.nG_max))
    for name, kern, scale in (("coulomb", basis.terms.exx_kernel_np, 1.0),
                              ("hse", exx_q_kernels(ShortRangeCoulomb(mu=0.11), basis)[0], 0.25)):
        vx, diag, E = _jax_exchange(basis, scale * kern[0], None, psi, occ)
        out[name] = dict(vx=_c(vx), diag=diag.tolist(), E=E)
    psi0 = seeded_orbitals(basis.mask_np, 4, 2)
    import jax.numpy as jnp
    res = dftk.self_consistent_field(basis, tol=1e-10, maxiter=100, psi=jnp.asarray(psi0))
    out["scf"] = dict(history=res.history_Etot, energies=dict(res.energies),
                      n_iter=res.n_iter, converged=bool(res.converged))
    return out


def entry_he_kgrid():
    """tests/test_exx_kgrid.py's HF helium: on the (2, 1, 1) grid's
    seeded_orbitals(mask, 3, 4) with occupations 2 and 0.5 on bands 0 and 1,
    the k-grid exchange apply, diagonal and E_x; then the converged HF SCFs
    (tol 1e-10 on the energy, maxiter 60, ACE) of the k-grid cell and its
    doubled supercell at Gamma from seeded_orbitals(mask, n, 5)."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    bp, bs = he_kgrid_bases(dftk)
    psi = seeded_orbitals(bp.mask_np, 3, 4)
    occ = aufbau(bp.n_kpoints, 3, 1)
    occ[:, 1] = 0.5
    vx, diag, E = _jax_exchange(bp, bp.terms.exx_kernel_np, bp.terms.exx_iq_np, psi, occ)
    out = dict(fft_size=list(bp.fft_size), apply=dict(vx=_c(vx), diag=diag.tolist(), E=E))
    for tag, b in (("kgrid", bp), ("supercell", bs)):
        nb = b.model.default_n_bands() + 3
        res = dftk.self_consistent_field(b, tol=1e-10, maxiter=60, is_converged="energy",
                                         psi=jnp.asarray(seeded_orbitals(b.mask_np, nb, 5)))
        out[tag] = dict(energies=dict(res.energies), n_iter=res.n_iter,
                        converged=bool(res.converged), n_bands=nb)
    return out


def entry_hybrids():
    """The converged energies (density tol 1e-9, maxiter 60, ACE) of
    examples/hse_r2scan_silicon.py's HSE06 silicon (Ecut 10, Gamma) and
    examples/hybrid_he.py's HF and PBE0 helium (L = 10, Ecut 15), each from
    seeded_orbitals(mask, n_bands + 3, 6)."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.models.standard import PBE0, model_HF
    out = {}
    for tag, basis in (("si2_hse06", si2_hse_basis(dftk)),
                       ("he_hf", he_box_basis(dftk, model_HF, L=10.0, Ecut=15.0)),
                       ("he_pbe0", he_box_basis(dftk, PBE0, L=10.0, Ecut=15.0))):
        nb = basis.model.default_n_bands() + 3
        res = dftk.self_consistent_field(basis, tol=1e-9, maxiter=60,
                                         psi=jnp.asarray(seeded_orbitals(basis.mask_np, nb, 6)))
        out[tag] = dict(energies=dict(res.energies), n_iter=res.n_iter,
                        converged=bool(res.converged), fft_size=list(basis.fft_size),
                        n_bands=nb)
    return out


def entry_c2_hubbard():
    """examples/hubbard.py's C2 PBE+U (U 0.15 on the p manifolds): the
    projectors Phi, and on seeded_orbitals(mask, 8, 7) with aufbau
    occupations (4 bands of 2, plus 0.4 on band 4) the occupation matrix
    before and after the symmetrization, the +U energy of the symmetrized
    one, its potential matrix and the apply V_U psi; then the SCF (density
    tol 1e-10, maxiter 60) from seeded_orbitals(mask, 7, 8)."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops import hubbard as hub
    basis = c2_hubbard_basis(dftk)
    model, bd = basis.model, basis.data
    mfs = basis.terms.hubbard_manifolds
    Phi, slices = hub.build_hubbard_projectors(basis, mfs)
    plan = hub.build_occupation_symmetrization(basis, mfs, slices)
    psi = seeded_orbitals(basis.mask_np, 8, 7)
    occ = aufbau(basis.n_kpoints, 8, 4)
    occ[:, 4] = 0.4
    n = hub.occupation_matrix(Phi, jnp.asarray(psi), jnp.asarray(occ), bd.kweights, bd.kspin,
                              model.n_spin_components)
    n_sym = hub.symmetrize_occupation_matrix(n, slices, plan)
    E = hub.hubbard_energy(n_sym, mfs, slices, model.filled_occupation)
    V = hub.hubbard_potential_matrix(n_sym, mfs, slices, model.filled_occupation)
    VUpsi = hub.apply_hubbard(Phi, V, bd.kspin, jnp.asarray(psi))
    psi0 = seeded_orbitals(basis.mask_np, model.default_n_bands() + 3, 8)
    res = dftk.self_consistent_field(basis, tol=1e-10, maxiter=60, psi=jnp.asarray(psi0))
    return dict(fft_size=list(basis.fft_size), n_kpoints=int(basis.n_kpoints),
                n_symmetries=len(basis.symmetries), slices=[list(s) for s in slices],
                Phi=_c(Phi), n=_c(n), n_sym=_c(n_sym), E=float(E), V=_c(V), VUpsi=_c(VUpsi),
                scf=dict(energies=dict(res.energies), n_iter=res.n_iter,
                         converged=bool(res.converged)))


def entry_si54_exx():
    """Si54 HSE06 (si54_hse_basis): on seeded_orbitals(mask, 118, 54) with
    occupations 2 on the first 108 bands, the band diagonal <psi_n|Vx psi_n>
    and E_x for the model's HSE06 kernel (ShortRangeCoulomb(0.11) x 0.25)
    and for the bare Coulomb kernel (ProbeCharge) at scaling 1."""
    import dftk_tpu as dftk
    from dftk_tpu.ops.coulomb import Coulomb, exx_q_kernels
    basis = si54_hse_basis(dftk)
    psi = seeded_orbitals(basis.mask_np, SI54_N_BANDS, SI54_SEED)
    occ = aufbau(1, SI54_N_BANDS, SI54_N_OCC)
    out = dict(fft_size=list(basis.fft_size), nG=int(basis.nG_max))
    for name, kern in (("hse", basis.terms.exx_kernel_np[0]),
                       ("coulomb", exx_q_kernels(Coulomb(), basis)[0][0])):
        t0 = time.time()
        _, diag, E = _jax_exchange(basis, kern, None, psi, occ)
        out[name] = dict(diag=diag[0].tolist(), E=E, apply_seconds=time.time() - t0)
        print(f"{name}: E_x = {E!r}, {time.time() - t0:.1f} s", file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    name = sys.argv[1]
    t0 = time.time()
    values = globals()["entry_" + name]()
    values["description"] = " ".join(globals()["entry_" + name].__doc__.split())
    values["cpu_seconds"] = time.time() - t0
    values["command"] = ("DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python "
                         f"tests/data/make_torch_port_exx.py {name}")
    print(json.dumps({name: values}, default=float), flush=True)
