"""The JAX package's CPU float64 values that tests/data/torch_port_scf.json
records for tests/test_torch_scf.py, tests/test_torch_split.py,
tests/test_torch_forces.py, tests/test_torch_hamiltonian.py and
tests/test_torch_kernels.py.

    DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python tests/data/make_torch_port_scf.py ENTRY

prints one JSON line: the entry's values, its `command` and its CPU
seconds (wall seconds of the run on the host).  Run from the repository
root.  The cells' constructors (any package: `dftk` is `dftk_tpu` here,
the port in the tests, which pass device="cpu") and the seeded inputs
(numpy only) are imported by the tests.  Where a JAX function is held
against the port on a state that the port computes (the refine of the
split SCF's result, the upper bound of the CheFSI step), the entry runs
that port function here on the CPU and records its input with the JAX
value.  This script imports the JAX package, so it lives outside both
packages.
"""
import json
import sys
import time

import numpy as np

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
SI_POSITIONS = [np.ones(3) / 8, -np.ones(3) / 8]
DISPLACED = [np.array([0.127, 0.125, 0.123]), -np.ones(3) / 8]
SCF_N_BANDS = 8                              # tests/test_torch_scf.py
SPLIT_N_BANDS, SPLIT_N_EXTRA = 4, 4          # tests/test_torch_split.py
CHEFSI = dict(eigensolver="chefsi", chebyshev_degree=8, chefsi_cycles=2)
FORCES_OCC = [2.0, 2.0, 2.0, 2.0, 0.0, 0.0]  # tests/test_torch_forces.py
STRAIN = np.eye(3) + 1e-2 * np.array([[1.0, 0.3, -0.2], [0.3, -0.5, 0.1], [-0.2, 0.1, 0.7]])


def si2_kgrid_basis(dftk, positions=SI_POSITIONS, kgrid=None, **kw):
    """Si2 (lda/si-q4, lda_x + lda_c_vwn, no symmetry) at Ecut 7 on the
    18^3 grid, on MonkhorstPack((2, 2, 2)) unless kgrid is given."""
    Si = dftk.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dftk.model_DFT(SI_LATTICE, [Si, Si], positions,
                           functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    kgrid = dftk.MonkhorstPack((2, 2, 2)) if kgrid is None else kgrid
    return dftk.PlaneWaveBasis(model, Ecut=7.0, kgrid=kgrid, fft_size=(18, 18, 18), **kw)


def si2_gamma_basis(dftk, **kw):
    """tests/testcases.py::make_silicon_model's Si2 without symmetry, Ecut 6,
    Gamma, the default FFT size."""
    Si = dftk.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dftk.model_DFT(SI_LATTICE, [Si, Si], SI_POSITIONS,
                           functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    return dftk.PlaneWaveBasis(model, Ecut=6.0, kgrid=(1, 1, 1), **kw)


def orthonormal_rows(mask, n_bands, seed):
    """[nk, n_bands, nG]: seeded complex normals (numpy default_rng(seed)),
    zero on the padding of mask [nk, nG], each k block orthonormalised."""
    rng = np.random.default_rng(seed)
    out = np.empty((mask.shape[0], n_bands, mask.shape[1]), dtype=complex)
    for k in range(mask.shape[0]):
        X = (rng.normal(size=(n_bands, mask.shape[1]))
             + 1j * rng.normal(size=(n_bands, mask.shape[1]))) * mask[k]
        out[k] = np.linalg.qr(X.T)[0].T
    return out


def split_start(mask):
    """tests/test_torch_split.py's X0 [1, 8, nG] and its realified U0."""
    X0 = orthonormal_rows(mask, SPLIT_N_BANDS + SPLIT_N_EXTRA, 11)
    return X0, np.concatenate([X0.real, X0.imag], axis=-1)


def forces_state(mask):
    """tests/test_torch_forces.py's orbitals [nk, 6, nG]: seeded normals
    (default_rng(1)) over all k at once, orthonormalised on each sphere."""
    rng = np.random.default_rng(1)
    shape = (mask.shape[0], mask.shape[1], len(FORCES_OCC))
    X = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * mask[:, :, None]
    return np.linalg.qr(X)[0].transpose(0, 2, 1).copy()


def as_complex(d):
    return np.array(d["re"]) + 1j * np.array(d["im"])


def _c(a):
    a = np.asarray(a)
    return dict(re=a.real.tolist(), im=a.imag.tolist())


def _port_cpu():
    import torch
    import dftk_tpu_torch as dt
    torch.set_num_threads(1)
    return dt


def entry_scf():
    """tests/test_torch_scf.py: Si2 on kgrid 2^3 (si2_kgrid_basis), from
    orthonormal_rows(mask, 11, 3) and the JAX guess density: one LOBPCG
    (tol 1e-7, 8 bands converged) on H at that density, and the SCF (energy
    tol 1e-8, 8 bands)."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops import hamiltonian as jax_ham
    from dftk_tpu.ops.density import guess_density
    from dftk_tpu.ops.eigen.lobpcg import lobpcg
    jb = si2_kgrid_basis(dftk)
    psi0 = jnp.asarray(orthonormal_rows(jb.mask_np, SCF_N_BANDS + 3, 3))
    rho0 = guess_density(jb)
    volume = jb.model.unit_cell_volume
    V, _ = jax_ham.total_potential(jb.terms, rho0, jnp.asarray(jb.G_cube_cart), volume)
    ham = jax_ham.build_ham(jb.data, jb.terms.data, V)
    res = lobpcg(lambda p: jax_ham.apply_H(ham, p, jb.fft_size, volume), psi0, ham.kin,
                 jb.data.mask, tol=1e-7, n_conv=SCF_N_BANDS)
    scf = dftk.self_consistent_field(jb, psi=psi0, rho=rho0, tol=1e-8, is_converged="energy",
                                     n_bands=SCF_N_BANDS)
    return dict(rho0=np.asarray(rho0).tolist(),
                lobpcg=dict(eigenvalues=np.asarray(res.eigenvalues).tolist(),
                            converged=bool(res.converged)),
                scf=dict(total_energy=scf.total_energy,
                         eigenvalues=np.asarray(scf.eigenvalues).tolist(),
                         converged=bool(scf.converged), n_iter=scf.n_iter))


def entry_split():
    """tests/test_torch_split.py: Si2 Gamma (si2_gamma_basis) from
    split_start and the JAX guess density rho0: the split SCFs (tol 1e-10,
    maxiter 60, 4 + 4 bands) with CheFSI at filter 'highest', LOBPCG and the
    Penn-model mixing ("auto"); the compact filter apply at rho0; the
    chefsi_step (degree 8, 2 cycles) at the port's upper bound (rounded to
    3 decimals); evaluate_total_energy on the port's CheFSI SCF result;
    the split adapters (realify, apply_H, density, potential,
    psi_energies); the Kerker mixing of default_rng(5)'s residual and five
    Anderson steps of its noise; create_supercell of the cell with atoms
    "a", "b" by (2, 1, 3)."""
    import jax.numpy as jnp
    import torch
    import dftk_tpu as dftk
    from dftk_tpu.ops import engine_split as jes
    from dftk_tpu.ops import hamiltonian as jax_ham
    from dftk_tpu.ops.density import guess_density
    from dftk_tpu.ops.eigen.chefsi import chefsi_step
    from dftk_tpu.scf.energy_eval import evaluate_total_energy
    dt = _port_cpu()
    from dftk_tpu_torch.ops import hamiltonian as ham_ops
    from dftk_tpu_torch.ops.eigen.chefsi import estimate_upper_bound
    from dftk_tpu_torch.scf.energy_eval import split_state_to_complex
    jb = si2_gamma_basis(dftk)
    tb = si2_gamma_basis(dt, device="cpu")
    X0, U0 = split_start(tb.mask_np)
    rho0 = np.asarray(guess_density(jb))
    volume = jb.model.unit_cell_volume
    out = dict(rho0=rho0.tolist(), scf={})
    kw = dict(tol=1e-10, maxiter=60, n_bands=SPLIT_N_BANDS, n_extra_bands=SPLIT_N_EXTRA)
    for case, extra in (("chefsi", dict(filter_precision="highest", **CHEFSI)),
                        ("lobpcg", {}), ("auto_eps", dict(mixing_eps_r="auto"))):
        r = jes.self_consistent_field_split(jb, dtype=jnp.float64, U0=jnp.asarray(U0),
                                            rho0=jnp.asarray(rho0), **kw, **extra)
        out["scf"][case] = dict(total=r["energies"]["total"], converged=bool(r["converged"]),
                                eigenvalues=np.asarray(r["eigenvalues"]).tolist(),
                                n_iter=r["n_iter"])
    V_j, _ = jax_ham.total_potential(jb.terms, jnp.asarray(rho0), jnp.asarray(jb.G_cube_cart),
                                     volume)
    sd = jes.prepare_split_data(jb, dtype=jnp.float64)
    enter, leave, apply_c = jes.compact_filter_ops(jes.make_split_ham(sd, V_j), volume,
                                                   precision="highest")
    out["compact_filter"] = np.asarray(leave(apply_c(enter(jnp.asarray(U0))))).tolist()
    # the CheFSI step at the port's upper bound
    V_t, _, _ = ham_ops.total_potential(tb.terms, torch.as_tensor(rho0), volume)
    ham_t = ham_ops.build_ham(tb.data, tb.terms.data, V_t, tb.pruned)
    ub = round(estimate_upper_bound(lambda p: ham_ops.apply_H(ham_t, p), torch.as_tensor(X0),
                                    tb.data.mask), 3)
    ham_j = jax_ham.build_ham(jb.data, jb.terms.data, V_j)
    res = chefsi_step(lambda p: jax_ham.apply_H(ham_j, p, jb.fft_size, volume),
                      jnp.asarray(X0), jb.data.mask, degree=8, ub=ub, n_conv=SPLIT_N_BANDS,
                      cycles=2)
    out["chefsi_step"] = dict(ub=ub, eigenvalues=np.asarray(res.eigenvalues).tolist())
    # the JAX energy of the port's CheFSI SCF result
    rt = dt.self_consistent_field_split(tb, U0=U0, rho0=rho0, **kw,
                                        filter_precision="highest", **CHEFSI)
    psi, occ = split_state_to_complex(tb, rt["U"], rt["occupation"])
    E = evaluate_total_energy(jb, jnp.asarray(psi.numpy()), jnp.asarray(occ.numpy()))
    out["refine"] = dict(energies={k: float(v) for k, v in E.items()},
                         port_total=rt["energies"]["total"])
    # the split adapters on U0 and rho0
    occ = np.tile([2.0] * SPLIT_N_BANDS + [0.0] * SPLIT_N_EXTRA, (1, 1))
    E_psi = jes.psi_energies_split(sd, jnp.asarray(U0), jnp.asarray(occ))
    out["adapters"] = dict(
        realify=np.asarray(jes.realify_orbitals(jnp.asarray(X0))).tolist(),
        apply_H=np.asarray(jes.apply_H_split(jes.make_split_ham(sd, V_j), jnp.asarray(U0),
                                             jb.fft_size, volume)).tolist(),
        density=np.asarray(jes.compute_density_split(sd, jnp.asarray(U0), jnp.asarray(occ),
                                                     jb.fft_size, volume, 1)).tolist(),
        potential=np.asarray(jes.total_potential_split(jb.terms, sd, jnp.asarray(rho0),
                                                       volume)[0]).tolist(),
        psi_energies={k: float(v) for k, v in E_psi.items()})
    # the mixing pieces: the residual and noise of default_rng(5)
    rng = np.random.default_rng(5)
    dF = rng.normal(size=rho0.shape)
    Gsq = jnp.asarray(tb.terms.data.Gsq_cart.numpy())
    kerker = np.asarray(jes.kerker_mix_split(jnp.asarray(dF), Gsq))
    rng = np.random.default_rng(5)
    m = 3
    step = jes.make_mix_step(None, m)
    st = (jnp.zeros((m,) + rho0.shape),) * 2 + (jnp.asarray(0),)
    rho, drho = jnp.asarray(rho0), []
    for _ in range(5):
        noise = 0.01 * rng.normal(size=rho0.shape)
        rho, *st, d = step(rho, rho + noise, *st, jnp.asarray(0.8), jnp.asarray(0.0))
        drho.append(float(d))
    out["mixing"] = dict(kerker=kerker.tolist(), anderson_rho=np.asarray(rho).tolist(),
                         anderson_drho=drho)
    from dftk_tpu.supercell import create_supercell
    sc = create_supercell(SI_LATTICE, ["a", "b"], SI_POSITIONS, (2, 1, 3))
    out["supercell"] = dict(lattice=np.asarray(sc["lattice"]).tolist(),
                            positions=np.asarray(sc["positions"]).tolist(),
                            atoms=list(sc["atoms"]), size=list(sc["size"]))
    return out


def entry_forces():
    """tests/test_torch_forces.py: Si2 with atom 0 displaced (DISPLACED) on
    kgrid 2^3, forces_state's orbitals at FORCES_OCC and the JAX guess
    density: the Ewald energy and its position and lattice gradients;
    compute_forces (its gradient under jax.jit), compute_forces_cart's
    conversion, compute_stresses_cart (jitted), compute_forces_split and
    compute_stresses_split (f64), energy_at_lattice at SI_LATTICE and
    STRAIN @ SI_LATTICE, and the forces and stresses symmetrized over the
    four operations the port detects in the displaced cell."""
    import copy
    import types
    import jax
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu import symmetry as jax_symmetry
    from dftk_tpu.ops import ewald as jax_ewald
    from dftk_tpu.ops.density import guess_density
    from dftk_tpu.ops.engine_split import prepare_split_data
    from dftk_tpu.ops.forces_split import compute_forces_split
    from dftk_tpu.ops.stresses_split import compute_stresses_split
    from dftk_tpu.postprocess import forces as jax_forces
    from dftk_tpu.postprocess import stresses as jax_stresses
    dt = _port_cpu()
    from dftk_tpu_torch.symmetry import symmetry_operations
    jb = si2_kgrid_basis(dftk, DISPLACED)
    psi = forces_state(jb.mask_np)
    rho = np.asarray(guess_density(jb))
    occ = np.tile(FORCES_OCC, (jb.n_kpoints, 1))
    js = types.SimpleNamespace(basis=jb, psi=jnp.asarray(psi), occupation=jnp.asarray(occ),
                               rho=jnp.asarray(rho))

    def energy_at(basis):
        return jax.jit(lambda L: jax_stresses.energy_at_lattice(basis, js.psi, js.occupation, L))

    def stresses_of(basis):
        L0 = jnp.asarray(basis.model.lattice)
        energy = energy_at(basis)
        grad = jax.jit(jax.grad(lambda eps: energy((jnp.eye(3) + (eps + eps.T) / 2) @ L0)))
        g = np.asarray(grad(jnp.zeros((3, 3)))) / basis.model.unit_cell_volume
        return jax_stresses.symmetrize_stresses(basis, (g + g.T) / 2)

    def energy(pos):
        with jax.ensure_compile_time_eval():
            return jax_forces._positions_energy(jb, js.psi, js.occupation, js.rho, pos)
    F = -np.asarray(jax.jit(jax.grad(energy))(jnp.asarray(np.stack(jb.model.positions))))
    Fc = jax_forces.symmetrize_forces(jb, F) @ np.linalg.inv(jb.model.lattice)
    S = stresses_of(jb)
    q = jnp.array([4.0, 4.0])
    pos = jnp.asarray(np.stack(DISPLACED))
    eta = jax_ewald.default_eta(SI_LATTICE)
    boxes = dict(zip(("Gbox", "Rbox"), jax_ewald.ewald_sum_bounds(SI_LATTICE, pos, eta)))
    E_ew, (g_L, g_pos) = jax.jit(jax.value_and_grad(
        lambda L, p: jax_ewald.energy_ewald(L, q, p, eta=eta, **boxes), argnums=(0, 1)))(
        jnp.asarray(SI_LATTICE), pos)
    U = jnp.asarray(np.concatenate([psi.real, psi.imag], axis=-1))
    sd = prepare_split_data(jb, dtype=jnp.float64)
    F_split = np.asarray(compute_forces_split(jb, sd, U, js.occupation, js.rho))
    S_split = np.asarray(compute_stresses_split(jb, sd, U, js.occupation))
    E_lat = [float(energy_at(jb)(jnp.asarray(L))) for L in (SI_LATTICE, STRAIN @ SI_LATTICE)]
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    ops = symmetry_operations(SI_LATTICE, [Si, Si], DISPLACED)
    assert len(ops) == 4
    jbs = copy.copy(jb)
    jbs.symmetries = [jax_symmetry.SymOp.make(op.W, op.w) for op in ops]
    F_sym = jax_forces.symmetrize_forces(jbs, F) @ np.linalg.inv(jb.model.lattice)
    S_sym = stresses_of(jbs)
    return dict(rho=rho.tolist(), ewald=dict(E=float(E_ew), g_pos=np.asarray(g_pos).tolist(),
                                             g_L=np.asarray(g_L).tolist()),
                forces=F.tolist(), forces_cart=np.asarray(Fc).tolist(),
                stresses=np.asarray(S).tolist(), forces_split=F_split.tolist(),
                stresses_split=S_split.tolist(), energy_at_lattice=E_lat,
                symmetrized=dict(forces_cart=np.asarray(F_sym).tolist(),
                                 stresses=np.asarray(S_sym).tolist()))


HAM_BANDS, HAM_SEED = 5, 31                  # tests/test_torch_hamiltonian.py
ENERGY_BANDS, ENERGY_SEED = 4, 32


def entry_hamiltonian():
    """tests/test_torch_hamiltonian.py: on si2_kgrid_basis at the JAX guess
    density (entry scf's rho0), the total potential V and its energies,
    H psi for orthonormal_rows(mask, 5, 31), and the Kinetic and nonlocal
    energies of orthonormal_rows(mask, 4, 32) with occupations 2."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops import hamiltonian as jax_ham
    from dftk_tpu.ops.density import guess_density
    jb = si2_kgrid_basis(dftk)
    volume = jb.model.unit_cell_volume
    V, E = jax_ham.total_potential(jb.terms, guess_density(jb), jnp.asarray(jb.G_cube_cart),
                                   volume)
    ham = jax_ham.build_ham(jb.data, jb.terms.data, V)
    psi = jnp.asarray(orthonormal_rows(jb.mask_np, HAM_BANDS, HAM_SEED))
    Hpsi = jax_ham.apply_H(ham, psi, jb.fft_size, volume)
    psi4 = jnp.asarray(orthonormal_rows(jb.mask_np, ENERGY_BANDS, ENERGY_SEED))
    occ = jnp.full((jb.n_kpoints, ENERGY_BANDS), 2.0)
    Epsi = jax_ham.psi_energies(ham, jb.terms, psi4, occ, jb.data.kweights)
    return dict(V=np.asarray(V).tolist(), energies={k: float(v) for k, v in E.items()},
                Hpsi=_c(Hpsi), psi_energies={k: float(v) for k, v in Epsi.items()})


LOCAL_NB = 3     # bands of tests/test_torch_kernels.py's local apply (on every k-point)
PLANE_NB = 4     # bands of its plane and dot_z inputs


def kernel_inputs(seed, nk, m, n):
    """tests/test_torch_kernels.py's local-apply inputs: a compact cube xc
    [nk, 3, m1, m2, m3] (complex128) and a potential V [nk, n3, n1, n2], one
    per k-point, from numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    shape = (nk, LOCAL_NB) + tuple(m)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape),
            rng.normal(size=(nk, n[2], n[0], n[1])))


def plane_inputs(seed, m, n):
    """A plane block t [4, n3, m1, m2] (complex64) and V [n3, n1, n2]
    (float32) from numpy.random.default_rng(seed)."""
    rng = np.random.default_rng(seed)
    (m1, m2), n3 = m[:2], n[2]
    t = (rng.normal(size=(PLANE_NB, n3, m1, m2))
         + 1j * rng.normal(size=(PLANE_NB, n3, m1, m2))).astype(np.complex64)
    return t, rng.normal(size=(n3, n[0], n[1])).astype(np.float32)


def entry_kernels():
    """tests/test_torch_kernels.py: on si2_kgrid_basis, the JAX package's
    pruned factors (its realified block factors as complex [m, n] and
    [n, m] per axis); fused_local_apply (f64, interpret mode) of
    kernel_inputs(0); fused_filter_mid of plane_inputs(1) at 'highest' and
    of plane_inputs(6) at 'default' and 'highest', and dot_z of a seeded
    compact cube (default_rng(7), complex64) at 'default' and 'highest'
    (f32, interpret mode)."""
    import functools
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    import dftk_tpu as dftk
    from dftk_tpu.kernels.fused_filter import FusedFilterFactors, dot_z, fused_filter_mid
    from dftk_tpu.kernels.fused_local import fused_local_apply
    from dftk_tpu.ops.engine_split import build_pruned_fft
    jb = si2_kgrid_basis(dftk)
    pf = build_pruned_fft(jb, dtype=jnp.float64)
    fwd, bwd = [], []
    for a in range(3):
        blk_f, blk_b = np.asarray(pf.Fblk_f[a]), np.asarray(pf.Fblk_b[a])   # [[C, S], [-S, C]]
        m, n = blk_f.shape[0] // 2, blk_f.shape[1] // 2
        fwd.append(_c(blk_f[:m, :n] + 1j * blk_f[:m, n:]))
        bwd.append(_c(blk_b[:n, :m] + 1j * blk_b[:n, m:]))
    m_shape = tuple(np.asarray(pf.Fblk_f[a]).shape[0] // 2 for a in range(3))
    n = jb.fft_size
    xc, V_zxy = kernel_inputs(0, jb.n_kpoints, m_shape, n)
    yr, yi = fused_local_apply(jnp.asarray(xc.real), jnp.asarray(xc.imag),
                               jnp.asarray(np.transpose(V_zxy, (0, 1, 3, 2))), pf,
                               interpret=True)
    out = dict(m_shape=list(m_shape), fwd=fwd, bwd=bwd, local_apply=_c(np.asarray(yr)
                                                                        + 1j * np.asarray(yi)))
    pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    pf32 = build_pruned_fft(jb, dtype=jnp.float32)

    def plane(t, V, prec):
        # fused_filter_mid's layout: [n3, 2 (re/im), m2, m1, nb]
        t1 = np.stack([t.real, t.imag], axis=1).transpose(2, 1, 4, 3, 0)
        r5 = np.asarray(fused_filter_mid(jnp.asarray(np.ascontiguousarray(t1)),
                                         jnp.asarray(V), FusedFilterFactors(pf32, precision=prec)))
        return _c((r5[:, 0] + 1j * r5[:, 1]).transpose(3, 0, 2, 1))     # [nb, n3, m1, m2]

    out["local_plane"] = plane(*plane_inputs(1, m_shape, n), "highest")
    t6, V6 = plane_inputs(6, m_shape, n)
    out["local_plane_bf16"] = {p: plane(t6, V6, p) for p in ("default", "highest")}
    m1, m2, m3 = m_shape
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(1, PLANE_NB, m1, m2, m3))
         + 1j * rng.normal(size=(1, PLANE_NB, m1, m2, m3))).astype(np.complex64)
    # dot_z's layout: [k, 2 m3 (z, re/im), m2, m1, nb]
    X = np.stack([x.real, x.imag], axis=-1).transpose(0, 4, 5, 3, 2, 1)
    X = jnp.asarray(np.ascontiguousarray(X).reshape(1, 2 * m3, m2, m1, PLANE_NB))
    out["dot_z"] = {}
    for prec in ("default", "highest"):
        y = np.asarray(dot_z(FusedFilterFactors(pf32, precision=prec).f3f, X, prec))
        y = y.reshape(1, n[2], 2, m2, m1, PLANE_NB)
        out["dot_z"][prec] = _c((y[:, :, 0] + 1j * y[:, :, 1]).transpose(0, 4, 1, 3, 2))
    return out


if __name__ == "__main__":
    name = sys.argv[1]
    t0 = time.time()
    values = globals()["entry_" + name]()
    values["description"] = " ".join(globals()["entry_" + name].__doc__.split())
    values["cpu_seconds"] = time.time() - t0
    values["command"] = ("DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python "
                         f"tests/data/make_torch_port_scf.py {name}")
    print(json.dumps({name: values}, default=float), flush=True)
