"""The JAX package's CPU float64 values that tests/data/torch_port_helpers.json
records for the port's public helpers (tests/test_torch_helpers.py): the
lattice and k-grid utilities, ylm_real, the cube and sphere FFTs,
count_n_proj, the split engine's transforms and sandwich, and the split
stress energy.

    PYTHONPATH=. DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python tests/data/make_torch_port_helpers.py ENTRY

prints one JSON line: the entry's values, its `command` and its CPU
seconds.  Run from the repository root.  The inputs come from the numpy
constructors below (seeded, no JAX), which tests/test_torch_helpers.py
imports, so both packages see the same arrays.  Large results are kept as
fingerprints (`summary`).  This script imports the JAX package, so it
lives outside both packages.
"""
import json
import sys
import time

import numpy as np

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
SI_POSITIONS = [np.ones(3) / 8, -np.ones(3) / 8]
SI_KPOINTS = ([[0, 0, 0], [1 / 3, 0, 0], [1 / 3, 1 / 3, 0], [-1 / 3, 1 / 3, 0]],
              [1 / 27, 8 / 27, 6 / 27, 12 / 27])
SKEW = np.array([[4.1, 0.3, -0.2], [0.1, 5.2, 0.4], [-0.3, 0.2, 6.3]])
VECTORS = np.array([[0.3, -0.7, 1.1], [1.0, 0.0, 0.0], [-0.2, 0.5, 0.1]])
YLM_CASES = [(l, m) for l in range(4) for m in range(-l, l + 1)]
TOTAL_NUMBERS = (1, 8, 50, 64, 200)
N_BANDS = 4
STRAIN = 1e-3 * np.array([[1.0, 0.4, -0.3], [0.4, -2.0, 0.7], [-0.3, 0.7, 0.5]])


def si_setup_basis(dftk, functionals=("lda_x", "lda_c_vwn"), **kw):
    """tests/test_engine_split.py's si_setup: Si2 at Ecut 7 on the four
    explicit k-points, fft 18^3."""
    Si = dftk.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dftk.model_DFT(SI_LATTICE, [Si, Si], SI_POSITIONS, functionals=list(functionals))
    return dftk.PlaneWaveBasis(model, Ecut=7.0, kgrid=dftk.ExplicitKpoints(*SI_KPOINTS),
                               fft_size=(18, 18, 18), **kw)


def seeded(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


def split_orbitals(mask, n_bands, seed):
    """Orthonormal split orbitals [nk, n_bands, nG, 2], zero on the padding."""
    rng = np.random.default_rng(seed)
    shape = (mask.shape[0], n_bands, mask.shape[1])
    psi = (rng.normal(size=shape) + 1j * rng.normal(size=shape)) * mask[:, None, :]
    for k in range(psi.shape[0]):
        psi[k] = np.linalg.qr(psi[k].T)[0].T
    return np.stack([psi.real, psi.imag], -1)


def smooth_density(fft_size, n_spin=1):
    """A smooth positive density [n_spin, n1, n2, n3] of the grid."""
    r = np.stack(np.meshgrid(*[np.arange(n) / n for n in fft_size], indexing="ij"), -1)
    base = 0.05 * (2.0 + np.sin(2 * np.pi * r[..., 0]) * np.cos(2 * np.pi * r[..., 1])
                   + 0.5 * np.cos(2 * np.pi * (r[..., 2] - r[..., 0])))
    return np.stack([base * (1 + 0.1 * s) for s in range(n_spin)])


def tb09_tau(rho, tau_w):
    """A kinetic-energy density above the von Weizsaecker one: tau_W plus
    half the Thomas-Fermi tau of rho (either package's arrays)."""
    return tau_w + 0.5 * 2.871234 * rho ** (5 / 3)


def summary(a, n_sample=48):
    """A compact fingerprint of a real array: its shape, first element, sum,
    sum against seeded uniform weights and its values at seeded indices."""
    a = np.asarray(a, dtype=float)
    flat = a.ravel()
    rng = np.random.default_rng(flat.size)
    w = rng.uniform(size=flat.size)
    idx = rng.choice(flat.size, size=min(n_sample, flat.size), replace=False)
    return dict(shape=list(a.shape), first=float(flat[0]), sum=float(flat.sum()),
                wsum=float(w @ flat), sample=flat[idx].tolist())


def entry_utilities():
    """kgrid_from_total_number, the lattice converters and diameter on a
    skewed lattice, ylm_real, count_n_proj of Si and C."""
    import dftk_tpu as dftk
    from dftk_tpu.bzmesh import kgrid_from_total_number
    from dftk_tpu.ops.terms import count_n_proj
    from dftk_tpu.utils import lattice as lat
    from dftk_tpu.utils.special import ylm_real
    out = dict(kgrid={str(n): list(kgrid_from_total_number(SI_LATTICE, n).kgrid_size)
                      for n in TOTAL_NUMBERS})
    for name in ("vector_red_to_cart", "vector_cart_to_red", "covector_red_to_cart",
                 "covector_cart_to_red", "recip_vector_red_to_cart"):
        out[name] = np.asarray(getattr(lat, name)(SKEW, VECTORS.T)).tolist()
    out["compute_inverse_lattice"] = np.asarray(lat.compute_inverse_lattice(SKEW)).tolist()
    out["diameter"] = float(lat.diameter(SKEW))
    out["ylm_real"] = [[float(ylm_real(l, m, v)) for v in VECTORS] + [float(ylm_real(l, m,
                                                                                      np.zeros(3)))]
                       for l, m in YLM_CASES]
    out["count_n_proj"] = {el: int(count_n_proj(dftk.ElementPsp.from_symbol(el, psp=psp).psp))
                           for el, psp in (("Si", "lda/si-q4"), ("C", "lda/c-q4"))}
    return out


def entry_transforms():
    """On si_setup: the cube and sphere FFTs, the split scatter/gather, the
    pruned sphere <-> real-space transforms, build_sandwich and
    apply_local_sandwich on seeded inputs, and the pruned maps."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops import engine_split as es
    from dftk_tpu.ops import fft as fftops
    basis = si_setup_basis(dftk)
    n = basis.fft_size
    vol = basis.model.unit_cell_volume
    out = {}
    f = seeded((2,) + n, 1) + 1j * seeded((2,) + n, 2)
    out["ifft_cube"] = summary(np.asarray(fftops.ifft_cube(jnp.asarray(f), vol)).view(float))
    out["irfft_cube"] = summary(np.asarray(fftops.irfft_cube(jnp.asarray(f), vol)))
    out["fft_cube"] = summary(np.asarray(fftops.fft_cube(jnp.asarray(f.real), vol)).view(float))
    k = 1
    c = (seeded((3, basis.nG_max), 3) + 1j * seeded((3, basis.nG_max), 4)) * basis.mask_np[k]
    psir = fftops.ifft_sphere(jnp.asarray(c), jnp.asarray(basis.Gidx_np[k]),
                              jnp.asarray(basis.mask_np[k]), n, vol)
    out["ifft_sphere"] = summary(np.asarray(psir).view(float))
    out["fft_sphere"] = summary(np.asarray(fftops.fft_sphere(
        psir, jnp.asarray(basis.Gidx_np[k]), jnp.asarray(basis.mask_np[k]), vol)).view(float))

    xy = split_orbitals(basis.mask_np, N_BANDS, 5)
    Gidx, mask = jnp.asarray(basis.Gidx_np), jnp.asarray(basis.mask_np)
    cube = es.scatter_cube_split(jnp.asarray(xy), Gidx, mask, n)
    out["scatter_cube_split"] = summary(cube)
    out["gather_cube_split"] = summary(es.gather_cube_split(cube * 1.5 - 0.25, Gidx, mask))
    pf = es.build_pruned_fft(basis, dtype=jnp.float64)
    out["pruned"] = dict(m_shape=[int(F.shape[0]) for F in pf.Ff],
                         Gidx_c=np.asarray(pf.Gidx_c).tolist(),
                         inv_idx=summary(np.asarray(pf.inv_idx)),
                         Ff=[summary(F) for F in pf.Ff], Fb=[summary(F) for F in pf.Fb])
    real = es.sphere_to_real_pruned(jnp.asarray(xy), pf, mask)
    out["sphere_to_real_pruned"] = summary(real)
    out["real_to_sphere_pruned"] = summary(es.real_to_sphere_pruned(
        real * (1.0 + jnp.asarray(seeded(real.shape[:-1], 6))[..., None]), pf, mask, n))
    V = 0.3 * seeded((1,) + n, 7)
    M = es.build_sandwich(pf, jnp.asarray(V))
    out["build_sandwich"] = summary(M)
    m_shape = tuple(int(F.shape[0]) for F in pf.Ff)
    x = seeded((basis.n_kpoints, N_BANDS) + m_shape + (2,), 8)
    out["apply_local_sandwich"] = summary(es.apply_local_sandwich(
        jnp.asarray(x), pf, M, jnp.asarray(basis.kspin)))
    return out


def entry_densities():
    """von_weizsaecker_tau_split, tb09_potential_split and xc_energy_split
    (LDA on si_setup, PBE on its PBE twin, unpolarised and collinear) on
    the smooth density; energy_at_lattice_split on seeded orbitals at the
    lattice and a strained one, and its strain gradient."""
    import jax
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.ops import engine_split as es
    from dftk_tpu.ops.stresses_split import energy_at_lattice_split, prepare_stress_data
    basis = si_setup_basis(dftk)
    pbe = si_setup_basis(dftk, functionals=("gga_x_pbe", "gga_c_pbe"))
    G = jnp.asarray(basis.G_cube_cart)
    out = {}
    for ns in (1, 2):
        rho = jnp.asarray(smooth_density(basis.fft_size, ns))
        tau = es.von_weizsaecker_tau_split(rho, G)
        out[f"vw_tau_{ns}"] = summary(tau)
        out[f"tb09_{ns}"] = summary(es.tb09_potential_split(rho, G, tb09_tau(rho, tau)))
        out[f"xc_lda_{ns}"] = float(es.xc_energy_split(basis.terms.xc, rho, G,
                                                       basis.model.unit_cell_volume))
        out[f"xc_pbe_{ns}"] = float(es.xc_energy_split(pbe.terms.xc, rho, G,
                                                       pbe.model.unit_cell_volume, 0.7))
    st = prepare_stress_data(basis, dtype=jnp.float64)
    out["stress_data"] = dict(sf_loc=[summary(s) for s in st.sf_loc],
                              sf_nl=[summary(s) for s in st.sf_nl],
                              Gred_pk=summary(st.Gred_pk))
    xy = jnp.asarray(split_orbitals(basis.mask_np, N_BANDS, 9))
    wocc = jnp.asarray(basis.kweights)[:, None] * 2.0 * jnp.ones((1, N_BANDS))
    symm = es.make_symmetrizer_split(basis, jnp.float64)
    L0 = jnp.asarray(basis.model.lattice)
    L1 = (jnp.eye(3) + jnp.asarray(STRAIN)) @ L0
    for name, L in (("L0", L0), ("strained", L1)):
        for include in ("all", "psi", "density"):
            out[f"energy_{name}_{include}"] = float(energy_at_lattice_split(
                basis, st, xy, wocc, L, symmetrizer=symm, include=include))

    def f(eps):
        return energy_at_lattice_split(basis, st, xy, wocc, (jnp.eye(3) + (eps + eps.T) / 2) @ L0,
                                       symmetrizer=symm)

    out["strain_gradient"] = np.asarray(jax.jit(jax.grad(f))(jnp.zeros((3, 3)))).tolist()
    return out


if __name__ == "__main__":
    name = sys.argv[1]
    t0 = time.time()
    values = globals()["entry_" + name]()
    values["description"] = " ".join(globals()["entry_" + name].__doc__.split())
    values["cpu_seconds"] = time.time() - t0
    values["command"] = ("PYTHONPATH=. DFTK_TPU_X64=1 JAX_PLATFORMS=cpu python "
                         f"tests/data/make_torch_port_helpers.py {name}")
    print(json.dumps({name: values}, default=float), flush=True)
