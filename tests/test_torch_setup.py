"""dftk_tpu_torch's basis and terms setup against the JAX package.

Si2 at Ecut 7, fft_size (18,18,18), MonkhorstPack((2,2,2)), no symmetry.
The index arrays are equal; the terms data agree to 1e-12.
"""
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dftk_tpu as dftk
from dftk_tpu.ops.density import guess_density as jax_guess_density
from dftk_tpu.ops.engine_split import build_pruned_fft as jax_build_pruned_fft

import dftk_tpu_torch as dt
from dftk_tpu_torch.interop import basis_arrays_from_numpy

A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])


def _si2(pkg, **kw):
    Si = pkg.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = pkg.model_DFT(SI_LATTICE, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                          functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    return pkg.PlaneWaveBasis(model, Ecut=7.0, kgrid=pkg.MonkhorstPack((2, 2, 2)),
                              fft_size=(18, 18, 18), **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def bases():
    return _si2(dftk), _si2(dt, device="cpu")


def test_basis_arrays_equal(bases):
    jb, tb = bases
    assert tb.fft_size == jb.fft_size and tb.nG_max == jb.nG_max
    np.testing.assert_array_equal(tb.kcoords, jb.kcoords)
    np.testing.assert_array_equal(tb.kweights, jb.kweights)
    np.testing.assert_array_equal(tb.G_cube_cart, jb.G_cube_cart)
    # the JAX arrays carried over by interop equal the port's own tensors
    jd, jt = jb.data, jb.terms.data
    bd, td = basis_arrays_from_numpy(
        Gidx=jd.Gidx, mask=jd.mask, kin=jd.kin, Gpk_cart=jd.Gpk_cart,
        kweights=jd.kweights, kspin=jd.kspin, vloc_static=jt.vloc_static,
        hartree_coeffs=jt.hartree_coeffs, P=jt.P, D=jt.D, Gsq_cart=jt.Gsq_cart,
        device="cpu")
    for name in ("Gidx", "mask", "kin", "Gpk_cart", "kweights", "kspin"):
        torch.testing.assert_close(getattr(tb.data, name), getattr(bd, name),
                                   rtol=0, atol=0, msg=name)


def test_pruned_maps_equal(bases):
    jb, tb = bases
    pf = jax_build_pruned_fft(jb, dtype=jnp.float64)
    assert tb.pruned.m_shape == tuple(F.shape[0] for F in pf.Ff)
    np.testing.assert_array_equal(tb.pruned.Gidx_c.numpy(), np.asarray(pf.Gidx_c))
    np.testing.assert_array_equal(tb.pruned.inv_idx.numpy(), np.asarray(pf.inv_idx))


def test_terms_agree(bases):
    jb, tb = bases
    jt, tt = jb.terms, tb.terms
    for name, a, b in (("vloc", tt.data.vloc_static, jt.data.vloc_static),
                       ("hartree", tt.data.hartree_coeffs, jt.data.hartree_coeffs),
                       ("P", tt.data.P, jt.data.P), ("D", tt.data.D, jt.data.D)):
        assert np.max(np.abs(a.numpy() - np.asarray(b))) < 1e-12, name
    assert abs(tt.E_ewald - jt.E_ewald) < 1e-12
    assert abs(tt.E_psp_correction - jt.E_psp_correction) < 1e-12


def test_guess_density_agrees(bases):
    jb, tb = bases
    rho = dt.guess_density(tb)
    assert rho.shape == (1, 18, 18, 18) and rho.dtype == torch.float64
    assert np.max(np.abs(rho.numpy() - np.asarray(jax_guess_density(jb)))) < 1e-12


def test_basis_dtype_and_device(bases):
    _, tb = bases
    b32 = _si2(dt, dtype=torch.complex64, device="cpu")
    assert b32.data.kin.dtype == torch.float32
    assert b32.terms.data.P.dtype == torch.complex64
    assert b32.pruned.factors.fwd[0].dtype == torch.complex64
    assert all(t.device.type == "cpu" for t in tb.data)


def test_identity_symmetry_list_accepted():
    """An explicit list of operations (the JAX package's or the port's) is
    taken as given, as the JAX package's model takes it."""
    from dftk_tpu.symmetry import SymOp as JaxSymOp
    from dftk_tpu_torch.models.model import SymOp
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = dt.model_DFT(SI_LATTICE, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                         functionals=["lda_x"], symmetries=[JaxSymOp.identity()])
    assert model.symmetries == [SymOp.identity()]
    inversion = SymOp(W=((-1, 0, 0), (0, -1, 0), (0, 0, -1)), w=(0.0, 0.0, 0.0))
    model = dt.model_DFT(SI_LATTICE, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8],
                         functionals=["lda_x"], symmetries=[inversion])
    assert model.symmetries == [inversion]


@pytest.mark.parametrize("what", ["symmetries", "upf", "term", "functional"])
def test_unported_features_raise(what):
    """What the port refuses: terms it does not have (exact exchange, item
    11).  The other cases check what was refused before and now runs:
    symmetry detection with magnetic moments (item 8a) splits the atoms by
    moment as the JAX package does; a UPF file (item 8b) loads as the JAX
    package's PspUpf, and a meta-GGA functional (item 8b) instantiates
    with its tau data (tests/test_torch_upf.py and test_torch_mgga.py hold
    them against the JAX package)."""
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    args = (SI_LATTICE, [Si, Si], [np.ones(3) / 8, -np.ones(3) / 8])
    if what == "symmetries":
        model = dt.model_DFT(*args, functionals=["lda_x"], symmetries=True,
                             magnetic_moments=[1.0, -1.0])
        ref = dftk.model_DFT(*args, functionals=["lda_x"], symmetries=True,
                             magnetic_moments=[1.0, -1.0])
        assert model.spin_polarization == "collinear"
        assert len(model.symmetries) == len(ref.symmetries) == 24
        return
    if what == "upf":
        path = str(pathlib.Path(__file__).parent / "data" / "pseudos" / "gth" / "Si.pbe-hgh.upf")
        psp = dt.ElementPsp.from_symbol("Si", psp=path).psp
        ref = dftk.ElementPsp.from_symbol("Si", psp=path).psp
        assert isinstance(psp, dt.PspUpf) and psp.Zion == ref.Zion == 4
        assert psp.lmax == ref.lmax and psp.h == ref.h and psp.rgrid == ref.rgrid
        return
    if what == "functional":
        model = dt.model_DFT(*args, functionals=["mgga_x_scan"], symmetries=False)
        basis = dt.PlaneWaveBasis(model, Ecut=3.0, fft_size=(9, 9, 9), device="cpu")
        assert basis.terms.needs_tau and basis.terms.tau_core_np is None
        return
    with pytest.raises(NotImplementedError):
        model = dt.model_DFT(*args, functionals=["lda_x"], symmetries=False,
                             extra_terms=[dftk.ExactExchange()])
        dt.PlaneWaveBasis(model, Ecut=3.0, fft_size=(9, 9, 9), device="cpu")


@pytest.mark.parametrize("name", ["NoSmearing", "FermiDirac", "Gaussian",
                                  "MarzariVanderbilt", "MethfesselPaxton"])
def test_smearing_matches(name):
    from dftk_tpu.models import smearing as jax_smearing
    from dftk_tpu_torch.models import smearing
    x = np.linspace(-6.0, 6.0, 49)
    ref, port = getattr(jax_smearing, name)(), getattr(smearing, name)()
    xt = torch.as_tensor(x)
    for f in ("occupation", "entropy"):
        out = getattr(port, f)(xt).numpy()
        assert np.max(np.abs(out - np.asarray(getattr(ref, f)(jnp.asarray(x))))) < 1e-12, f


def test_grid_maps_match(bases):
    from dftk_tpu.ops import fft as jax_fft
    from dftk_tpu_torch.ops import fft
    jb, tb = bases
    G = np.random.default_rng(4).integers(-12, 13, size=(200, 3))
    np.testing.assert_array_equal(fft.index_G_vectors(tb.fft_size, G),
                                  jax_fft.index_G_vectors(jb.fft_size, G))
    rng = np.random.default_rng(5)
    c = rng.normal(size=(tb.n_kpoints, 2, tb.nG_max)) \
        + 1j * rng.normal(size=(tb.n_kpoints, 2, tb.nG_max))
    cube = fft.scatter_to_cube(torch.as_tensor(c), tb.data.Gidx, tb.data.mask, tb.fft_size)
    for k in range(tb.n_kpoints):
        ref = jax_fft.scatter_to_cube(jnp.asarray(c[k]), jb.data.Gidx[k],
                                      jb.data.mask[k], jb.fft_size)
        np.testing.assert_array_equal(cube[k].numpy(), np.asarray(ref))
    back = fft.gather_from_cube(cube, tb.data.Gidx, tb.data.mask).numpy()
    np.testing.assert_array_equal(back, c * tb.mask_np[:, None, :])
