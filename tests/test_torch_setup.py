"""dftk_tpu_torch's basis and terms setup against the JAX package.

Si2 at Ecut 7, fft_size (18,18,18), MonkhorstPack((2,2,2)), no symmetry.
The index arrays are equal; the terms data agree to 1e-12.  The JAX
package's side is recorded in tests/data/torch_port_setup.json (entry
`setup`; its `command` reruns tests/data/make_torch_port_setup.py):
the index and mask arrays and the pruned maps whole, the larger float
tables as fingerprints (first value, sum, a seeded weighted sum and
seeded samples), so that this file runs no JAX code.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.interop import basis_arrays_from_numpy

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_setup", DATA / "make_torch_port_setup.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
with open(DATA / "torch_port_setup.json") as _f:
    REF = json.load(_f)["setup"]
SI_LATTICE = make.SI_LATTICE


def summary_close(got, want, bar):
    """got (an array) against a recorded table_summary: each value within
    bar of the table's largest recorded magnitude, so the sums within
    that times the table's size (bar 0: exactly)."""
    g = make.table_summary(got)
    tol = bar * max(max(abs(v) for v in want["sample"]), abs(want["first"]))
    assert g["size"] == want["size"]
    assert abs(g["first"] - want["first"]) <= tol
    assert abs(g["sum"] - want["sum"]) <= tol * g["size"]
    assert abs(g["wsum"] - want["wsum"]) <= tol * g["size"]
    assert np.abs(np.array(g["sample"]) - want["sample"]).max() <= tol


def _si2(pkg, **kw):
    return make.si2_basis(pkg, **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


@pytest.fixture(scope="module")
def bases():
    return None, _si2(dt, device="cpu")


def test_basis_arrays_equal(bases):
    _, tb = bases
    f = make.from_b64
    assert list(tb.fft_size) == REF["fft_size"] and tb.nG_max == REF["nG_max"]
    np.testing.assert_array_equal(tb.kcoords, f(REF["kcoords"]))
    np.testing.assert_array_equal(tb.kweights, f(REF["kweights"]))
    summary_close(tb.G_cube_cart, REF["G_cube_cart"], 0.0)
    # the JAX arrays carried over by interop equal the port's own tensors
    jd, tt = {k: f(v) for k, v in REF["data"].items()}, tb.terms.data
    bd, td = basis_arrays_from_numpy(
        **jd, vloc_static=tt.vloc_static.numpy(), hartree_coeffs=tt.hartree_coeffs.numpy(),
        P=tt.P.numpy(), D=tt.D.numpy(), Gsq_cart=tt.Gsq_cart.numpy(), device="cpu")
    for name in ("Gidx", "mask", "kin", "Gpk_cart", "kweights", "kspin"):
        torch.testing.assert_close(getattr(tb.data, name), getattr(bd, name),
                                   rtol=0, atol=0, msg=name)


def test_pruned_maps_equal(bases):
    _, tb = bases
    assert list(tb.pruned.m_shape) == REF["m_shape"]
    np.testing.assert_array_equal(tb.pruned.Gidx_c.numpy(), make.from_b64(REF["Gidx_c"]))
    np.testing.assert_array_equal(tb.pruned.inv_idx.numpy(), make.from_b64(REF["inv_idx"]))


def test_terms_agree(bases):
    _, tb = bases
    tt, want = tb.terms, REF["terms"]
    P = tt.data.P.numpy()
    for name, a, ref in (("vloc", tt.data.vloc_static.numpy(), want["vloc"]),
                         ("hartree", tt.data.hartree_coeffs.numpy(), want["hartree"]),
                         ("P.re", P.real, want["P"]["re"]), ("P.im", P.imag, want["P"]["im"])):
        summary_close(a, ref, 1e-12)
    assert np.max(np.abs(tt.data.D.numpy() - make.from_b64(want["D"]))) < 1e-12
    assert abs(tt.E_ewald - want["E_ewald"]) < 1e-12
    assert abs(tt.E_psp_correction - want["E_psp_correction"]) < 1e-12


def test_guess_density_agrees(bases):
    _, tb = bases
    rho = dt.guess_density(tb)
    assert rho.shape == (1, 18, 18, 18) and rho.dtype == torch.float64
    summary_close(rho.numpy(), REF["guess_density"], 1e-12)


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
        assert model.spin_polarization == "collinear"
        assert len(model.symmetries) == REF["magnetic_symmetries"] == 24
        return
    if what == "upf":
        psp = dt.ElementPsp.from_symbol("Si", psp=make.SI_UPF).psp
        ref = REF["upf"]
        assert isinstance(psp, dt.PspUpf) and psp.Zion == ref["Zion"] == 4
        assert psp.lmax == ref["lmax"] and [np.asarray(h).tolist() for h in psp.h] == ref["h"]
        assert len(psp.rgrid) == ref["n_rgrid"]
        summary_close(np.asarray(psp.rgrid), ref["rgrid"], 0.0)
        return
    if what == "functional":
        model = dt.model_DFT(*args, functionals=["mgga_x_scan"], symmetries=False)
        basis = dt.PlaneWaveBasis(model, Ecut=3.0, fft_size=(9, 9, 9), device="cpu")
        assert basis.terms.needs_tau and basis.terms.tau_core_np is None
        return
    import dftk_tpu as dftk      # the JAX package's term, constructed only
    with pytest.raises(NotImplementedError):
        model = dt.model_DFT(*args, functionals=["lda_x"], symmetries=False,
                             extra_terms=[dftk.ExactExchange()])
        dt.PlaneWaveBasis(model, Ecut=3.0, fft_size=(9, 9, 9), device="cpu")


@pytest.mark.parametrize("name", ["NoSmearing", "FermiDirac", "Gaussian",
                                  "MarzariVanderbilt", "MethfesselPaxton"])
def test_smearing_matches(name):
    from dftk_tpu_torch.models import smearing
    port = getattr(smearing, name)()
    xt = torch.as_tensor(make.SMEARING_X)
    for f in ("occupation", "entropy"):
        out = getattr(port, f)(xt).numpy()
        assert np.max(np.abs(out - np.array(REF["smearing"][name][f]))) < 1e-12, f


def test_grid_maps_match(bases):
    from dftk_tpu_torch.ops import fft
    _, tb = bases
    G, c = make.grid_inputs(tb)
    np.testing.assert_array_equal(fft.index_G_vectors(tb.fft_size, G),
                                  make.from_b64(REF["index_G"]))
    cube = fft.scatter_to_cube(torch.as_tensor(c), tb.data.Gidx, tb.data.mask, tb.fft_size)
    for k in range(tb.n_kpoints):
        ref = REF["cubes"][k]
        summary_close(cube[k].real.numpy(), ref["re"], 0.0)
        summary_close(cube[k].imag.numpy(), ref["im"], 0.0)
    back = fft.gather_from_cube(cube, tb.data.Gidx, tb.data.mask).numpy()
    np.testing.assert_array_equal(back, c * tb.mask_np[:, None, :])
