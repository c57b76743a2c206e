"""dftk_tpu_torch's model-Hamiltonian terms: their instantiation against
the JAX package.

Torch at one thread, float64, on the CPU, against the JAX package's values
recorded in tests/data/torch_port_terms.json (each entry's `command`
reruns tests/data/make_torch_port_terms.py, whose cell constructors this
file imports), within 1e-12 of max(1, max|value|):
  * the static local potential of ExternalFromReal, ExternalFromFourier and
    ExternalFromValues on a cubic cell;
  * the explicit kinetic of BlowupCHV and BlowupAbinit on Si2 and of
    Kinetic(scaling_factor=2) on the anyon cell, and the JAX values carried
    into a Ham through `interop.basis_arrays_from_numpy`;
  * the Magnetic vector potential on the Fock-Darwin cell and the Anyonic
    reference fields rho_ref and Aref (fingerprints of the tables);
  * the PairwisePotential's (Lennard-Jones between Si) energy and forces;
and ExternalFromValues' shape check.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.interop import basis_arrays_from_numpy
from dftk_tpu_torch.ops import hamiltonian as H

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_terms", DATA / "make_torch_port_terms.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
with open(DATA / "torch_port_terms.json") as _f:
    REF = json.load(_f)
BAR = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


def close(out, ref, bar=BAR):
    """max|out - ref| < bar max(1, max|ref|); returns the difference."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    err = float(np.max(np.abs(out - ref)))
    assert err < bar * max(1.0, float(np.max(np.abs(ref)))), err
    return err


def summary_close(table, ref, bar=BAR):
    got = make.table_summary(table)
    assert got["size"] == ref["size"]
    for key in ("first", "sum", "wsum", "sample"):
        close(got[key], ref[key], bar)


def interop_arrays(basis, **kw):
    """A basis' own arrays through `interop.basis_arrays_from_numpy` (the
    way JAX arrays enter the port), with the extra fields kw."""
    td = basis.terms.data
    return basis_arrays_from_numpy(
        Gidx=basis.Gidx_np, mask=basis.mask_np, kin=basis.kin_np, Gpk_cart=basis.Gpk_cart_np,
        kweights=basis.kweights, kspin=basis.kspin, vloc_static=td.vloc_static,
        hartree_coeffs=td.hartree_coeffs, P=td.P, D=td.D, Gsq_cart=td.Gsq_cart,
        kinetic_scale=td.kinetic_scale, device="cpu", **kw)


def test_external_potentials():
    """vloc of the three External* forms."""
    for name, basis in make.external_bases(dt, device="cpu").items():
        close(basis.terms.data.vloc_static.numpy(), REF["setup"]["vloc"][name])


def test_kinetic_blowups():
    """The explicit kinetic of the blow-ups; a kinetic scaling stays in
    kinetic_scale, and the kinetic the Ham reads matches the JAX package's
    explicit one; the identity blow-up and no scaling leave none (the bare
    |k+G|^2 / 2)."""
    ref = REF["setup"]["kin"]
    for name, bl in (("chv", dt.BlowupCHV()), ("abinit", dt.BlowupAbinit())):
        basis = make.si2_basis(dt, blowup=bl, device="cpu")
        close(basis.terms.data.kin.numpy(), ref[name])
        assert np.array_equal(basis.terms.kin_np, basis.terms.data.kin.numpy())
        bd, td = interop_arrays(basis, kin_explicit=ref[name])
        ham = H.build_ham(bd, td, td.vloc_static[None], basis.pruned)
        assert np.array_equal(ham.kin.numpy(), np.array(ref[name]))
    anyon = make.anyon_basis(dt, device="cpu")
    assert anyon.terms.data.kin is None and anyon.terms.data.kinetic_scale == 2.0
    close(H.kinetic(anyon.data, anyon.terms.data).numpy(), ref["scaled"])
    assert make.si2_basis(dt, blowup=dt.BlowupIdentity(), device="cpu").terms.data.kin is None
    model = dt.model_DFT(make.SI_LATTICE, [], [], kinetic_blowup=dt.BlowupCHV())
    assert model.term_types[0].blowup.__class__ is dt.BlowupCHV


def test_vector_potential_and_anyonic_fields():
    summary_close(make.fock_darwin_basis(dt, Ecut=10.0, device="cpu").terms.data.Apot.numpy(),
                  REF["setup"]["Apot"])
    basis = make.anyon_basis(dt, device="cpu")
    ref = REF["setup"]["anyonic"]
    assert list(basis.fft_size) == ref["fft_size"]
    hbar, beta, rho_ref, Aref = basis.terms.anyonic
    assert (hbar, beta) == (1.0, make.ANYON_BETA)
    summary_close(rho_ref, ref["rho_ref"])
    summary_close(Aref, ref["Aref"])


def test_pairwise_energy_and_forces():
    """The Lennard-Jones term between the Si atoms: its energy and its
    autograd forces (reduced coordinates), at setup and from
    `ops/pairwise.py` directly."""
    from dftk_tpu_torch.ops.pairwise import energy_forces_pairwise, lennard_jones
    ref = REF["setup"]["pairwise"]
    terms = make.si2_basis(dt, pairwise=True, device="cpu").terms
    close(terms.E_pairwise, ref["E"])
    close(terms.pairwise_forces, ref["F"])
    Si = dt.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    E, F = energy_forces_pairwise(make.SI_LATTICE, [Si, Si], np.stack(make.SI2_DISPLACED),
                                  lennard_jones, make.LJ_PARAMS, make.LJ_RADIUS)
    close(float(E), ref["E"])
    close(F.numpy(), ref["F"])


def test_external_from_values_shape_check():
    model = dt.Model(np.eye(3) * 6.0, [], [], n_electrons=2, symmetries=False,
                     term_types=[dt.Kinetic(), dt.ExternalFromValues(np.zeros((14, 15, 15)))])
    with pytest.raises(ValueError, match="ExternalFromValues shape"):
        dt.PlaneWaveBasis(model, Ecut=5.0, fft_size=(15, 15, 15), device="cpu")
