"""Cells shared by the port's UPF and meta-GGA tests (tests/test_torch_upf.py,
tests/test_torch_mgga.py), built once per process in both packages.

Diamond C2 from the ONCVPSP meta-GGA file C_m.upf (NLCC with PP_TAUMOD)
under SCAN, atom 0 displaced, Ecut 10, fft 18, Gamma, the default
symmetries: the problem of tests/data/make_torch_port_mgga.py's
`c2_scan_nlcc_derivatives` entry and chip_smoke.py phase l3.  The JAX
package's basis is built without the Ewald term, whose jit-compiled
set-up alone takes most of these tests' budget; the terms they compare
do not depend on it.
"""
import functools
import pathlib

import numpy as np

PSEUDOS = pathlib.Path(__file__).parent / "data" / "pseudos"
C_UPF = str(PSEUDOS / "C_m.upf")
C_LATTICE = 6.74 / 2 * np.array([[0.0, 1, 1], [1, 0, 1], [1, 1, 0]])
C_POSITIONS = [np.ones(3) / 8, -np.ones(3) / 8]
C_DISPLACED = [np.array([0.128, 0.124, 0.122]), -np.ones(3) / 8]


def carbon_basis(pkg, positions, functionals="SCAN", **kw):
    C = pkg.ElementPsp.from_symbol("C", psp=C_UPF)
    model = pkg.model_DFT(C_LATTICE, [C, C], positions, functionals=functionals)
    return pkg.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1), fft_size=(18, 18, 18), **kw)


@functools.lru_cache(maxsize=None)
def displaced_carbon():
    """(JAX basis without Ewald, port basis on the CPU) of the displaced C2."""
    import dftk_tpu as dftk
    import dftk_tpu_torch as dt
    C = dftk.ElementPsp.from_symbol("C", psp=C_UPF)
    terms = [dftk.Kinetic(), dftk.AtomicLocal(), dftk.AtomicNonlocal(), dftk.PspCorrection(),
             dftk.Hartree(), dftk.Xc(("mgga_x_scan",))]
    model = dftk.Model(C_LATTICE, [C, C], C_DISPLACED, term_types=terms)
    jax_basis = dftk.PlaneWaveBasis(model, Ecut=10.0, kgrid=(1, 1, 1), fft_size=(18, 18, 18))
    return jax_basis, carbon_basis(dt, C_DISPLACED, device="cpu")
