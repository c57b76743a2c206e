"""Elastic constants: C = d sigma / d strain (Voigt 6x6) by finite differences.

Port of `dftk_tpu/postprocess/elastic.py` (the reference differentiates
the stress through the SCF fixed point, DFTK `src/postprocess/elastic.jl`):
central finite differences of the autodiff stress over strained,
re-converged SCF solutions (clamped ion).  `postprocess/elastic_response.py`
is the DFPT route this one checks.
"""
import numpy as np

from .elastic_response import _VOIGT, _strain_mat


def elastic_tensor(make_basis, lattice0, scf_kwargs=None, eps=1e-4, components=None):
    """Clamped-ion elastic tensor C_ab (Voigt, Ha/bohr^3, numpy); only the
    columns b in `components` (default all six) are computed.

    make_basis(lattice) -> PlaneWaveBasis (positions fixed in fractional
    coordinates - clamped ion)."""
    from ..scf.driver import self_consistent_field
    from .stresses import compute_stresses_cart
    scf_kwargs = dict(scf_kwargs or {})
    scf_kwargs.setdefault("tol", 1e-10)
    lattice0 = np.asarray(lattice0, dtype=float)
    components = list(range(6) if components is None else components)

    def stress_at(strain):
        res = self_consistent_field(make_basis((np.eye(3) + strain) @ lattice0), **scf_kwargs)
        return compute_stresses_cart(res).cpu().numpy()

    C = np.zeros((6, 6))
    for b in components:
        dsig = (stress_at(eps * _strain_mat(b)) - stress_at(-eps * _strain_mat(b))) / (2 * eps)
        for a, (i, j) in enumerate(_VOIGT):
            C[a, b] = dsig[i, j]
    if len(components) == 6:
        C = (C + C.T) / 2
    return C


def bulk_modulus(C):
    """Voigt-average bulk modulus from the elastic tensor (Ha/bohr^3)."""
    return (C[0, 0] + C[1, 1] + C[2, 2] + 2 * (C[0, 1] + C[0, 2] + C[1, 2])) / 9
