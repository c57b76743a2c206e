"""Stresses of a split-SCF result.

Port of the API of `dftk_tpu/ops/stresses_split.py::compute_stresses_split`.
The JAX package traces a realified energy in f32 on the TPU and adds the
density terms and a finite-difference Ewald and PspCorrection part on the
host in f64; on the card every term runs in float64 by autograd, so this
is an adapter: the split SCF's orbitals become complex psi
(`scf/energy_eval.py`) and go through
`postprocess/stresses.py::compute_stresses_cart`.
"""
import types

from ..postprocess.stresses import compute_stresses_cart
from ..scf.energy_eval import split_state_to_complex


def compute_stresses_split(basis, sd, U, occupation):
    """Cartesian stress tensor (Ha/bohr^3), a float64 tensor [3, 3] on the
    basis' device, of the split SCF's U [nk, nb, 2nG] and occupation
    [nk, nb].  sd (`prepare_split_data`) is taken for the reference's
    signature: the stresses need only the basis."""
    psi, occ = split_state_to_complex(basis, U, occupation)
    return compute_stresses_cart(types.SimpleNamespace(psi=psi, occupation=occ), basis)
