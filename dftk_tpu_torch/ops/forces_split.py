"""Forces of a split-SCF result.

Port of the API of `dftk_tpu/ops/forces_split.py::compute_forces_split`.
The JAX package differentiates a realified energy in f32 on the TPU and
adds the local and Ewald terms on the host in f64; on the card every term
runs in float64, so this is an adapter: the split SCF's orbitals (rows
[x; y] per complex band) become complex psi (`scf/energy_eval.py`) and go
through `postprocess/forces.py::compute_forces`.
"""
import types

from ..postprocess.forces import compute_forces
from ..scf.energy_eval import split_state_to_complex


def compute_forces_split(basis, sd, U, occupation, rho):
    """Forces in reduced coordinates, a float64 tensor [n_atoms, 3] on the
    basis' device, of the split SCF's U [nk, nb, 2nG], occupation [nk, nb]
    and density rho.  sd (`prepare_split_data`) is taken for the
    reference's signature: the forces need only the basis."""
    psi, occ = split_state_to_complex(basis, U, occupation)
    return compute_forces(types.SimpleNamespace(psi=psi, occupation=occ, rho=rho),
                          basis)
