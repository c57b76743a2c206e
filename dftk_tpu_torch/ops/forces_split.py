"""Forces of a split-SCF result.

Port of the API of `dftk_tpu/ops/forces_split.py`.  The JAX package
differentiates a realified energy in f32 on the TPU and adds the local and
Ewald terms on the host in f64; on the card every term runs in float64,
so `compute_forces_split` is an adapter: the split SCF's orbitals (rows
[x; y] per complex band) become complex psi (`scf/energy_eval.py`) and go
through `postprocess/forces.py::compute_forces`.  `SplitForceData` and
`prepare_force_data` keep the reference's position-independent arrays
(form factors, integer G) for the callers that pass them around; nothing
in the port computes with them.
"""
import types
from typing import NamedTuple

import numpy as np
import torch

from ..postprocess.forces import _projector_form_factors, compute_forces, psp_groups
from ..scf.energy_eval import split_state_to_complex


class SplitForceData(NamedTuple):
    """Static per-basis arrays of the reference's split force energy (all
    real, on the basis' device)."""
    Gred_cube: torch.Tensor     # [M, 3] reduced G of the full fft cube
    ff_loc: tuple               # per atom group: [M] real local form factor
    loc_groups: tuple           # per atom group: atom index tuple
    Gint_pk: torch.Tensor       # [nk, nG, 3] integer reduced G per k-point
    kred: torch.Tensor          # [nk, 3] reduced k (fractional part of k+G)
    ff_nl: tuple                # per psp group: [nk, nG, npp, 2] (re, im)
    D_nl: tuple                 # per psp group: [npp, npp]
    nl_groups: tuple            # per psp group: atom index tuple
    ff_core: tuple              # per NLCC atom group: [M] core form factor
    core_groups: tuple          # matching atom index tuples


def prepare_force_data(basis, dtype=torch.float64):
    """The position-independent form factors of the local potential, the
    nonlocal projectors (no structure factor, zero on the padding, as
    `postprocess/forces.py::_projector_form_factors`) and the NLCC core
    densities, and the integer G, as real tensors of `dtype`."""
    model = basis.model
    Gnorm_cube = basis.G_cube_cart_norm.reshape(-1)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=float), device=basis.device).to(dtype)

    def groups(has):
        return [g for g in model.atom_groups if has(model.atoms[g[0]])]

    loc = groups(lambda el: hasattr(el, "local_potential_fourier"))
    core = groups(lambda el: getattr(el, "has_core_density", lambda: False)())
    nl = psp_groups(model)
    ff_nl, D_nl = [], []
    for g in nl:
        ff, D = _projector_form_factors(basis, model.atoms[g[0]].psp)
        ff_nl.append(torch.stack([ff.real, ff.imag], dim=-1).to(dtype))
        D_nl.append(D.to(dtype))
    return SplitForceData(
        Gred_cube=t(basis.G_cube.reshape(-1, 3)),
        ff_loc=tuple(t(model.atoms[g[0]].local_potential_fourier(Gnorm_cube)) for g in loc),
        loc_groups=tuple(tuple(int(a) for a in g) for g in loc),
        Gint_pk=t(basis.Gred_np), kred=t(basis.kcoords_spin),
        ff_nl=tuple(ff_nl), D_nl=tuple(D_nl), nl_groups=tuple(tuple(int(a) for a in g) for g in nl),
        ff_core=tuple(t(model.atoms[g[0]].core_density_fourier(Gnorm_cube)) for g in core),
        core_groups=tuple(tuple(int(a) for a in g) for g in core))


def compute_forces_split(basis, sd, U, occupation, rho):
    """Forces in reduced coordinates, a float64 tensor [n_atoms, 3] on the
    basis' device, of the split SCF's U [nk, nb, 2nG], occupation [nk, nb]
    and density rho.  sd (`prepare_split_data`) is taken for the
    reference's signature: the forces need only the basis."""
    psi, occ = split_state_to_complex(basis, U, occupation)
    return compute_forces(types.SimpleNamespace(psi=psi, occupation=occ, rho=rho), basis)
