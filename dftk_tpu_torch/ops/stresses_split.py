"""Stresses of a split-SCF result.

Port of the API of `dftk_tpu/ops/stresses_split.py`.  The JAX package
traces a realified energy in f32 on the TPU and adds the density terms and
a finite-difference Ewald and PspCorrection part on the host in f64; on
the card every term runs in float64 by autograd, so these are adapters
over the complex path: `compute_stresses_split` turns the split SCF's
orbitals into complex psi (`scf/energy_eval.py`) and calls
`postprocess/stresses.py::compute_stresses_cart`, and
`energy_at_lattice_split` evaluates `postprocess/stresses.py::
lattice_energy` on the complex view of its realified orbitals.
`SplitStressData` and `prepare_stress_data` keep the reference's
lattice-independent arrays (reduced G, structure factors) for the callers
that pass them around; nothing in the port computes with them (ROADMAP
lists them among the parity-only names).
"""
import types
from typing import NamedTuple

import numpy as np
import torch

from ..models.elements import ElementPsp
from ..postprocess.stresses import compute_stresses_cart, lattice_energy, refuse_unstrained_terms
from ..scf.energy_eval import split_state_to_complex
from .terms import count_n_proj


class SplitStressData(NamedTuple):
    """Static (lattice-independent) arrays of the split stress energy."""
    Gred_cube: torch.Tensor      # [n1, n2, n3, 3] reduced cube G (float)
    Gred_pk: torch.Tensor        # [nk, nG, 3] reduced k+G
    sf_loc: tuple                # per local group: [M, 2] summed structure factor
    sf_nl: tuple                 # per psp group: [natoms_in_group, nk, nG, 2]
    Gidx: torch.Tensor
    mask: torch.Tensor
    kspin: torch.Tensor
    kweights: torch.Tensor


def prepare_stress_data(basis, dtype=torch.float64):
    """The reference's `SplitStressData` of the basis, real tensors of
    `dtype` on the basis' device (structure factors as (re, im) pairs)."""
    model = basis.model

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=basis.device).to(dt)

    Gred_flat = basis.G_cube.reshape(-1, 3).astype(np.float64)
    sf_loc = []
    for group in model.atom_groups:
        if not hasattr(model.atoms[group[0]], "local_potential_fourier"):
            continue
        sf = sum(np.exp(-2j * np.pi * (Gred_flat @ model.positions[i])) for i in group)
        sf_loc.append(t(np.stack([sf.real, sf.imag], -1)))
    Gred_pk = basis.Gred_np.astype(np.float64) + basis.kcoords_spin[:, None, :]
    sf_nl = []
    for group in model.atom_groups:
        el = model.atoms[group[0]]
        if not (isinstance(el, ElementPsp) and count_n_proj(el.psp) > 0):
            continue
        sfs = [np.exp(-2j * np.pi * (Gred_pk @ model.positions[i])) for i in group]
        sf_nl.append(t(np.stack([np.stack([s.real, s.imag], -1) for s in sfs])))
    return SplitStressData(
        Gred_cube=t(basis.G_cube.astype(np.float64)), Gred_pk=t(Gred_pk),
        sf_loc=tuple(sf_loc), sf_nl=tuple(sf_nl),
        Gidx=t(basis.Gidx_np, torch.int64), mask=t(basis.mask_np),
        kspin=t(basis.kspin, torch.int64), kweights=t(basis.kweights))


def energy_at_lattice_split(basis, st: SplitStressData, xy, wocc, lattice,
                            symmetrizer=None, include="all"):
    """Total energy minus Ewald, PspCorrection and Entropy as a
    differentiable function of the lattice [3, 3] (float64 tensor), at
    fixed split orbitals xy [nk, nb, nG, 2] and weighted occupations wocc =
    w_k f_kn [nk, nb].  symmetrizer: applied to the density rebuilt from xy
    (`make_symmetrizer_split`; None: none).  include: "all", "psi" (kinetic
    and nonlocal) or "density" (local, Hartree, XC).  st is taken for the
    reference's signature."""
    refuse_unstrained_terms(basis.model, "energy_at_lattice_split")
    psi = torch.view_as_complex(torch.as_tensor(xy, device=basis.device)
                                .to(torch.float64).contiguous())
    pos = torch.as_tensor(np.stack(basis.model.positions), dtype=torch.float64,
                          device=basis.device)
    return lattice_energy(basis, psi, wocc, lattice, pos, symmetrizer, include)


def compute_stresses_split(basis, sd, U, occupation):
    """Cartesian stress tensor (Ha/bohr^3), a float64 tensor [3, 3] on the
    basis' device, of the split SCF's U [nk, nb, 2nG] and occupation
    [nk, nb].  sd (`prepare_split_data`) is taken for the reference's
    signature: the stresses need only the basis."""
    psi, occ = split_state_to_complex(basis, U, occupation)
    return compute_stresses_cart(types.SimpleNamespace(psi=psi, occupation=occ), basis)
