"""Total-energy evaluation of a given state, and the refinement of split-SCF
results.

Port of `dftk_tpu/scf/energy_eval.py`.  The JAX package refines a chip-f32
state by re-evaluating its energy in f64 in a CPU subprocess; the port
evaluates in the basis' dtype (complex128 by default) on the basis' own
device, so the refine is one more f64 evaluation on the card.  The energy
is variational in (psi, rho): the state's error enters it only at second
order.  The JAX package's evaluation reports no PairwisePotential energy
and drops the Anyonic term, so a model with either raises here.
"""
import numpy as np
import torch

from ..ops import hamiltonian as hamops
from ..ops.density import compute_density, make_symmetrizer
from ..ops.occupation import entropy_energy
from ..ops.terms import refuse_anyonic, refuse_terms
from ..parallel.mesh import refuse_distributed


def evaluate_total_energy(basis, psi, occupation, eigenvalues=None, epsF=None,
                          rho=None, band_chunk=None):
    """Energies dict (incl. "total") of a fixed state in the basis' dtype.

    psi [nk, nb, nG] complex, occupation [nk, nb]; rho [nspin, grid] is
    re-derived from psi (band_chunk bands at a time) and symmetrized unless
    given.
    eigenvalues [nk, nb] and epsF feed the Entropy term of finite-temperature
    models, which is left out where either is None (as in the JAX
    package)."""
    refuse_distributed(basis, "evaluate_total_energy")
    model = basis.model
    terms = basis.terms
    refuse_anyonic(model, "evaluate_total_energy")
    refuse_terms(model, "evaluate_total_energy", ["PairwisePotential"],
                 "the JAX package's energy evaluation adds no pairwise energy "
                 "(dftk_tpu/scf/energy_eval.py:61-62)")
    bd = basis.data
    volume = model.unit_cell_volume
    psi = torch.as_tensor(psi, device=basis.device).to(basis.dtype)
    occupation = torch.as_tensor(occupation, device=basis.device).to(basis.rdtype)
    if rho is None:
        rho = compute_density(bd, psi, occupation, basis.fft_size, volume,
                              model.n_spin_components, band_chunk,
                              symmetrizer=make_symmetrizer(basis))
    else:
        rho = torch.as_tensor(rho, device=basis.device).to(basis.rdtype)
    V, _, energies = hamops.total_potential(terms, rho, volume)
    ham = hamops.build_ham(bd, terms.data, V, basis.pruned)
    energies.update(hamops.psi_energies(ham, psi, occupation, bd.kweights))
    if terms.has_entropy and eigenvalues is not None and epsF is not None:
        eig = torch.as_tensor(eigenvalues, device=basis.device).to(basis.rdtype)
        energies["Entropy"] = entropy_energy(eig, bd.kweights, epsF, model.temperature,
                                             model.smearing, model.filled_occupation)
    energies = {k: float(v) for k, v in energies.items()}
    energies["Ewald"] = float(terms.E_ewald)
    energies["PspCorrection"] = float(terms.E_psp_correction)
    energies["total"] = float(sum(energies.values()))
    return energies


def split_state_to_complex(basis, U, occupation, band_repr="complex"):
    """Split-SCF orbitals (rows [x; y], [nk, nb, 2nG]) -> complex psi
    [nk, nb, nG] with unit-norm bands and the per-band occupation, as
    tensors on the basis' device in its dtype."""
    if band_repr != "complex":
        raise NotImplementedError(
            f"band_repr={band_repr!r}: the realified band representations are "
            f"TPU workarounds the port does not carry (ROADMAP, 'Not to port')")
    U = torch.as_tensor(U, device=basis.device).to(basis.rdtype)
    occ = torch.as_tensor(occupation, device=basis.device).to(basis.rdtype)
    nG = U.shape[-1] // 2
    psi = torch.complex(U[..., :nG], U[..., nG:])
    nrm = torch.linalg.vector_norm(psi, dim=-1, keepdim=True)
    return psi / torch.clamp(nrm, min=1e-12), occ


def refine_split_energy(basis, split_res, band_repr="complex", band_chunk=None):
    """Energies of a split-SCF result dict, evaluated in the basis' dtype on
    its device."""
    psi, occ = split_state_to_complex(basis, split_res["U"],
                                      split_res["occupation"], band_repr)
    return evaluate_total_energy(basis, psi, occ,
                                 eigenvalues=split_res.get("eigenvalues"),
                                 epsF=split_res.get("epsF"), band_chunk=band_chunk)


def refine_split_state(basis, split_res, tol=1e-10, maxiter=12,
                       band_repr="complex", occupation_threshold=1e-8,
                       **scf_kwargs):
    """Polish a split-SCF state with a few warm-started SCF iterations in the
    basis' dtype (LOBPCG, `scf/driver.py`), from its orbitals and density,
    starting the eigensolver tolerance at 1e-6.  Returns an SCFResult."""
    from .driver import self_consistent_field
    psi, occ = split_state_to_complex(basis, split_res["U"],
                                      split_res["occupation"], band_repr)
    rho = torch.as_tensor(split_res["rho"], device=basis.device).to(basis.rdtype)
    nb_total = psi.shape[1]
    n_occ = int(np.max(np.sum(occ.cpu().numpy() > occupation_threshold, axis=1)))
    n_occ = max(1, min(n_occ, nb_total))
    scf_kwargs.setdefault("diagtol_max", 1e-6)
    return self_consistent_field(basis, tol=tol, maxiter=maxiter, rho=rho, psi=psi,
                                 n_bands=n_occ, n_extra_bands=nb_total - n_occ,
                                 **scf_kwargs)
