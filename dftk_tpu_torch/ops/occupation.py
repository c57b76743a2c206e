"""Occupation numbers and the Fermi level.

Port of `dftk_tpu/ops/occupation.py::compute_occupation` (reference
`src/occupation.jl:30-170`) at zero temperature: integer filling, epsF
midway between HOMO and LUMO.  Finite temperature needs the Entropy term,
which comes with metals (ROADMAP Queue 1, item 8).
"""
import torch

from ..models.smearing import NoSmearing


def compute_occupation(eigenvalues, kweights, n_electrons, filled_occupation,
                       temperature, smearing):
    """occupation [nk, nb] and epsF (0-d tensor) from eigenvalues [nk, nb]."""
    if not (temperature == 0 or isinstance(smearing, NoSmearing)):
        raise NotImplementedError(
            "finite-temperature occupations are not ported yet (ROADMAP "
            "Queue 1, item 8: spin, metals)")
    n_occ = n_electrons / filled_occupation
    if abs(n_occ - round(n_occ)) > 1e-12:
        raise ValueError(
            "Without temperature, the number of electrons must be divisible "
            "by the filled occupation (no fractional band filling).")
    n_occ = int(round(n_occ))
    nb = eigenvalues.shape[1]
    if n_occ > nb:
        raise ValueError(f"Need at least {n_occ} bands, got {nb}")
    occ = torch.zeros_like(eigenvalues)
    occ[:, :n_occ] = float(filled_occupation)
    homo = torch.max(eigenvalues[:, n_occ - 1])
    if n_occ < nb:
        epsF = (homo + torch.min(eigenvalues[:, n_occ])) / 2
    else:
        epsF = homo + 1e-3
    return occ, epsF
