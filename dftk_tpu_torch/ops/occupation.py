"""Occupation numbers, the Fermi level and the smearing entropy.

Port of `dftk_tpu/ops/occupation.py` (reference `src/occupation.jl:30-170`):
  * zero temperature: integer filling, epsF midway between HOMO and LUMO
  * finite temperature, monotone smearing (Fermi-Dirac, Gaussian): 80
    bisection steps on the electron count's excess
  * non-monotone smearing (Methfessel-Paxton, Marzari-Vanderbilt): the
    bisection with Gaussian smearing, then 12 clipped Newton steps with the
    actual smearing, its derivative by `torch.autograd`

The search runs on the eigenvalues' device as fixed-count tensor code: no
step reads a value back to the host, so an SCF iteration pays no sync for
it (the eigenvalues are [nk, nb], a few hundred entries).
"""
import torch

from ..models.smearing import Gaussian, NoSmearing
from ..parallel.mesh import kgather, ksum

BISECTION_STEPS = 80
NEWTON_STEPS = 12


def compute_occupation(eigenvalues, kweights, n_electrons, filled_occupation,
                       temperature, smearing, comm=None):
    """occupation [nk, nb] and epsF (0-d tensor) from eigenvalues [nk, nb].

    Collinear spin comes as doubled k-point rows with filled_occupation 1.
    comm (`parallel/mesh.py::KComm`): the rows are this rank's k rows; the
    eigenvalues and weights of all ranks are gathered, every rank finds
    the same Fermi level, and the occupations of its own rows return."""
    if comm is not None and comm.ksize > 1:
        occ, epsF = compute_occupation(kgather(eigenvalues, comm), kgather(kweights, comm),
                                       n_electrons, filled_occupation, temperature, smearing)
        return comm.rows(occ), epsF
    if temperature == 0 or isinstance(smearing, NoSmearing):
        return _occupation_zero_temperature(eigenvalues, n_electrons, filled_occupation)
    w = kweights.to(eigenvalues.dtype)[:, None]

    def excess(epsF, smear):
        occ = filled_occupation * smear.occupation((eigenvalues - epsF) / temperature)
        return torch.sum(w * occ) - n_electrons

    lo = torch.min(eigenvalues) - 10 * temperature - 1.0
    hi = torch.max(eigenvalues) + 10 * temperature + 1.0
    smear_mono = smearing if smearing.monotone else Gaussian()
    for _ in range(BISECTION_STEPS):
        mid = (lo + hi) / 2
        up = excess(mid, smear_mono) < 0
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    epsF = (lo + hi) / 2

    if not smearing.monotone:
        # FermiTwoStage: Newton steps with the actual smearing, each clipped
        # to 10 T
        for _ in range(NEWTON_STEPS):
            with torch.enable_grad():
                mu = epsF.detach().requires_grad_(True)
                f = excess(mu, smearing)
                (df,) = torch.autograd.grad(f, mu)
            step = torch.where(df.abs() > 1e-14, f.detach() / df, torch.zeros_like(df))
            epsF = epsF - torch.clamp(step, -10 * temperature, 10 * temperature)

    occ = filled_occupation * smearing.occupation((eigenvalues - epsF) / temperature)
    return occ, epsF


def _occupation_zero_temperature(eigenvalues, n_electrons, filled_occupation):
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


def entropy_energy(eigenvalues, kweights, epsF, temperature, smearing,
                   filled_occupation, comm=None):
    """The -T S term (reference terms/entropy.jl) that makes F = E - T S
    variational; a 0-d tensor on the eigenvalues' device (summed over the
    "kpts" axis of comm)."""
    eigenvalues = torch.as_tensor(eigenvalues)
    if temperature == 0 or isinstance(smearing, NoSmearing):
        return torch.zeros((), dtype=eigenvalues.dtype, device=eigenvalues.device)
    w = torch.as_tensor(kweights, device=eigenvalues.device).to(eigenvalues.dtype)
    s = smearing.entropy((eigenvalues - epsF) / temperature)
    return ksum(-temperature * filled_occupation * torch.sum(w[:, None] * s), comm)
