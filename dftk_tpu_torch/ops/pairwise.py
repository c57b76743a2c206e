"""Classical pairwise interatomic potentials (reference terms/pairwise.jl).

Port of `dftk_tpu/ops/pairwise.py`.  The energy per unit cell of

    1/2 sum_{i,j,R}' V_{sp(i),sp(j)}(|r_i - r_j - R|)

with a real-space cutoff, as one differentiable torch lattice sum, so the
forces (in reduced coordinates) are its `torch.autograd` gradient, as
`jax.grad` gives them in the JAX package.

V is called with the squared Cartesian distance (which keeps the
derivative smooth), a float64 torch tensor, and the parameters of the
species pair: V(d2, params[(symA, symB)]), the key sorted.  It must be
written in torch operations (the JAX package's takes jnp arrays).
"""
import numpy as np
import torch

from ..utils.lattice import estimate_integer_lattice_bounds


def _species(at):
    return getattr(at, "symbol", str(type(at).__name__))


def energy_pairwise(lattice, atoms, positions, V, params, max_radius=100.0):
    """The pairwise energy of positions [n_atoms, 3] (fractional; a float64
    tensor, differentiable) in the lattice [3, 3] (numpy or a tensor)."""
    lattice_host = np.asarray(lattice.detach().cpu() if torch.is_tensor(lattice) else lattice,
                              dtype=float)
    Rlims = estimate_integer_lattice_bounds(lattice_host, max_radius)
    axes = [np.arange(-l, l + 1) for l in Rlims]
    Rbox = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)

    positions = torch.as_tensor(positions, dtype=torch.float64)
    dev = positions.device
    lattice = torch.as_tensor(lattice, dtype=torch.float64, device=dev)
    na = positions.shape[0]
    syms = [_species(at) for at in atoms]

    diff = positions[:, None, :] - positions[None, :, :]
    disp = diff[None] - torch.as_tensor(Rbox, dtype=torch.float64, device=dev)[:, None, None, :]
    dcart = torch.einsum("ab,rijb->rija", lattice, disp)
    d2 = torch.sum(dcart * dcart, dim=-1)
    self_pair = (torch.as_tensor(np.all(Rbox == 0, axis=1), device=dev)[:, None, None]
                 & torch.eye(na, dtype=torch.bool, device=dev)[None])
    cutoff = (d2 <= max_radius ** 2) & ~self_pair

    E = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(na):
        for j in range(na):
            key = tuple(sorted((syms[i], syms[j])))
            if key not in params:
                continue
            c = cutoff[:, i, j]
            vij = V(torch.where(c, d2[:, i, j], torch.ones_like(d2[:, i, j])), params[key])
            E = E + torch.sum(torch.where(c, vij, torch.zeros_like(vij)))
    return E / 2


def energy_forces_pairwise(lattice, atoms, positions, V, params, max_radius=100.0):
    """(E, F): the pairwise energy (a 0-d float64 tensor) and its forces
    -dE/dr [n_atoms, 3] in reduced coordinates."""
    with torch.enable_grad():
        pos = torch.as_tensor(np.asarray(positions), dtype=torch.float64).requires_grad_(True)
        E = energy_pairwise(lattice, atoms, pos, V, params, max_radius)
        if not E.requires_grad:                 # no pair of the params' species
            return E, torch.zeros_like(pos.detach())
        (g,) = torch.autograd.grad(E, pos)
    return E.detach(), -g


def lennard_jones(d2, params):
    """V = 4 eps [(sigma^2 / d2)^6 - (sigma^2 / d2)^3]; params = (eps, sigma)."""
    eps, sigma = params
    s6 = (sigma ** 2 / d2) ** 3
    return 4 * eps * (s6 * s6 - s6)
