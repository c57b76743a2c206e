"""The probability current density (reference postprocess/current.jl).

Port of `dftk_tpu/postprocess/current.py`:

    j(r) = sum_kn w_k f_kn Im(psi* grad psi)(r),

nonzero only where time reversal is broken (a Magnetic term, anyons).
torch.fft over the whole cube, on the basis' device.
"""
import torch

from ..ops.anyonic import current_density
from ..parallel.mesh import refuse_distributed


def compute_current(scfres, basis=None):
    """The current density [3, n1, n2, n3], a real tensor on the basis'
    device.  scfres: an SCFResult, or anything with psi and occupation."""
    refuse_distributed(basis or scfres.basis, "compute_current")
    basis = basis or scfres.basis
    psi = torch.as_tensor(scfres.psi, device=basis.device).to(basis.dtype)
    occ = torch.as_tensor(scfres.occupation, device=basis.device, dtype=basis.rdtype)
    return current_density(basis.data, psi, occ, basis.fft_size,
                           basis.model.unit_cell_volume, n_axes=3)
