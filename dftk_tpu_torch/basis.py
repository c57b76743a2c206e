"""PlaneWaveBasis: discretization of a Model at a kinetic cutoff Ecut.

Port of `dftk_tpu/basis.py` (reference PlaneWaveBasis.jl:25-369 and
Kpoint.jl:6-74).  One dense, padded representation of all k-points:

    psi[nk, n_bands, nG_max]   (complex)       - Bloch coefficients
    Gidx[nk, nG_max]  (int64)                  - flat cube index per sphere pt
    mask[nk, nG_max]  (real)                   - 1 real / 0 padding
    kin [nk, nG_max]  (real)                   - |k+G|^2 / 2 (0 on padding)

nG_max is padded to a multiple of 128, as in the JAX package, so that the
two packages' arrays compare element by element.  Index and mask
construction is host-side numpy; `basis.data` holds the tensors on
`basis.device` in `basis.dtype` (complex) and its real counterpart.

The k-points are the irreducible wedge of the k-grid under the model's
symmetries that map the full grid onto itself; `basis.symmetries` keeps
the model's operations that map the r-grid (when the basis chooses its FFT
size, which it then makes divisible by the translations' denominators) and
the k-points onto themselves.

The device defaults to the CUDA card; without one, building a basis raises
unless the caller asks for the CPU (`device="cpu"`).

`parallel/mesh.py::distribute` lays the k-points over the ranks of a
torch.distributed mesh: `basis.data` then holds this rank's k rows and
`basis.comm` the collectives (`parallel/mesh.py::KComm`; None on one
process).
"""
import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .bzmesh import as_kgrid
from .models.model import Model
from .ops import fft as fftops
from .symmetry import (SymOp, symmetries_preserving_kgrid,
                       symmetries_preserving_rgrid)

LANE = 128  # nG padding multiple, kept from the JAX package


class BasisData(NamedTuple):
    """Static tensors of the discretization."""
    Gidx: torch.Tensor       # [nk, nG] int64 flat cube indices
    mask: torch.Tensor       # [nk, nG] real validity
    kin: torch.Tensor        # [nk, nG] kinetic energies |k+G|^2/2 (masked)
    Gpk_cart: torch.Tensor   # [nk, nG, 3] Cartesian k+G
    kweights: torch.Tensor   # [nk]
    kspin: torch.Tensor      # [nk] int64 spin component index (0 or 1)


def real_dtype(complex_dtype):
    return {torch.complex128: torch.float64,
            torch.complex64: torch.float32}[complex_dtype]


@dataclasses.dataclass
class PlaneWaveBasis:
    model: Model
    Ecut: float
    kgrid: Any = None
    fft_size: Optional[tuple] = None
    device: Any = "cuda"
    dtype: torch.dtype = torch.complex128
    symmetries_respect_rgrid: Optional[bool] = None
    use_symmetries_for_kpoint_reduction: bool = True

    def __post_init__(self):
        model = self.model
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "PlaneWaveBasis: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        self.rdtype = real_dtype(self.dtype)
        self.kgrid = as_kgrid(self.kgrid if self.kgrid is not None else (1, 1, 1))

        if self.symmetries_respect_rgrid is None:
            # the reference default (PlaneWaveBasis.jl:329): filter by the
            # r-grid only where the basis chooses its FFT size
            self.symmetries_respect_rgrid = self.fft_size is None

        # IBZ reduction, with the model's operations that map the full
        # (reducible) k-grid onto itself (shifted Monkhorst-Pack meshes)
        if self.use_symmetries_for_kpoint_reduction:
            ksym = symmetries_preserving_kgrid(
                model.symmetries, self.kgrid.reducible_kcoords(), unfold=False)
        else:
            ksym = [SymOp.identity()]
        kcoords, kweights = self.kgrid.irreducible_kcoords(ksym)
        self.kcoords = np.asarray(kcoords, dtype=float)
        self.kweights_irr = np.asarray(kweights, dtype=float)
        if abs(self.kweights_irr.sum() - 1.0) > 1e-12:
            raise ValueError("k-point weights must sum to 1")

        if self.fft_size is None:
            factors = (1,)
            if self.symmetries_respect_rgrid:
                # the grid holds every fractional translation exactly
                denoms = [_rational_denominator(w) for op in model.symmetries
                          for w in op.w]
                factors = (int(np.lcm.reduce(denoms)),) if denoms else (1,)
            self.fft_size = fftops.compute_fft_size(model.lattice, self.Ecut,
                                                    factors=factors)
        self.fft_size = tuple(int(n) for n in self.fft_size)

        syms = model.symmetries
        if self.symmetries_respect_rgrid:
            syms = symmetries_preserving_rgrid(syms, self.fft_size)
        self.symmetries = symmetries_preserving_kgrid(syms, self.kcoords)

        nspin = model.n_spin_components
        nk_irr = len(self.kcoords)
        self.kcoords_spin = np.tile(self.kcoords, (nspin, 1))
        self.kweights = np.tile(self.kweights_irr, nspin)
        self.kspin = np.repeat(np.arange(nspin), nk_irr)
        self.n_kpoints = nk_irr * nspin
        self.n_irreducible_kpoints = nk_irr

        self._build_spheres()

        self.dvol = model.unit_cell_volume / np.prod(self.fft_size)
        self.G_cube = fftops.G_vectors_cube(self.fft_size)     # integer [n1,n2,n3,3]
        self.G_cube_cart = np.einsum("ab,xyzb->xyza", model.recip_lattice,
                                     self.G_cube.astype(float))
        self.G_cube_cart_norm = np.linalg.norm(self.G_cube_cart, axis=-1)
        self.r_cube = fftops.r_vectors(self.fft_size)          # fractional [n1,n2,n3,3]

        self.data = BasisData(
            Gidx=self.tensor(self.Gidx_np, torch.int64),
            mask=self.tensor(self.mask_np),
            kin=self.tensor(self.kin_np),
            Gpk_cart=self.tensor(self.Gpk_cart_np),
            kweights=self.tensor(self.kweights),
            kspin=self.tensor(self.kspin, torch.int64),
        )

        from .ops.pruned import build_pruned_fft
        from .ops.terms import instantiate_terms
        from .parallel.mesh import maybe_auto_distribute
        self.pruned = build_pruned_fft(self)
        self.terms = instantiate_terms(self)
        # a k-point mesh (parallel/mesh.py) sets both; DFTK_TPU_MESH under
        # torch.distributed distributes every new basis
        self.mesh = None
        self.comm = None
        maybe_auto_distribute(self)

    def tensor(self, arr, dtype=None):
        """numpy -> contiguous tensor on this basis' device (real dtype by
        default)."""
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype or self.rdtype,
                               device=self.device)

    def _build_spheres(self):
        Gcube = fftops.G_vectors_cube(self.fft_size).reshape(-1, 3)
        B = self.model.recip_lattice
        sel_list = []
        for k in self.kcoords_spin:
            Gpk = (Gcube + k) @ B.T
            ekin = 0.5 * np.einsum("na,na->n", Gpk, Gpk)
            sel_list.append(np.nonzero(ekin <= self.Ecut)[0])

        nG_max = max(len(s) for s in sel_list)
        self.nG_max = ((nG_max + LANE - 1) // LANE) * LANE

        nk = self.n_kpoints
        Gidx = np.zeros((nk, self.nG_max), dtype=np.int64)
        mask = np.zeros((nk, self.nG_max))
        Gred = np.zeros((nk, self.nG_max, 3), dtype=np.int64)
        Gpk_cart = np.zeros((nk, self.nG_max, 3))
        for ik, sel in enumerate(sel_list):
            n = len(sel)
            Gidx[ik, :n] = sel
            mask[ik, :n] = 1.0
            Gred[ik, :n] = Gcube[sel]
            Gpk_cart[ik, :n] = (Gcube[sel] + self.kcoords_spin[ik]) @ B.T

        self.Gidx_np = Gidx
        self.mask_np = mask
        self.Gred_np = Gred
        self.Gpk_cart_np = Gpk_cart
        self.kin_np = 0.5 * np.einsum("kna,kna->kn", Gpk_cart, Gpk_cart) * mask

    def __repr__(self):
        return (f"PlaneWaveBasis(Ecut={self.Ecut}, fft_size={self.fft_size}, "
                f"n_kpoints={self.n_kpoints} (irr {self.n_irreducible_kpoints}), "
                f"nG_max={self.nG_max}, n_symmetries={len(self.symmetries)}, "
                f"device={self.device}, dtype={self.dtype})")


def _rational_denominator(x, max_den=48):
    from fractions import Fraction
    return Fraction(float(x)).limit_denominator(max_den).denominator
