"""dftk_tpu_torch: the PyTorch and CUDA port of dftk_tpu.

Plane-wave Kohn-Sham DFT with HGH or UPF pseudopotentials (with nonlinear
core corrections) and LDA, GGA (PBE, PBEsol) or meta-GGA (SCAN, r2SCAN,
TPSS, and the potential-only TB09) functionals, for insulators and metals
(smearing, Entropy),
without spin or with collinear spin (magnetic moments), solved
self-consistently on complex tensors on the CUDA card, or on the
CPU when the caller asks (`PlaneWaveBasis(..., device="cpu")`), complex128
by default.  Two SCF loops: `self_consistent_field` (batched LOBPCG) and
`self_consistent_field_split` (the large-cell path: CheFSI with the
compact-cube-resident Chebyshev filter, bf16 filter cycles then exact
ones), with `refine_split_energy` to evaluate a result's energy, and the
Hellmann-Feynman forces and stresses of a result by `torch.autograd`
(`compute_forces`, `compute_forces_cart`, `compute_stresses_cart`).  The
local-potential part of H psi runs through hand-written CUDA kernels on a
CUDA device (`kernels/local_apply.py`).  The JAX package `dftk_tpu` is the
reference this port is held against; this package never imports it or jax.

The model Hamiltonians beyond Kohn-Sham DFT run too: the energy-cutoff
blow-ups of the kinetic term (`BlowupCHV`, `BlowupAbinit`;
`model_DFT(..., kinetic_blowup=...)`), user external potentials
(`ExternalFromReal`, `ExternalFromFourier`, `ExternalFromValues`), a local
nonlinearity (`LocalNonlinearity`: Gross-Pitaevskii), a vector potential
(`Magnetic`, with `compute_current`), classical pairwise potentials
(`PairwisePotential`, with `ops.pairwise.lennard_jones`) and average-field
anyons (`Anyonic`, by `direct_minimization`), on 1D, 2D and 3D cells.

Crystal symmetry is on by default (`symmetries=True`): IBZ k-points and
symmetrized densities, forces and stresses.  Hybrid functionals (`PBE0`,
`HSE06`, `model_HF`) add exact exchange (`ExactExchange`, with the Coulomb
kernels of `ops/coulomb.py`, at Gamma or on unreduced k-grids), and
`Hubbard` DFT+U on `HubbardManifold`s of UPF pseudo-atomic orbitals; both
SCF loops carry them (the exchange compressed by ACE, `use_ace=True`).  Mixings: Simple, Kerker,
dielectric and the LDOS-based LdosMixing, KerkerDosMixing and
HybridMixing, and Chi0Mixing (the exact chi0 by Sternheimer equations);
band counts: FixedBands and AdaptiveBands.  The other ground-state
solvers: `direct_minimization`, and `scf.newton.newton` and
`scf.potential_mixing.scf_potential_mixing` (from their modules, as in the
JAX package).  The response: `apply_chi0`, `solve_dyson`,
`compute_polarizability` and the SCF Hessian Omega + K
(`make_omega_plus_k`, `eigen_omega_plus_k`, `solve_omega_plus_k`).  Second
derivatives at Gamma: `unfold_bz` (an IBZ result on the full k-grid),
`response.phonon_dfpt.dynmat_dfpt_gamma` and `phonon_modes_dfpt_gamma`
(DFPT phonons, insulators and metals), `elastic_tensor_response` (the
elastic tensor by the response, HGH and UPF models), and their finite-difference checks
`phonon_modes_finite_diff` (`postprocess/phonon.py`) and
`postprocess.elastic.elastic_tensor`.  Phonons at a commensurate q:
`response.phonon_q.dynmat_dfpt_q` and `phonon_modes_dfpt_q` (DFPT on the
unfolded k-grid, every k+q apply of H on the kernels), and the supercell
route `postprocess.phonon.compute_force_constants` with `dynmat_q`,
`phonon_modes_q` and `phonon_band_structure` along `irrfbz_path`.  The
split SCF's response entry points (`response.chi0_split`,
`response.phonon_split`) are adapters over the complex path.  A meta-GGA's H
adds the DivAgrad term through the same kernels, and its split SCF filters
with the sphere apply.

After an SCF: band structures along `irrfbz_path` (`compute_bands`), the
total, local and projected densities of states (`compute_dos`,
`compute_ldos`, `postprocess.dos.compute_pdos`), the two-grid refinement
with its refined forces (`refine_scfres`, `refine_forces`,
`refine_forces_cart`), relaxations (`optimize_geometry`, and
`external.calculator.DFTCalculator`), checkpoints in the JAX package's
file format (`save_scfres`, `load_scfres`, `todict`, `save_vts`), the
Wannier90 files (`external.wannier`), structure readers
(`external.structure`), `transfer_blochwave`/`transfer_density`,
`standardize_atoms`, `postprocess.plotting` (with matplotlib) and the
`timer` (CUDA events on a card).  Both SCF loops, the forces and the
k-grid exchange also run distributed over k-points (and spin) x bands on
`torch.distributed` (`parallel/mesh.py`, `parallel/multihost.py`: NCCL on
cards, gloo on the CPU).  See ROADMAP.md for what is still to port.
"""
import torch

# Full float32 matrix products and convolutions on the GPU: TF32 keeps only
# ~3 decimal digits, far below what a plane-wave SCF needs.  Set explicitly
# although PyTorch's matmul default already agrees; cuDNN's does not.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .basis import PlaneWaveBasis  # noqa: E402
from .bzmesh import ExplicitKpoints, MonkhorstPack, kgrid_from_maximal_spacing  # noqa: E402
from .models import smearing as Smearing  # noqa: E402
from .models.elements import (ElementCohenBergstresser, ElementCoulomb,  # noqa: E402
                              ElementGaussian, ElementPsp, atomic_symbol)
from .models.psp_hgh import PspHgh, list_psp, load_psp, load_psp_hgh, parse_hgh  # noqa: E402
from .models.psp_lincomb import PspLinComb, virtual_crystal_approximation  # noqa: E402
from .models.psp_upf import PspUpf, load_psp_upf, parse_upf  # noqa: E402
from .models.model import Model  # noqa: E402
from .models.standard import (HSE06, LDA, PBE, PBE0, PBEsol, model_atomic,  # noqa: E402
                              model_DFT, model_HF)
from .ops.coulomb import (Coulomb, LongRangeCoulomb, ProbeCharge,  # noqa: E402
                          ReplaceSingularity, ShortRangeCoulomb,
                          SphericallyTruncatedCoulomb, VoxelAveraged,
                          WignerSeitzTruncatedCoulomb)
from .ops.hubbard import HubbardManifold  # noqa: E402
from .ops.terms import (Anyonic, AtomicLocal, AtomicNonlocal, BlowupAbinit,  # noqa: E402
                        BlowupCHV, BlowupIdentity, Entropy, Ewald, ExactExchange,
                        ExternalFromFourier, ExternalFromReal, ExternalFromValues,
                        Hartree, Hubbard, Kinetic, LocalNonlinearity, Magnetic,
                        PairwisePotential, PspCorrection, Xc)
from .ops.density import (compute_density, guess_density, random_density,  # noqa: E402
                          spin_density, total_density)
from .ops.engine_split import self_consistent_field_split  # noqa: E402
from .io.scfres import load_scfres, save_scfres, todict  # noqa: E402
from .io.vtk import save_vts  # noqa: E402
from .postprocess.bands import compute_bands, irrfbz_path  # noqa: E402
from .postprocess.dos import compute_dos, compute_ldos  # noqa: E402
from .postprocess.geometry import optimize_geometry  # noqa: E402
from .postprocess.refine import refine_forces, refine_forces_cart, refine_scfres  # noqa: E402
from .postprocess.current import compute_current  # noqa: E402
from .postprocess.elastic_response import elastic_tensor_response  # noqa: E402
from .postprocess.forces import compute_forces, compute_forces_cart  # noqa: E402
from .postprocess.phonon import phonon_modes_finite_diff  # noqa: E402
from .response.chi0 import apply_chi0, make_chi0_context  # noqa: E402
from .response.hessian import (compute_polarizability, eigen_omega_plus_k,  # noqa: E402
                               make_omega_plus_k, solve_dyson, solve_omega_plus_k)
from .postprocess.stresses import compute_stresses_cart  # noqa: E402
from .postprocess.unfold import unfold_bz  # noqa: E402
from .scf.direct import direct_minimization  # noqa: E402
from .scf.driver import SCFResult, self_consistent_field  # noqa: E402
from .scf.energy_eval import (evaluate_total_energy, refine_split_energy,  # noqa: E402
                              refine_split_state)
from .scf.mixing import (Chi0Mixing, DielectricMixing, HybridMixing,  # noqa: E402
                         KerkerDosMixing, KerkerMixing, LdosMixing, SimpleMixing)
from .scf.nbands import AdaptiveBands, FixedBands  # noqa: E402
from .standardize import find_primitive, minkowski_reduce, standardize_atoms  # noqa: E402
from .supercell import cell_to_supercell, create_supercell  # noqa: E402
from .symmetry import SymOp  # noqa: E402
from .transfer import transfer_blochwave, transfer_density  # noqa: E402
from .utils.timer import memory_usage, timer, versioninfo  # noqa: E402

__version__ = "0.1.0"

__all__ = ["model_DFT", "LDA", "PBE", "PBEsol", "ElementPsp", "ElementCoulomb",
           "ElementGaussian", "ElementCohenBergstresser", "PspUpf", "load_psp_upf",
           "parse_upf", "PspLinComb", "virtual_crystal_approximation", "Smearing",
           "PlaneWaveBasis", "MonkhorstPack", "ExplicitKpoints",
           "self_consistent_field", "SCFResult", "guess_density", "total_density",
           "spin_density", "self_consistent_field_split", "create_supercell",
           "refine_split_energy", "evaluate_total_energy", "compute_forces",
           "compute_forces_cart", "compute_stresses_cart", "SimpleMixing",
           "KerkerMixing", "DielectricMixing", "LdosMixing", "KerkerDosMixing",
           "HybridMixing", "Chi0Mixing", "FixedBands", "AdaptiveBands",
           "direct_minimization", "apply_chi0", "make_chi0_context", "solve_dyson",
           "compute_polarizability", "make_omega_plus_k", "eigen_omega_plus_k",
           "solve_omega_plus_k", "model_atomic", "Model", "unfold_bz",
           "phonon_modes_finite_diff", "elastic_tensor_response", "compute_bands",
           "irrfbz_path", "PBE0", "HSE06", "model_HF", "ExactExchange", "Hubbard",
           "HubbardManifold", "Coulomb", "LongRangeCoulomb", "ProbeCharge",
           "ReplaceSingularity", "ShortRangeCoulomb", "SphericallyTruncatedCoulomb",
           "VoxelAveraged", "WignerSeitzTruncatedCoulomb", "Kinetic", "AtomicLocal",
           "AtomicNonlocal", "Ewald", "PspCorrection", "Hartree", "Xc", "Entropy",
           "BlowupIdentity", "BlowupCHV", "BlowupAbinit", "ExternalFromReal",
           "ExternalFromFourier", "ExternalFromValues", "LocalNonlinearity", "Magnetic",
           "Anyonic", "PairwisePotential", "compute_current", "kgrid_from_maximal_spacing",
           "atomic_symbol", "PspHgh", "list_psp", "load_psp", "load_psp_hgh", "parse_hgh",
           "compute_density", "random_density", "load_scfres", "save_scfres", "todict",
           "save_vts", "compute_dos", "compute_ldos", "optimize_geometry", "refine_forces",
           "refine_forces_cart", "refine_scfres", "refine_split_state", "find_primitive",
           "minkowski_reduce", "standardize_atoms", "cell_to_supercell", "SymOp",
           "transfer_blochwave", "transfer_density", "memory_usage", "timer", "versioninfo",
           "__version__"]
