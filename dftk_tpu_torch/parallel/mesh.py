"""Parallelism over k-points (and spin, which rides the k axis) x bands on
`torch.distributed`.

Port of `dftk_tpu/parallel/mesh.py`.  The JAX package shards every
[nk, ...] array over the "kpts" axis of a `jax.sharding.Mesh` (and U over
an optional "bands" axis) and lets XLA insert the collectives.  Here the
mesh is a `torch.distributed.device_mesh.DeviceMesh` with the same axis
names, every rank holds only its own k rows, and each collective is
explicit, in `KComm`:

  * a distributed basis keeps this rank's rows of the [nk, ...] tensors
    (`basis.data`: Gidx, mask, kin, Gpk_cart, kweights, kspin; the
    projectors P, a blow-up's kinetic and the exchange's q map in
    `basis.terms.data`; the pruned maps in `basis.pruned`) and replicates
    the grid fields, the DFT factors and D.  Its host arrays (`Gidx_np`,
    `kweights`, `kcoords_spin`, ...) and `n_kpoints` stay global;
    `local_rows` picks this rank's rows of them;
  * every sum over k (densities, band energies, the exchange and Hubbard
    occupations, the nonlocal forces) is an all_reduce over "kpts"
    (`ksum`); the Fermi level and the occupations come from the
    all-gathered eigenvalues, the same on every rank; the eigensolvers'
    stopping rules take the maximum over "kpts" (`kmax`), so that every
    rank iterates as the single-process run does;
  * on a "bands" axis each rank applies H (and runs the Chebyshev filter)
    on its slice of the band block and the block is all-gathered for the
    Gram, Rayleigh-Ritz and orthogonalisation steps (`band_apply`).

As in the JAX package, a k-point count that the "kpts" axis does not
divide is padded with zero-weight phantom k-points (copies of the first
k-point's sphere), which add nothing to any sum.  NCCL on the card, gloo
on the CPU (`parallel/multihost.py::initialize`).
"""
import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

ROADMAP_13B = ("is not distributed over k-points yet (ROADMAP Queue 1, item 13b); "
               "run it on a basis that is not distributed")


def _device_type():
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def kpoint_mesh(n_devices: Optional[int] = None):
    """A 1-D ("kpts",) DeviceMesh over the ranks of the default process
    group (n_devices, if given, must be the world size; 2-D ("kpts",
    "bands") meshes come from `init_device_mesh` with those names)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"kpoint_mesh({n_devices}): a mesh spans all {world} ranks; put "
                         f"the others on a 'bands' axis (init_device_mesh with "
                         f"mesh_dim_names=('kpts', 'bands'))")
    return init_device_mesh(_device_type(), (world,), mesh_dim_names=("kpts",))


def _axis(mesh, name):
    """(size, this rank's coordinate, process group) of a mesh axis; (1, 0,
    None) where the mesh has no such axis."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        return 1, 0, None
    i = names.index(name)
    return mesh.size(i), mesh.get_coordinate()[i], mesh.get_group(name)


class KComm:
    """This rank's place on a ("kpts"[, "bands"]) mesh for n_kpoints rows,
    and the collectives over its axes."""

    def __init__(self, mesh, n_kpoints):
        self.mesh = mesh
        self.n_kpoints = n_kpoints
        self.ksize, self.krank, self.kgroup = _axis(mesh, "kpts")
        self.bsize, self.brank, self.bgroup = _axis(mesh, "bands")
        if n_kpoints % self.ksize:
            raise ValueError(f"{n_kpoints} k-points on a 'kpts' axis of {self.ksize}: pad "
                             f"them first (pad_basis_kpoints, or distribute)")
        per = n_kpoints // self.ksize
        self.lo, self.hi = self.krank * per, (self.krank + 1) * per

    def rows(self, a):
        """This rank's k rows of a global [nk, ...] array or tensor."""
        return a[self.lo:self.hi]

    def ksum(self, t):
        """The sum over the "kpts" axis of each rank's t."""
        if self.ksize == 1:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.kgroup)
        return t

    def kmax(self, *values):
        """The maximum over the "kpts" axis of each of the floats values."""
        out = tuple(float(v) for v in values)
        if self.ksize > 1:
            t = torch.tensor(out, dtype=torch.float64, device=_device_type())
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.kgroup)
            out = tuple(t.tolist())
        return out if len(out) > 1 else out[0]

    def kgather(self, t):
        """The global [nk, ...] tensor of each rank's rows t."""
        if self.ksize == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.ksize)]
        dist.all_gather(parts, t.contiguous(), group=self.kgroup)
        return torch.cat(parts, dim=0)

    def band_apply(self, fn):
        """fn on this rank's slice of the band block (axis 1), the results
        all-gathered over "bands"; fn itself where the block does not split
        evenly (a single probe band, say)."""
        if self.bsize == 1:
            return fn

        def apply(X):
            nb = X.shape[1]
            if nb % self.bsize:
                return fn(X)
            per = nb // self.bsize
            Y = fn(X[:, self.brank * per:(self.brank + 1) * per].contiguous()).contiguous()
            parts = [torch.empty_like(Y) for _ in range(self.bsize)]
            dist.all_gather(parts, Y, group=self.bgroup)
            return torch.cat(parts, dim=1)

        return apply

    def round_bands(self, nb):
        """nb rounded up to a multiple of the "bands" axis."""
        return -(-nb // self.bsize) * self.bsize


def ksum(t, comm):
    return t if comm is None else comm.ksum(t)


def kmax(comm, *values):
    """max over "kpts" of floats (the values themselves without a mesh)."""
    if comm is None:
        out = tuple(float(v) for v in values)
        return out if len(out) > 1 else out[0]
    return comm.kmax(*values)


def kgather(t, comm):
    return t if comm is None else comm.kgather(t)


def band_apply(fn, comm):
    return fn if comm is None else comm.band_apply(fn)


def local_rows(basis, a):
    """This rank's rows of a global [nk, ...] array of a basis (a itself if
    the basis is not distributed)."""
    comm = getattr(basis, "comm", None)
    return a if comm is None else comm.rows(a)


def refuse_distributed(basis, what):
    """Raise NotImplementedError if basis is distributed over more than one
    rank: `what` has no k-point reductions yet."""
    comm = getattr(basis, "comm", None)
    if comm is not None and comm.ksize * comm.bsize > 1:
        raise NotImplementedError(f"{what} {ROADMAP_13B}")


def maybe_auto_distribute(basis):
    """Whole-suite mesh mode: with DFTK_TPU_MESH=N set and torch.distributed
    initialised with more than one rank, distribute the freshly built basis
    over a "kpts" axis of the largest divisor of n_kpoints that is at most
    min(N, world size), the other ranks of the world on a "bands" axis.  A
    divisor (not phantom padding) keeps every shape; a count with no such
    divisor that also divides the world leaves the basis as it is."""
    val = os.environ.get("DFTK_TPU_MESH")
    if not val or not dist.is_available() or not dist.is_initialized():
        return basis
    world = dist.get_world_size()
    if world < 2:
        return basis
    want = min(int(val), world)
    size = next((d for d in range(min(basis.n_kpoints, want), 1, -1)
                 if basis.n_kpoints % d == 0 and world % d == 0), 1)
    if size < 2:
        return basis
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh(_device_type(), (size, world // size),
                            mesh_dim_names=("kpts", "bands"))
    return shard_basis(basis, mesh)


def pad_basis_kpoints(basis, multiple):
    """Pad the k-point axis of a (not yet distributed) basis to a multiple
    of `multiple` with phantom k-points: copies of the first k-point's
    sphere (a valid mask keeps the Gram matrices regular) with weight 0,
    which add nothing to any sum.  The tensors, the pruned maps and the
    terms are rebuilt.  Returns the padded count."""
    nk = basis.n_kpoints
    nk_pad = -(-nk // multiple) * multiple
    if nk_pad == nk:
        return nk
    if getattr(basis, "comm", None) is not None:
        raise ValueError("pad_basis_kpoints: the basis is distributed already")
    pad = nk_pad - nk

    def rep(a):
        return np.concatenate([a, np.repeat(a[:1], pad, axis=0)], axis=0)

    def pad0(a):
        return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

    for name in ("mask_np", "Gidx_np", "kin_np", "Gpk_cart_np", "Gred_np", "kcoords_spin"):
        setattr(basis, name, rep(getattr(basis, name)))
    basis.kweights = pad0(basis.kweights)
    basis.kspin = pad0(basis.kspin)
    basis.n_kpoints = nk_pad

    from ..basis import BasisData
    from ..ops.pruned import build_pruned_fft
    from ..ops.terms import instantiate_terms
    basis.data = BasisData(
        Gidx=basis.tensor(basis.Gidx_np, torch.int64), mask=basis.tensor(basis.mask_np),
        kin=basis.tensor(basis.kin_np), Gpk_cart=basis.tensor(basis.Gpk_cart_np),
        kweights=basis.tensor(basis.kweights), kspin=basis.tensor(basis.kspin, torch.int64))
    basis.pruned = build_pruned_fft(basis)
    basis.terms = instantiate_terms(basis)
    basis.__dict__.pop("_ff_cache", None)       # the projector form factors' rows
    return nk_pad


def _rows_of(comm, bd, td, pruned):
    """This rank's rows of the [nk, ...] tensors of basis data, terms data
    (the projectors, a blow-up's kinetic, the exchange's q map) and pruned
    maps."""
    return (bd._replace(**{f: comm.rows(getattr(bd, f)) for f in bd._fields}),
            td._replace(**{f: comm.rows(getattr(td, f)) for f in ("P", "kin", "exx_iq")
                           if getattr(td, f) is not None}),
            pruned._replace(Gidx_c=comm.rows(pruned.Gidx_c),
                            inv_idx=comm.rows(pruned.inv_idx)))


def shard_basis(basis, mesh):
    """Keep this rank's k rows of the basis' [nk, ...] tensors (module
    docstring) and record the mesh on the basis (`basis.mesh`, and the
    collectives in `basis.comm`).  n_kpoints must be a multiple of the
    "kpts" axis (pad_basis_kpoints first)."""
    if getattr(basis, "comm", None) is not None:
        if basis.mesh is mesh:
            return basis
        raise ValueError("shard_basis: the basis is distributed over another mesh already")
    comm = KComm(mesh, basis.n_kpoints)
    basis.data, basis.terms.data, basis.pruned = _rows_of(comm, basis.data, basis.terms.data,
                                                          basis.pruned)
    basis.mesh = mesh
    basis.comm = comm
    return basis


def shard_split_data(sd, mesh):
    """The split SCF's data (`ops/engine_split.py::SplitTermsData`) on the
    mesh: this rank's k rows of its [nk, ...] tensors, as `shard_basis`
    keeps them, and the mesh's collectives in `sd.comm`; data of a
    distributed basis is returned as it is."""
    if sd.comm is not None:
        return sd
    comm = KComm(mesh, sd.basis_data.mask.shape[0])
    bd, td, pruned = _rows_of(comm, sd.basis_data, sd.terms.data, sd.pruned)
    return sd._replace(basis_data=bd, terms=dataclasses.replace(sd.terms, data=td),
                       pruned=pruned, comm=comm)


def orbital_sharding(mesh):
    """The placements of psi / U [nk, nb, ...] on the mesh: k rows sharded
    over "kpts", and the bands over "bands" where the mesh has that axis
    (the band block is all-gathered between H applies, see KComm)."""
    from torch.distributed.tensor import Shard
    names = mesh.mesh_dim_names or ()
    return tuple(Shard(0) if n == "kpts" else Shard(1) for n in names)


def distribute(basis, mesh):
    """Pad (to the "kpts" axis) and shard a basis for k-point parallel
    execution on `mesh`."""
    pad_basis_kpoints(basis, _axis(mesh, "kpts")[0])
    return shard_basis(basis, mesh)


def shard_orbitals(psi, mesh):
    """This rank's k rows of psi [nk, ...] (every rank passes the same
    global psi)."""
    return KComm(mesh, psi.shape[0]).rows(psi)


def replicate(arr, mesh):
    """arr as a tensor on this rank's device of the mesh (every rank holds
    all of it)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))
    return torch.as_tensor(arr, device=dev)
