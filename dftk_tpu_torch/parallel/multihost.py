"""Process-group set-up for the k-point mesh.

Port of `dftk_tpu/parallel/multihost.py`.  The JAX package joins hosts
through `jax.distributed`; the port's processes form one
`torch.distributed` process group, NCCL between cards and gloo on the
CPU, and `parallel/mesh.py` lays the k-points (x bands) over its ranks:

    import dftk_tpu_torch.parallel.multihost as mh
    mh.initialize()                 # torchrun's environment, or explicit
    mesh = mh.global_kpoint_mesh()  # every rank of every host
    # ... the same SCF as on one process, on distribute(basis, mesh)

Nothing tells a process of a cluster: torchrun's MASTER_ADDR/MASTER_PORT,
WORLD_SIZE and RANK, or the arguments, name the rendezvous.  One process
drives one card; without a card the ranks run on the CPU over gloo.
"""
import os

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address=None, num_processes=None, process_id=None, **kwargs):
    """torch.distributed.init_process_group with an explicit or
    environment-provided topology: coordinator_address "host:port" (default
    the environment's MASTER_ADDR and MASTER_PORT), num_processes and
    process_id (default WORLD_SIZE and RANK).  The backend is NCCL where
    CUDA is available, each process on card LOCAL_RANK (default its rank
    modulo the cards), else gloo; kwargs go to init_process_group (an
    `init_method` such as "file:///path" among them)."""
    world = int(os.environ.get("WORLD_SIZE", 1)) if num_processes is None else num_processes
    rank = int(os.environ.get("RANK", 0)) if process_id is None else process_id
    backend = kwargs.pop("backend", "nccl" if torch.cuda.is_available() else "gloo")
    if "init_method" not in kwargs:
        kwargs["init_method"] = (f"tcp://{coordinator_address}" if coordinator_address
                                 else "env://")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, world_size=world, rank=rank, **kwargs)


def global_kpoint_mesh(axis_name="kpts"):
    """A 1-D mesh over every rank of every process (k-point data
    parallelism): each rank owns a contiguous slice of the (phantom-padded)
    k-point list, and the density reduction is one all_reduce."""
    from torch.distributed.device_mesh import init_device_mesh
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (dist.get_world_size(),), mesh_dim_names=(axis_name,))


def local_kpoint_slice(n_kpoints_padded, axis_name="kpts"):
    """Index range (lo, hi) of the k-points this process holds on the
    global mesh (for host-side IO)."""
    per = n_kpoints_padded // dist.get_world_size()
    lo = dist.get_rank() * per
    return lo, lo + per


def fetch(t, layout=None):
    """A tensor -> host numpy, multi-process safe: a tensor of this rank's
    k rows of a distributed basis (layout: the basis, or its `comm`) is
    all-gathered over "kpts" first; any other is taken as replicated and
    copied directly."""
    if not torch.is_tensor(t):
        return np.asarray(t)
    comm = getattr(layout, "comm", layout)
    if comm is not None:
        t = comm.kgather(t)
    return t.detach().cpu().numpy()
