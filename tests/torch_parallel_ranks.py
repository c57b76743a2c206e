"""One rank of the port's two-rank parallel checks (tests/test_torch_parallel.py).

    GLOO_SOCKET_IFNAME=lo python tests/torch_parallel_ranks.py RANK WORLD RDZV OUT

Each of the WORLD processes (2) joins one gloo process group through the
file rendezvous RDZV (`parallel/multihost.py::initialize` with a
"file://" init_method), runs the cells of tests/data/make_torch_port_parallel.py
on the CPU, and rank 0 writes every rank's results to the JSON file OUT:

  a. self_consistent_field on a ("kpts",) mesh of 2 (8 k-points, 4 a rank);
  b. the symmetry-reduced grid (3 k-points) padded to 4 by `distribute`;
  c. self_consistent_field_split in complex128 on a ("kpts", "bands") mesh
     of (1, 2), and compute_forces_split on its state;
  d. the k-grid HF helium split SCF on ("kpts",) of 2;
  e. the multihost API (local_kpoint_slice, fetch), DFTK_TPU_MESH's
     distribution of a new basis, shard_split_data, orbital_sharding,
     shard_orbitals and replicate, and the refusal of the entry points
     without k-point reductions (ROADMAP item 13b);
  f. displaced Si2 on ("kpts",) of 2: self_consistent_field under r2SCAN
     and compute_forces_cart, the split SCF and compute_forces_split;
  g. the smeared collinear C2 PBE+U self_consistent_field on ("kpts",) of
     2, the spin-up rows on rank 0 and the spin-down ones on rank 1.

Torch runs at one thread.  Imports no JAX.
"""
import importlib.util
import json
import os
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import dftk_tpu_torch as dt  # noqa: E402
from dftk_tpu_torch.ops.engine_split import (prepare_split_data,  # noqa: E402
                                             self_consistent_field_split)
from dftk_tpu_torch.ops.forces_split import compute_forces_split  # noqa: E402
from dftk_tpu_torch.parallel import multihost  # noqa: E402
from dftk_tpu_torch.ops.density import guess_density  # noqa: E402
from dftk_tpu_torch.parallel.mesh import (distribute, kpoint_mesh,  # noqa: E402
                                          orbital_sharding, replicate, shard_orbitals,
                                          shard_split_data)

_spec = importlib.util.spec_from_file_location(
    "make_parallel", ROOT / "tests" / "data" / "make_torch_port_parallel.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)


def timed(out, key, fn):
    t0 = time.time()
    value = fn()
    out.setdefault("seconds", {})[key] = time.time() - t0
    return value


def refusals(res, basis):
    """Each entry point without k-point reductions, called on a distributed
    state: (name, whether it raised NotImplementedError naming item 13b)."""
    from dftk_tpu_torch.postprocess.bands import compute_bands
    from dftk_tpu_torch.response.chi0 import make_chi0_context
    from dftk_tpu_torch.scf.direct import direct_minimization
    from dftk_tpu_torch.scf.energy_eval import evaluate_total_energy
    from dftk_tpu_torch.scf.newton import newton
    calls = {
        "compute_stresses_cart": lambda: dt.compute_stresses_cart(res),
        "compute_bands": lambda: compute_bands(res, kline_density=5),
        "make_chi0_context": lambda: make_chi0_context(res),
        "direct_minimization": lambda: direct_minimization(basis, maxiter=1),
        "newton": lambda: newton(basis, maxiter=1, psi=res.psi),
        "evaluate_total_energy": lambda: evaluate_total_energy(basis, res.psi, res.occupation),
        "unfold_bz": lambda: dt.unfold_bz(res),
        "Chi0Mixing": lambda: dt.self_consistent_field(basis, maxiter=1, mixing=dt.Chi0Mixing()),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "returned"
        except NotImplementedError as err:
            out[name] = "13b" if "item 13b" in str(err) else f"other: {err}"
    return out


def main():
    rank, world, rdzv, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    multihost.initialize(num_processes=world, process_id=rank, init_method=f"file://{rdzv}")
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard
    out = {"backend": torch.distributed.get_backend()}
    kmesh = kpoint_mesh(world)
    kb = init_device_mesh("cpu", (1, world), mesh_dim_names=("kpts", "bands"))

    # a. the LOBPCG SCF on 8 k-points, 4 a rank
    basis = make.kpts_basis(dt, device="cpu")
    distribute(basis, kmesh)
    res = timed(out, "a", lambda: dt.self_consistent_field(basis, seed=7, **make.LOBPCG_SCF))
    out["a"] = dict(total_energy=res.total_energy, converged=res.converged, n_iter=res.n_iter,
                    rows=list(basis.data.mask.shape), local_psi=list(res.psi.shape),
                    eigenvalues_sorted=np.sort(res.eigenvalues, axis=None).tolist(),
                    rho=res.rho.numpy().ravel().tolist(),
                    forces=dt.compute_forces_cart(res).numpy().tolist())

    # e. the multihost API on that state, and the refusals
    lo, hi = multihost.local_kpoint_slice(basis.n_kpoints)
    psi_all = torch.as_tensor(multihost.fetch(res.psi, basis))
    out["e"] = dict(
        slice=[lo, hi], comm_slice=[basis.comm.lo, basis.comm.hi],
        fetch_rows=multihost.fetch(res.psi.abs().sum(-1), basis).tolist(),
        fetch_eigenvalues=multihost.fetch(torch.as_tensor(res.eigenvalues[lo:hi]),
                                          basis).tolist(),
        fetch_replicated=multihost.fetch(res.rho[0, 0, 0]).tolist(),
        eigenvalues=res.eigenvalues.tolist(),
        shard_orbitals=bool(torch.equal(shard_orbitals(psi_all, kmesh), res.psi)),
        replicate=[str(replicate(res.eigenvalues, kmesh).device),
                   bool(np.array_equal(replicate(res.eigenvalues, kmesh).numpy(),
                                       res.eigenvalues))],
        orbital_sharding=[orbital_sharding(kmesh) == (Shard(0),),
                          orbital_sharding(kb) == (Shard(0), Shard(1))],
        refusals=refusals(res, basis))

    # e. whole-suite mesh mode: DFTK_TPU_MESH distributes every new basis
    os.environ["DFTK_TPU_MESH"] = str(world)
    auto = make.kpts_basis(dt, device="cpu")
    del os.environ["DFTK_TPU_MESH"]
    out["e"]["auto"] = [auto.comm.ksize, auto.comm.bsize, list(auto.data.mask.shape)]
    sd = shard_split_data(prepare_split_data(make.kpts_basis(dt, device="cpu")), kmesh)
    out["e"]["split_data"] = [sd.comm.lo, sd.comm.hi, list(sd.basis_data.mask.shape),
                              list(sd.terms.data.P.shape[:1]), list(sd.pruned.inv_idx.shape[:1])]

    # b. 3 irreducible k-points padded to 4
    basis = make.padded_basis(dt, device="cpu")
    n_irr = basis.n_kpoints
    distribute(basis, kmesh)
    res = timed(out, "b", lambda: dt.self_consistent_field(basis, seed=3, **make.LOBPCG_SCF))
    out["b"] = dict(n_irreducible=n_irr, n_kpoints=basis.n_kpoints,
                    kweights=basis.kweights.tolist(), total_energy=res.total_energy,
                    converged=res.converged)

    # c. the split SCF on a (1, 2) kpts x bands mesh, and its forces
    basis = make.dryrun_basis(dt, device="cpu")
    res = timed(out, "c", lambda: self_consistent_field_split(basis, mesh=kb, **make.SPLIT_SCF))
    F = compute_forces_split(basis, prepare_split_data(basis), res["U"], res["occupation"],
                             res["rho"])
    out["c"] = dict(total_energy=res["energies"]["total"], converged=res["converged"],
                    n_iter=res["n_iter"], n_bands_block=int(res["U"].shape[1]),
                    forces=F.numpy().tolist())

    # d. the k-grid HF helium split SCF, one k-point a rank
    basis = make.hf_basis(dt, device="cpu")
    res = timed(out, "d", lambda: self_consistent_field_split(basis, mesh=kmesh, **make.HF_SCF))
    out["d"] = dict(total_energy=res["energies"]["total"], converged=res["converged"],
                    n_iter=res["n_iter"], rows=list(basis.data.mask.shape))

    # f. displaced Si2: the k sum of the nonlocal forces
    basis = make.displaced_basis(dt, "r2SCAN", "pbe/si-q4", device="cpu")
    distribute(basis, kmesh)
    res = timed(out, "f", lambda: dt.self_consistent_field(basis, seed=5, **make.LOBPCG_SCF))
    out["f"] = dict(total_energy=res.total_energy, converged=res.converged,
                    rows=list(basis.data.mask.shape),
                    forces_cart=dt.compute_forces_cart(res).numpy().tolist())
    basis = make.displaced_basis(dt, device="cpu")
    res = timed(out, "f_split",
                lambda: self_consistent_field_split(basis, mesh=kmesh,
                                                       **make.FORCES_SPLIT_SCF))
    F = compute_forces_split(basis, prepare_split_data(basis), res["U"], res["occupation"],
                             res["rho"])
    out["f"]["split"] = dict(total_energy=res["energies"]["total"], converged=res["converged"],
                             forces=F.numpy().tolist())

    # g. smeared collinear PBE+U: the gathered Fermi level, the entropy, the
    # Hubbard occupation matrix and the density summed over spin rows
    basis = make.spin_hubbard_basis(dt, device="cpu")
    distribute(basis, kmesh)
    rho0 = guess_density(basis, make.MAGNETIC_MOMENTS)
    res = timed(out, "g", lambda: dt.self_consistent_field(basis, seed=9, rho=rho0,
                                                           **make.LOBPCG_SCF))
    out["g"] = dict(total_energy=res.total_energy, converged=res.converged, epsF=res.epsF,
                    energies=res.energies, kspin=basis.data.kspin.tolist(),
                    rho=res.rho.numpy().ravel().tolist())

    everyone = [None] * world
    torch.distributed.all_gather_object(everyone, out)
    if rank == 0:
        with open(path, "w") as f:
            json.dump(everyone, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
