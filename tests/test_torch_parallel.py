"""dftk_tpu_torch's k-point x band parallel path on two gloo ranks.

One pair of processes (tests/torch_parallel_ranks.py) joins a gloo process
group through a file rendezvous under the test's tmp_path (no port to
collide between xdist workers), runs every cell once at one torch thread,
and rank 0 writes both ranks' results to one JSON that the cases read.  A
hung rendezvous fails the module at the subprocess timeout.  The bars are
the JAX package's own (tests/test_parallel.py and the sharper ones of
`__graft_entry__.py::dryrun_multichip`), against its single-device float64
values in tests/data/torch_port_parallel.json (each entry's `command`
reruns tests/data/make_torch_port_parallel.py):

  a. self_consistent_field on a ("kpts",) mesh of 2 (Si2, Ecut 5, 16^3,
     8 unreduced k-points): energy 1e-9 Ha, sorted eigenvalues and density
     1e-8, the same on both ranks;
  b. the symmetry-reduced 2x2x2 grid (3 k-points) padded to 4 by
     `distribute`: weights sum to 1 within 1e-12, energy 1e-9 Ha;
  c. self_consistent_field_split in complex128 on a ("kpts", "bands") mesh
     of (1, 2) (the dry run's cell, Ecut 3, 12^3, 8 k-points, 6 bands, tol
     1e-12): energy 1e-9 Ha, compute_forces_split 1e-7 Ha/bohr;
  d. the k-grid HF helium split SCF on ("kpts",) of 2: energy 1e-9 Ha;
  e. local_kpoint_slice partitions the padded list, fetch returns the full
     eigenvalues on both ranks, equal to each other, DFTK_TPU_MESH
     distributes a new basis over the ranks, shard_split_data and
     shard_orbitals keep each rank's rows, replicate and orbital_sharding
     give the replicated tensor and the placements;
  f. (in test_kpoint_scf and test_split_kpts_bands) displaced Si2 on
     ("kpts",) of 2, forces of order 1e-2 Ha/bohr, whose nonlocal part is
     the all-reduced k sum: compute_forces_cart of the r2SCAN (meta-GGA
     tau) self_consistent_field and compute_forces_split of the LDA split
     SCF, 1e-7 Ha/bohr, energies 1e-9 Ha;
  g. (in test_kpoint_scf) the smeared collinear C2 PBE+U
     self_consistent_field on ("kpts",) of 2, the spin-up k rows on one
     rank and the spin-down ones on the other (the gathered Fermi level,
     the entropy's and the Hubbard occupation matrix's k sums): energy
     1e-9 Ha, density 1e-8;
  h. the entry points without k-point reductions raise NotImplementedError
     naming ROADMAP item 13b on the distributed state.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

HERE = pathlib.Path(__file__).parent
with open(HERE / "data" / "torch_port_parallel.json") as _f:
    REF = json.load(_f)
WORLD = 2
TIMEOUT = 240        # seconds for the pair; the cells take ~10 s on one thread


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(HERE / "torch_parallel_ranks.py"), str(r),
                               str(WORLD), str(d / "rdzv"), str(d / "out.json")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(l[-3000:] for l in logs)
    with open(d / "out.json") as f:
        out = json.load(f)
    print("cell seconds per rank:", [o["seconds"] for o in out])
    return out


def _same_on_ranks(out, cell, key):
    values = [np.asarray(o[cell][key], dtype=float) for o in out]
    for v in values[1:]:
        assert np.array_equal(v, values[0]), (cell, key)
    return values[0]


def test_kpoint_scf(ranks):
    ref = REF["lobpcg"]
    for o in ranks:
        assert o["backend"] == "gloo"
        assert o["a"]["converged"] and o["a"]["rows"][0] == 4
    E = _same_on_ranks(ranks, "a", "total_energy")
    assert abs(E - ref["total_energy"]) < 1e-9
    eig = _same_on_ranks(ranks, "a", "eigenvalues_sorted")
    np.testing.assert_allclose(eig, ref["eigenvalues_sorted"], atol=1e-8, rtol=0)
    rho = _same_on_ranks(ranks, "a", "rho")
    np.testing.assert_allclose(rho, ref["rho"], atol=1e-8, rtol=0)
    # Si2 at its ideal sites: the forces vanish, their k sum all-reduced
    assert np.abs(_same_on_ranks(ranks, "a", "forces")).max() < 1e-7
    # f: displaced, under r2SCAN
    ref = REF["forces"]
    for o in ranks:
        assert o["f"]["converged"] and o["f"]["rows"][0] == 4
    assert abs(_same_on_ranks(ranks, "f", "total_energy") - ref["total_energy"]) < 1e-9
    F = _same_on_ranks(ranks, "f", "forces_cart")
    assert np.abs(np.asarray(ref["forces_cart"])).max() > 1e-2
    assert np.abs(F - np.asarray(ref["forces_cart"])).max() < 1e-7
    # g: smeared, collinear, +U
    ref = REF["spin"]
    for o in ranks:
        assert o["g"]["converged"]
        assert len(set(o["g"]["kspin"])) == 1     # one spin's rows a rank
    assert {o["g"]["kspin"][0] for o in ranks} == {0, 1}
    assert abs(_same_on_ranks(ranks, "g", "total_energy") - ref["total_energy"]) < 1e-9
    assert ranks[0]["g"]["energies"] == ranks[1]["g"]["energies"]
    for key in ("Entropy", "Hubbard"):
        assert abs(ranks[0]["g"]["energies"][key] - ref["energies"][key]) < 1e-9, key
    rho = _same_on_ranks(ranks, "g", "rho")
    np.testing.assert_allclose(rho, ref["rho"], atol=1e-8, rtol=0)


def test_phantom_padding(ranks):
    ref = REF["lobpcg"]["padded"]
    for o in ranks:
        b = o["b"]
        assert b["n_irreducible"] == ref["n_kpoints"] == 3 and b["n_kpoints"] == 4
        assert b["kweights"][3] == 0.0
        np.testing.assert_allclose(b["kweights"][:3], ref["kweights"], rtol=0, atol=1e-15)
        assert abs(sum(b["kweights"]) - 1.0) < 1e-12
        assert b["converged"]
    assert abs(_same_on_ranks(ranks, "b", "total_energy") - ref["total_energy"]) < 1e-9


def test_split_kpts_bands(ranks):
    ref = REF["split"]
    for o in ranks:
        assert o["c"]["converged"] and o["c"]["n_bands_block"] % WORLD == 0
    assert abs(_same_on_ranks(ranks, "c", "total_energy") - ref["total_energy"]) < 1e-9
    F = _same_on_ranks(ranks, "c", "forces")
    assert np.abs(F - np.asarray(ref["forces"])).max() < 1e-7
    # f: displaced, on ("kpts",) of 2
    ref = REF["forces"]["split"]
    for o in ranks:
        assert o["f"]["split"]["converged"]
    values = [o["f"]["split"] for o in ranks]
    assert values[0] == values[1]
    assert abs(values[0]["total_energy"] - ref["total_energy"]) < 1e-9
    F = np.asarray(values[0]["forces"])
    assert np.abs(np.asarray(ref["forces"])).max() > 1e-2
    assert np.abs(F - np.asarray(ref["forces"])).max() < 1e-7


def test_hf_kgrid(ranks):
    ref = REF["split"]["hf"]
    for o in ranks:
        assert o["d"]["converged"] and o["d"]["rows"][0] == 1
    assert abs(_same_on_ranks(ranks, "d", "total_energy") - ref["total_energy"]) < 1e-9


def test_multihost_api(ranks):
    per = 8 // WORLD
    for r, o in enumerate(ranks):
        e = o["e"]
        assert e["slice"] == e["comm_slice"] == [r * per, (r + 1) * per]
        assert len(e["fetch_rows"]) == 8
        np.testing.assert_array_equal(e["fetch_eigenvalues"], e["eigenvalues"])
        assert e["shard_orbitals"] and e["replicate"] == ["cpu", True]
        assert e["orbital_sharding"] == [True, True]
        assert len(e["fetch_replicated"]) == 16
        assert e["auto"] == [WORLD, 1, [8 // WORLD, 256]]     # DFTK_TPU_MESH
        assert e["split_data"] == [r * per, (r + 1) * per, [per, 256], [per], [per]]
    for key in ("fetch_eigenvalues", "fetch_rows", "fetch_replicated"):
        _same_on_ranks(ranks, "e", key)


def test_refusals(ranks):
    for o in ranks:
        refused = o["e"]["refusals"]
        assert len(refused) == 8 and all(v == "13b" for v in refused.values()), refused
