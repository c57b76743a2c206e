"""dftk_tpu_torch's checkpoints, exporters, plots and utilities against the
JAX package.

Torch at one thread, float64, against tests/data/torch_port_post.json
(entry `io`, recorded by tests/data/make_torch_port_post.py):
  * `load_scfres` rebuilds tests/test_io.py's silicon from
    tests/data/torch_port_post_scfres.npz (written by the JAX package's
    `save_scfres`) and the SCF restarted from it converges at once to the
    saved energy; the port's own `.npz` and `.json` then load in the JAX
    package's numpy-only loader with the same keys and meta;
  * `save_vts` writes the JAX package's bytes for the same arrays;
  * the Wannier90 `.eig`, `.mmn` and `.amn` numbers equal the JAX
    package's within 1e-12 (one unit of their last printed digit) on the
    same seeded orbitals, and `write_unk_files` keeps the orbitals' norm;
  * the plots write their files; the timer, `trace_scope`, `versioninfo`,
    `memory_usage`, `todict`, the SCF checkpoint callback and the SCF's
    debug dump (DFTK_TPU_DEBUG_DUMP) work on the CPU.
"""
import hashlib
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import dftk_tpu_torch as dt
from dftk_tpu_torch.external import wannier

DATA = pathlib.Path(__file__).parent / "data"
_spec = importlib.util.spec_from_file_location("make_post", DATA / "make_torch_port_post.py")
make = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(make)
with open(DATA / "torch_port_post.json") as _f:
    REF = json.load(_f)["io"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.set_num_threads(1)   # tier-1 runs 6 xdist workers on 8 cores


def test_scfres_across_packages(tmp_path):
    from dftk_tpu.io.scfres import load_scfres as jax_load_scfres   # numpy and json only
    loaded = dt.load_scfres(DATA / REF["scfres_npz"], device="cpu")
    basis = loaded["basis"]
    assert basis.fft_size == (15, 15, 15) and basis.device.type == "cpu"
    assert abs(loaded["energies"]["total"] - REF["total_energy"]) == 0.0
    res = dt.self_consistent_field(basis, tol=1e-7, is_converged="energy",
                                   rho=torch.as_tensor(loaded["rho"]),
                                   psi=torch.as_tensor(loaded["psi"]))
    print(f"restart: {res.n_iter} iterations, E diff {res.total_energy - REF['total_energy']:.1e}")
    assert res.n_iter <= 2 and abs(res.total_energy - REF["total_energy"]) < 1e-8

    fn = tmp_path / "scfres.npz"
    dt.save_scfres(fn, res)
    back = jax_load_scfres(fn, rebuild_basis=False)
    mine = dt.load_scfres(fn, rebuild_basis=False)
    assert set(back) == set(mine)
    assert back["meta"] == mine["meta"] == json.loads(json.dumps(mine["meta"]))
    np.testing.assert_array_equal(back["rho"], res.rho.numpy())
    np.testing.assert_array_equal(back["psi"], res.psi.numpy())
    assert back["meta"]["model"] == dt.todict(basis.model)
    dt.save_scfres(tmp_path / "scfres.json", res)
    meta = json.loads((tmp_path / "scfres.json").read_text())
    assert meta == back["meta"] and "total" in meta["energies"]


def test_vts_same_bytes(tmp_path):
    basis = make.io_basis(dt, device="cpu")
    rho, extra = make.vts_fields(basis)
    path = tmp_path / "si.vts"
    dt.save_vts(str(path), make.FakeResult(basis=basis, rho=torch.as_tensor(rho)),
                extra_fields={"extra": torch.as_tensor(extra)})
    assert hashlib.sha256(path.read_bytes()).hexdigest() == REF["vts_sha256"]


def test_wannier_against_jax(tmp_path):
    wb = make.wannier_basis(dt, device="cpu")
    psi = torch.as_tensor(make.seeded_orbitals(wb.mask_np, 4, 9))
    ev = np.sort(np.random.default_rng(10).uniform(-0.2, 0.5, size=(wb.n_kpoints, 4)), axis=1)
    got = make.write_wannier(wannier, wb, psi, ev, str(tmp_path))
    for key, want in REF["wannier"].items():
        want = make.from_b64(want)
        assert got[key].shape == want.shape, key
        diff = np.abs(got[key] - want).max()
        print(f"wannier {key}: max diff from JAX {diff:.1e}")
        assert diff <= 1e-12 * (1 + 1e-6), key
    win = (tmp_path / "si.win").read_text()
    assert "num_wann   4" in win and "begin kpoints" in win and "mp_grid : 2 2 2" in win
    res = make.FakeResult(basis=wb, psi=psi)
    files = wannier.write_unk_files(res, bands=1, dirname=str(tmp_path))
    assert len(files) == wb.n_kpoints
    data = np.loadtxt(files[0], skiprows=1)
    u0 = data[:, 0] + 1j * data[:, 1]
    assert np.sum(np.abs(u0) ** 2) * wb.dvol == pytest.approx(1.0, rel=1e-6)


def test_plots_write_files(tmp_path):
    from dftk_tpu_torch.postprocess import plotting
    basis = make.io_basis(dt, device="cpu")
    kpath = dt.irrfbz_path(basis.model.lattice, 2)
    ev = np.linspace(-0.2, 0.4, len(kpath.kcoords) * 4).reshape(-1, 4)
    plotting.plot_bandstructure(dict(kcoords=kpath.kcoords, basis=basis, eigenvalues=ev,
                                     kpath=kpath, epsF=0.1), path=tmp_path / "bands.png")
    eps, dos = dt.postprocess.dos.plot_dos_data(basis, ev[:4])
    plotting.plot_dos(eps=eps, dos=dos, path=tmp_path / "dos.png")
    res = make.FakeResult(history_Etot=[-7.0, -7.5, -7.6], history_Drho=[1e-1, 1e-3, 1e-6])
    plotting.plot_scf_convergence(res, path=tmp_path / "scf.png")
    for name in ("bands.png", "dos.png", "scf.png"):
        assert (tmp_path / name).stat().st_size > 1000


def test_timer_and_utilities():
    from dftk_tpu_torch.utils.timer import Timer, trace_scope
    t = Timer()
    with t.section("a"):
        torch.ones(10).sum()
    with t.section("a"):
        pass
    assert t.counts["a"] == 2 and t.totals["a"] >= 0.0 and "a" in t.report()
    dt.timer.reset()
    with trace_scope("scope"):
        pass
    assert dt.timer.counts["scope"] == 1
    dt.timer.reset()
    info = dt.versioninfo()
    assert f"torch {torch.__version__}" in info and "cpu (no CUDA device)" in info
    basis = make.io_basis(dt, device="cpu")
    assert dt.memory_usage(basis.data) == sum(x.numel() * x.element_size() for x in basis.data)
    d = dt.todict(basis)
    json.dumps(d)
    assert d["fft_size"] == [15, 15, 15] and d["model"]["n_electrons"] == 8


def test_debug_dump_and_checkpoints(tmp_path, monkeypatch):
    from dftk_tpu_torch.io.scfres import ScfSaveCheckpoints
    from dftk_tpu_torch.utils.debugdump import load_dump
    monkeypatch.setenv("DFTK_TPU_DEBUG_DUMP", str(tmp_path / "dumps"))
    basis = dt.PlaneWaveBasis(make.si2_model(dt), Ecut=4.0, kgrid=(1, 1, 1), device="cpu")
    saved = {}
    ckpt = ScfSaveCheckpoints(str(tmp_path / "ckpt.npz"))
    cb = ckpt.make_callback(basis, lambda: dict(saved))

    def callback(info):
        saved.update(rho=np.zeros((1,) + basis.fft_size), eigenvalues=np.zeros((1, 4)),
                     energies={"total": info["E"]}, n_iter=info["n_iter"])
        cb(info)

    res = dt.self_consistent_field(basis, tol=1e-12, maxiter=2, callback=callback)
    assert not res.converged
    dumps = list((tmp_path / "dumps").glob("scf-not-converged-*.npz"))
    assert len(dumps) == 1
    d = load_dump(dumps[0])
    assert d["meta"]["n_iter"] == 2 and d["rho"].shape == (1,) + basis.fft_size
    assert dt.load_scfres(tmp_path / "ckpt.npz", rebuild_basis=False)["meta"]["n_iter"] == 2
