"""The JAX package's CPU values that tests/data/torch_port_setup.json records
for tests/test_torch_setup.py (entry `setup`) and tests/test_torch_probes.py
(entry `probes`), so that those files run no JAX code.

    JAX_PLATFORMS=cpu python tests/data/make_torch_port_setup.py ENTRY

prints one JSON line: the entry's values, its `command` and its CPU
seconds (wall seconds of the run on the host).  Run from the repository
root.  Arrays are stored as base64 of their little-endian bytes
(`from_b64`), large float tables as a fingerprint (`table_summary`).

`setup`: the JAX basis of Si2 at Ecut 7, fft_size (18, 18, 18),
MonkhorstPack((2, 2, 2)), no symmetry (`si2_basis`): its index and mask
arrays, the pruned maps, the terms' tables, the guess density, the UPF
fields, the five smearings on SMEARING_X and the grid maps on seeded
inputs.  Run with DFTK_TPU_X64=1.

`probes`: tools/probe_pallas_fixed.py, probe_kernel_pipe.py,
probe_kernel_variants.py and probe_kernel_incr.py run at the SMALL shape
globals with every Pallas call recorded in interpret mode (`capture`; the
tools are loaded from their files and not edited): the inputs and output
of each call the tests hold, the repaired k_dots reference, k_mdim's
inputs through the k_full body, and the FAIL lines the JAX run prints.
Run without DFTK_TPU_X64 (the probes are float32).
This script imports the JAX package, so it lives outside both packages.
"""
import base64
import contextlib
import importlib.util
import io
import json
import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
TOOLS = ROOT / "tools"
A_SI = 5.131570667152971
SI_LATTICE = np.array([[0.0, A_SI, A_SI], [A_SI, 0.0, A_SI], [A_SI, A_SI, 0.0]])
SI_POSITIONS = [np.ones(3) / 8, -np.ones(3) / 8]
SI_UPF = str(ROOT / "tests" / "data" / "pseudos" / "gth" / "Si.pbe-hgh.upf")
SMEARINGS = ["NoSmearing", "FermiDirac", "Gaussian", "MarzariVanderbilt", "MethfesselPaxton"]
SMEARING_X = np.linspace(-6.0, 6.0, 49)
SMALL = dict(m1=4, m2=4, n1=8, n2=8, n3=8, nbt=8)
# (tool, kernel, grid) of every recorded call the tests hold; grid None: the first
PROBE_CALLS = [("probe_pallas_fixed", "k0", (8,)), ("probe_kernel_pipe", "k0", (8,)),
               ("probe_kernel_pipe", "k0", (1,)), ("probe_kernel_incr", "k0", (8,)),
               ("probe_kernel_incr", "k1", None), ("probe_kernel_incr", "k1b", None),
               ("probe_kernel_incr", "k2", None), ("probe_kernel_incr", "k3", None),
               ("probe_kernel_incr", "k4", None), ("probe_kernel_variants", "k_full", None),
               ("probe_kernel_variants", "k_rep", None), ("probe_kernel_pipe", "k4", (8,)),
               ("probe_kernel_pipe", "k4", (2,)), ("probe_kernel_pipe", "k4", (1,)),
               ("probe_kernel_variants", "k_full_bf", None),
               ("probe_kernel_variants", "k_mdim", None)]
FAIL_LINES = ["dots only (no repairs, f32)", "multi-dim dot absorbs fwd repair (f32)"]


def b64(a):
    a = np.ascontiguousarray(a)
    return dict(dtype=a.dtype.str, shape=list(a.shape),
                data=base64.b64encode(a.tobytes()).decode("ascii"))


def from_b64(d):
    return np.frombuffer(base64.b64decode(d["data"]), dtype=np.dtype(d["dtype"])).reshape(
        d["shape"])


def table_summary(a, n_sample=48):
    """A compact fingerprint of a real table a (any shape): its first
    element, its sum, its sum against seeded uniform weights, and its
    values at n_sample seeded flat indices."""
    a = np.asarray(a, dtype=float).ravel()
    rng = np.random.default_rng(a.size)
    w = rng.uniform(size=a.size)
    idx = rng.choice(a.size, size=min(n_sample, a.size), replace=False)
    return dict(size=int(a.size), first=float(a[0]), sum=float(a.sum()),
                wsum=float(w @ a), sample=a[idx].tolist())


def complex_summary(a):
    a = np.asarray(a)
    return dict(re=table_summary(a.real), im=table_summary(a.imag))


def si2_basis(pkg, **kw):
    Si = pkg.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    model = pkg.model_DFT(SI_LATTICE, [Si, Si], SI_POSITIONS,
                          functionals=["lda_x", "lda_c_vwn"], symmetries=False)
    return pkg.PlaneWaveBasis(model, Ecut=7.0, kgrid=pkg.MonkhorstPack((2, 2, 2)),
                              fft_size=(18, 18, 18), **kw)


def grid_inputs(basis):
    """The seeded G vectors [200, 3] and sphere coefficients [nk, 2, nG]
    of the grid-map checks."""
    G = np.random.default_rng(4).integers(-12, 13, size=(200, 3))
    rng = np.random.default_rng(5)
    shape = (basis.n_kpoints, 2, basis.nG_max)
    return G, rng.normal(size=shape) + 1j * rng.normal(size=shape)


def entry_setup():
    """The JAX side of tests/test_torch_setup.py."""
    import jax.numpy as jnp
    import dftk_tpu as dftk
    from dftk_tpu.models import smearing as jax_smearing
    from dftk_tpu.ops import fft as jax_fft
    from dftk_tpu.ops.density import guess_density
    from dftk_tpu.ops.engine_split import build_pruned_fft
    jb = si2_basis(dftk)
    jd, jt = jb.data, jb.terms.data
    pf = build_pruned_fft(jb, dtype=jnp.float64)
    G, c = grid_inputs(jb)
    cubes = [np.asarray(jax_fft.scatter_to_cube(jnp.asarray(c[k]), jd.Gidx[k], jd.mask[k],
                                                jb.fft_size)) for k in range(jb.n_kpoints)]
    Si = dftk.ElementPsp.from_symbol("Si", psp="lda/si-q4")
    magnetic = dftk.model_DFT(SI_LATTICE, [Si, Si], SI_POSITIONS, functionals=["lda_x"],
                              symmetries=True, magnetic_moments=[1.0, -1.0])
    upf = dftk.ElementPsp.from_symbol("Si", psp=SI_UPF).psp
    x = jnp.asarray(SMEARING_X)
    smear = {name: {f: np.asarray(getattr(getattr(jax_smearing, name)(), f)(x)).tolist()
                    for f in ("occupation", "entropy")} for name in SMEARINGS}
    return dict(
        fft_size=list(jb.fft_size), nG_max=int(jb.nG_max), kcoords=b64(jb.kcoords),
        kweights=b64(np.asarray(jb.kweights)), G_cube_cart=table_summary(jb.G_cube_cart),
        data={name: b64(np.asarray(getattr(jd, name)))
              for name in ("Gidx", "mask", "kin", "Gpk_cart", "kweights", "kspin")},
        m_shape=[int(F.shape[0]) for F in pf.Ff], Gidx_c=b64(np.asarray(pf.Gidx_c)),
        inv_idx=b64(np.asarray(pf.inv_idx)),
        terms=dict(vloc=table_summary(jt.vloc_static), hartree=table_summary(jt.hartree_coeffs),
                   P=complex_summary(jt.P), D=b64(np.asarray(jt.D)),
                   E_ewald=float(jb.terms.E_ewald),
                   E_psp_correction=float(jb.terms.E_psp_correction)),
        guess_density=table_summary(guess_density(jb)),
        magnetic_symmetries=len(magnetic.symmetries),
        upf=dict(Zion=upf.Zion, lmax=upf.lmax, h=[np.asarray(h).tolist() for h in upf.h],
                 rgrid=table_summary(upf.rgrid), n_rgrid=len(upf.rgrid)),
        smearing=smear,
        index_G=b64(np.asarray(jax_fft.index_G_vectors(jb.fft_size, G))),
        cubes=[complex_summary(cube) for cube in cubes])


class _Stop(Exception):
    pass


def capture(name, stop_after_first=False, loop1_run=False, small=SMALL):
    """Run tools/<name>.py's main() at the `small` shape globals with every
    Pallas call recorded in interpret mode; returns (module, records,
    printed).  stop_after_first: each call raises _Stop once recorded.
    DFTK_TPU_X64 is "0" during the run unless it is set (the probes are
    float32).  tests/test_torch_probes_{fused,ops,mosaic}.py capture their
    tools with it inside the test."""
    import jax
    from jax.experimental import pallas as pl
    records = []
    real = pl.pallas_call

    def recorder(kernel, **kw):
        f = real(kernel, interpret=True, **kw)

        def call(*args):
            rec = dict(name=kernel.__name__, kernel=kernel, kw=kw,
                       args=[np.array(a) for a in args])
            records.append(rec)
            out = f(*args)
            rec["out"] = np.asarray(out)
            if stop_after_first:        # a message: the tools print its first line
                raise _Stop("stopped after the first recorded call")
            return out
        return call

    saved_path, saved_x64 = list(sys.path), os.environ.get("DFTK_TPU_X64")
    os.environ["DFTK_TPU_X64"] = saved_x64 or "0"
    pl.pallas_call = recorder
    try:
        spec = importlib.util.spec_from_file_location(f"_jax_{name}", TOOLS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for k, v in small.items():
            setattr(mod, k, v)
        if hasattr(mod, "LOOP"):
            mod.LOOP = 1
        if loop1_run:          # probe_kernel_pipe's run() takes its loop length
            run = mod.run
            mod.run = lambda nm, f, extra, loop=1: run(nm, f, extra, loop=1)
        np.random.seed(0)
        buf = io.StringIO()
        with jax.disable_jit(), contextlib.redirect_stdout(buf):
            try:
                mod.main()
            except _Stop:
                pass
    finally:
        pl.pallas_call = real
        sys.path[:] = saved_path
        if saved_x64 is None:
            del os.environ["DFTK_TPU_X64"]
        else:
            os.environ["DFTK_TPU_X64"] = saved_x64
    return mod, records, buf.getvalue()


def first_record(records, name, grid=None):
    for r in records:
        if r["name"] == name and "out" in r and (grid is None or tuple(r["kw"]["grid"]) == grid):
            return r
    raise AssertionError(f"no recorded call of {name} (grid {grid})")


def entry_probes():
    """The JAX side of tests/test_torch_probes.py."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    captured = {"probe_pallas_fixed": capture("probe_pallas_fixed", stop_after_first=True),
                "probe_kernel_pipe": capture("probe_kernel_pipe", loop1_run=True),
                "probe_kernel_variants": capture("probe_kernel_variants"),
                "probe_kernel_incr": capture("probe_kernel_incr")}
    calls = []
    for tool, kernel, grid in PROBE_CALLS:
        recs = captured[tool][1]
        rec = (next(r for r in recs if r["name"] == kernel) if kernel == "k_mdim"
               else first_record(recs, kernel, grid))
        calls.append(dict(tool=tool, kernel=kernel, grid=list(rec["kw"]["grid"]),
                          args=[b64(a) for a in rec["args"]],
                          out=b64(rec["out"]) if "out" in rec else None))
    # k_dots (tools/probe_kernel_variants.py:84-93) with its two shape faults
    # repaired: B read as [2m1, n2] (not [2n1, m1]), and V[z][:, 0] one scale
    # per n1 row of C [n1, 2, n2] (not a 5-D broadcast)
    mod, records, printed = captured["probe_kernel_variants"]
    full = first_record(records, "k_full")
    t, V, F2f, F1f, F1b, F2b = (jnp.asarray(a) for a in full["args"])
    n3, m2, _, m1, nbt = t.shape
    n1, n2 = V.shape[1:]
    planes = []
    for z in range(n3):
        A = t[z].reshape(2 * m2, m1, nbt)
        B = mod.dot_hi(F2f, A)
        C = mod.dot_hi(F1f, B.reshape(2 * m1, n2, nbt))
        Cv = C.reshape(n1, 2, n2, nbt) * V[z][:, 0][:, None, None, None]
        D = mod.dot_hi(F1b, Cv.reshape(2 * n1, n2, nbt))
        planes.append(mod.dot_hi(F2b, D.reshape(2 * n2, m1, nbt)).reshape(m2, 2, m1, nbt))
    dots_ref = np.asarray(jnp.stack(planes))
    # k_mdim's inputs (4-D factors viewed as 2-D) through the k_full body
    mdim = next(r for r in records if r["name"] == "k_mdim")
    t, V, F2f, F1f4, F1b4, F2b = mdim["args"]
    n1, _, m1, _ = F1f4.shape
    args = [t, V, F2f, F1f4.reshape(2 * n1, 2 * m1), F1b4.reshape(2 * m1, 2 * n1), F2b]
    mdim_ref = np.asarray(pl.pallas_call(full["kernel"], interpret=True, **full["kw"])(
        *(jnp.asarray(a) for a in args)))
    # each row up to its verdict (the messages after it name the host's paths)
    rows = {line: next(r for r in printed.splitlines() if r.startswith(line))
            for line in FAIL_LINES}
    fails = {line: row[:row.index(":", len(line)) + 6] for line, row in rows.items()}
    return dict(small=SMALL, calls=calls, dots_ref=b64(dots_ref), mdim_ref=b64(mdim_ref),
                fail_rows=fails)


if __name__ == "__main__":
    name = sys.argv[1]
    sys.path[:0] = [str(ROOT)]
    t0 = time.time()
    values = globals()["entry_" + name]()
    values["description"] = " ".join(globals()["entry_" + name].__doc__.split())
    values["cpu_seconds"] = time.time() - t0
    x64 = "DFTK_TPU_X64=1 " if name == "setup" else ""
    values["command"] = (f"{x64}JAX_PLATFORMS=cpu python "
                         f"tests/data/make_torch_port_setup.py {name}")
    print(json.dumps({name: values}, default=float), flush=True)
