"""Save / load SCF results (checkpoint + resume).

Port of `dftk_tpu/io/scfres.py` (reference `src/scf/scfres.jl`,
`src/input_output.jl`), with the JAX package's file format exactly, so
that a file saved by either package loads in the other:
  * .npz  - full binary state (psi, or the split SCF's U; rho,
    occupations, eigenvalues; the `meta` JSON recipe of the model and
    basis needed to rebuild them), suitable for restart
  * .json - scalar summary (the `meta` JSON alone)
  * .vts  - the density for ParaView (`io/vtk.py`)

`load_scfres` rebuilds the PlaneWaveBasis from the stored recipe on
`device` and returns a dict mirroring SCFResult with numpy arrays;
`self_consistent_field(..., rho=, psi=)` resumes from it (the analogue of
DFTK's kwargs_scf_checkpoints).
"""
import json

import numpy as np

from ..utils import to_numpy
from ..parallel.mesh import refuse_distributed


def _getter(obj):
    if isinstance(obj, dict):
        return lambda k, d=None: obj.get(k, d)
    return lambda k, d=None: getattr(obj, k, d)


def _model_recipe(model):
    atoms = []
    for at in model.atoms:
        entry = {"type": type(at).__name__}
        if hasattr(at, "psp"):
            entry["symbol"] = at.symbol
            entry["psp_identifier"] = at.psp.identifier
            entry["psp_text"] = None
        elif hasattr(at, "Z"):
            entry["Z"] = at.Z
        if hasattr(at, "alpha"):
            entry["alpha"] = at.alpha
            entry["L"] = at.L
        atoms.append(entry)
    return {
        "lattice": np.asarray(model.lattice).tolist(),
        "positions": [np.asarray(p).tolist() for p in model.positions],
        "atoms": atoms,
        "n_electrons": model.n_electrons,
        "temperature": model.temperature,
        "spin_polarization": model.spin_polarization,
        "smearing": type(model.smearing).__name__,
        "functionals": _functional_names(model),
    }


def _functional_names(model):
    from ..ops.terms import Xc
    for t in model.term_types:
        if isinstance(t, Xc):
            return list(t.functionals)
    return []


def _meta(basis, get):
    return {
        "model": _model_recipe(basis.model),
        "Ecut": basis.Ecut,
        "fft_size": list(basis.fft_size),
        "kcoords": np.asarray(basis.kcoords).tolist(),
        "kweights": np.asarray(basis.kweights_irr).tolist(),
        "energies": get("energies"),
        "epsF": float(get("epsF", 0.0)),
        "converged": bool(get("converged", False)),
        "n_iter": int(get("n_iter", 0)),
    }


def save_scfres(filename, scfres):
    """Save an SCFResult (or the dict the split SCF returns)."""
    get = _getter(scfres)
    basis = get("basis")
    refuse_distributed(basis, "save_scfres")
    meta = _meta(basis, get)

    if str(filename).endswith(".json"):
        with open(filename, "w") as f:
            json.dump(meta, f, indent=1)
        return
    if str(filename).endswith(".vts"):
        from .vtk import save_vts
        save_vts(filename, scfres)
        return

    psi = get("psi", get("U"))
    np.savez_compressed(
        filename,
        meta=json.dumps(meta),
        psi=to_numpy(psi) if psi is not None else np.zeros(0),
        rho=to_numpy(get("rho")),
        eigenvalues=np.asarray(get("eigenvalues")),
        occupation=to_numpy(get("occupation", np.zeros(0))),
    )


def load_scfres(filename, rebuild_basis=True, device="cuda"):
    """Load a .npz snapshot; optionally rebuild the basis on `device`
    (`PlaneWaveBasis`'s default, the CUDA card) for resuming."""
    with np.load(filename, allow_pickle=False) as data:
        meta = json.loads(str(data["meta"]))
        out = {
            "meta": meta,
            "psi": data["psi"],
            "rho": data["rho"],
            "eigenvalues": data["eigenvalues"],
            "occupation": data["occupation"],
            "energies": meta["energies"],
            "epsF": meta["epsF"],
            "converged": meta["converged"],
        }
    if rebuild_basis:
        out["basis"] = _rebuild_basis(meta, device)
    return out


def _rebuild_basis(meta, device):
    from .. import Smearing
    from ..basis import PlaneWaveBasis
    from ..bzmesh import ExplicitKpoints
    from ..models.elements import ElementCoulomb, ElementGaussian, ElementPsp
    from ..models.psp_hgh import load_psp
    from ..models.standard import model_atomic, model_DFT
    m = meta["model"]
    atoms = []
    for entry in m["atoms"]:
        if entry["type"] == "ElementPsp":
            key = entry["psp_identifier"]
            try:
                psp = load_psp(key)
            except (KeyError, FileNotFoundError, OSError) as exc:
                raise ValueError(
                    f"cannot rebuild pseudopotential {key!r} on checkpoint "
                    f"reload (lincomb/VCA and ad-hoc psps are not "
                    f"reconstructible from their identifier); rebuild the "
                    f"basis manually and pass rebuild_basis=False") from exc
            atoms.append(ElementPsp.from_symbol(entry["symbol"], psp=psp))
        elif entry["type"] == "ElementCoulomb":
            atoms.append(ElementCoulomb(Z=entry["Z"]))
        else:
            atoms.append(ElementGaussian(alpha=entry["alpha"], L=entry["L"]))
    smearing = getattr(Smearing, m["smearing"], None)
    model = (model_DFT if m["functionals"] else model_atomic)(
        np.array(m["lattice"]), atoms,
        [np.array(p) for p in m["positions"]],
        temperature=m["temperature"],
        **({"functionals": m["functionals"]} if m["functionals"] else {}),
        spin_polarization=m["spin_polarization"],
        smearing=smearing() if smearing else None,
    )
    kgrid = ExplicitKpoints(meta["kcoords"], meta["kweights"])
    return PlaneWaveBasis(model, Ecut=meta["Ecut"], kgrid=kgrid,
                          fft_size=tuple(meta["fft_size"]), device=device)


def todict(obj):
    """JSON-serialisable dict of a Model / PlaneWaveBasis / SCFResult
    (counterpart of the reference's todict! exporters, input_output.jl)."""
    from ..basis import PlaneWaveBasis
    from ..models.model import Model
    if isinstance(obj, Model):
        return _model_recipe(obj)
    if isinstance(obj, PlaneWaveBasis):
        return {
            "model": _model_recipe(obj.model),
            "Ecut": obj.Ecut, "fft_size": list(obj.fft_size),
            "kcoords": np.asarray(obj.kcoords).tolist(),
            "kweights": np.asarray(obj.kweights_irr).tolist(),
            "nG_max": int(obj.nG_max),
            "n_symmetries": len(obj.symmetries),
        }
    # scfres-like
    get = _getter(obj)
    return {
        "energies": get("energies"),
        "epsF": float(get("epsF", 0.0)),
        "converged": bool(get("converged", False)),
        "n_iter": int(get("n_iter", 0)),
        "eigenvalues": np.asarray(get("eigenvalues")).tolist(),
        "occupation": to_numpy(get("occupation")).tolist(),
        "basis": todict(get("basis")) if get("basis") is not None else None,
    }


class ScfSaveCheckpoints:
    """SCF callback writing a restartable checkpoint each iteration.

    `make_callback(basis, state_getter)` gives a `self_consistent_field`
    callback; state_getter() returns the dict to save (psi, rho,
    eigenvalues, occupation, energies ...), to which the basis is added.
    """

    def __init__(self, filename, scfres_provider=None, keep=False):
        self.filename = filename
        self.keep = keep

    def make_callback(self, basis, state_getter):
        def cb(info):
            state = state_getter()
            state["basis"] = basis
            save_scfres(self.filename, state)
        return cb
