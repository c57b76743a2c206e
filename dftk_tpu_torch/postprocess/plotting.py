"""Plot helpers for band structures, DOS and SCF convergence.

Port of `dftk_tpu/postprocess/plotting.py` (host numpy and matplotlib on
the returned arrays).  Counterpart of the reference's plotting extension
(ext/DFTKPlotsExt.jl: plot_bandstructure, plot_dos, plot_ldos).  Gated on matplotlib: importing
this module is always safe, the functions raise a clear error when
matplotlib is missing.  Each helper also ACCEPTS precomputed data so the
expensive DFT part and the plotting stay separable.
"""
import numpy as np


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:
        raise ImportError(
            "plot helpers need matplotlib (not installed in this "
            "environment); use the returned data arrays directly") from e


def _kpath_xaxis(band_data):
    """Cumulative cartesian k-distance + tick positions/labels."""
    kcoords = np.asarray(band_data["kcoords"], dtype=float)
    basis = band_data["basis"]
    B = 2 * np.pi * np.linalg.inv(np.asarray(basis.model.lattice).T)
    kc = kcoords @ B.T
    seg = np.linalg.norm(np.diff(kc, axis=0), axis=1)
    x = np.concatenate([[0.0], np.cumsum(seg)])
    ticks, ticklabels = [], []
    kpath = band_data.get("kpath")
    if kpath is not None and getattr(kpath, "labels", None):
        for i, lab in enumerate(kpath.labels):
            if lab:
                ticks.append(x[i])
                ticklabels.append("Γ" if lab == "G" else lab)
    return x, ticks, ticklabels


def plot_bandstructure(band_data, eps_ref=None, ylim=None, unit="hartree",
                       ax=None, path=None):
    """Band structure from compute_bands output (reference plot_bandstructure).

    eps_ref (default: the Fermi level in band_data) is subtracted.
    Returns the matplotlib Figure; saves to `path` if given.
    """
    plt = _mpl()
    ev = np.asarray(band_data["eigenvalues"], dtype=float)
    if eps_ref is None:
        eps_ref = band_data.get("epsF", 0.0) or 0.0
    scale = 27.211386245988 if unit in ("eV", "ev") else 1.0
    x, ticks, ticklabels = _kpath_xaxis(band_data)

    if ax is None:
        fig, ax = plt.subplots(figsize=(6, 4))
    else:
        fig = ax.figure
    for n in range(ev.shape[1]):
        ax.plot(x, (ev[:, n] - eps_ref) * scale, lw=1.0, color="#1f77b4")
    ax.axhline(0.0, color="grey", lw=0.6, ls="--")
    for t in ticks:
        ax.axvline(t, color="grey", lw=0.4)
    ax.set_xticks(ticks)
    ax.set_xticklabels(ticklabels)
    ax.set_xlim(x[0], x[-1])
    if ylim is not None:
        ax.set_ylim(*ylim)
    ax.set_ylabel(f"ε - εF ({'eV' if scale != 1.0 else 'Ha'})")
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
    return fig


def plot_dos(scfres=None, eps=None, dos=None, unit="hartree", ax=None,
             path=None, n_points=400, window=0.3):
    """DOS plot (reference plot_dos): either pass an scfres (the DOS is
    computed over [epsF - window, epsF + window]) or (eps, dos) arrays."""
    plt = _mpl()
    if dos is None:
        from .dos import compute_dos
        basis = scfres.basis
        epsF = scfres.epsF
        eps = np.linspace(epsF - window, epsF + window, n_points)
        dos = np.array([float(compute_dos(e, basis, scfres.eigenvalues))
                        for e in eps])
        eps = eps - epsF
    scale = 27.211386245988 if unit in ("eV", "ev") else 1.0
    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 3.5))
    else:
        fig = ax.figure
    ax.plot(np.asarray(eps) * scale, dos, lw=1.2)
    ax.axvline(0.0, color="grey", lw=0.6, ls="--")
    ax.set_xlabel(f"ε - εF ({'eV' if scale != 1.0 else 'Ha'})")
    ax.set_ylabel("DOS (states/Ha)")
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
    return fig


def plot_scf_convergence(scfres, ax=None, path=None):
    """Energy difference + density residual per SCF iteration."""
    plt = _mpl()
    E = np.asarray(scfres.history_Etot, dtype=float)
    drho = np.asarray(scfres.history_Drho, dtype=float)
    if ax is None:
        fig, ax = plt.subplots(figsize=(5, 3.5))
    else:
        fig = ax.figure
    it = np.arange(1, len(E) + 1)
    if len(E) > 1:
        ax.semilogy(it[1:], np.abs(np.diff(E)), "o-", label="|ΔE| (Ha)")
    ax.semilogy(it, drho, "s-", label="‖Δρ‖")
    ax.set_xlabel("SCF iteration")
    ax.legend()
    if path:
        fig.savefig(path, dpi=150, bbox_inches="tight")
    return fig
