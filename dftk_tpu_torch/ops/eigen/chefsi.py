"""Chebyshev-filtered subspace iteration (CheFSI) for large systems.

Port of `dftk_tpu/ops/eigen/chefsi.py` (Zhou, Saad, Tiago, Chelikowsky,
PRE 74 066704 (2006)) on complex tensors:

    X <- orthonormalize( p_m(H) X );  one Rayleigh-Ritz per cycle

where p_m is a degree-m Chebyshev polynomial that amplifies the wanted
part of the spectrum and damps [lb, ub].  Per cycle: m H applies, one
CholeskyQR2 (`lobpcg.ortho_qr`) and one nb x nb `torch.linalg.eigh`.

`lax.fori_loop` / `lax.cond` become Python loops over integer counts; the
JAX package's realified complex algebra (`csplit=True`,
`ops/eigen/csplit.py`) is a TPU workaround the port does not carry
(ROADMAP, "Not to port"): X is a complex tensor here.
"""
from typing import NamedTuple

import torch

from ...parallel.mesh import band_apply, kmax
from .lobpcg import _inner, _rotate, ortho_qr


class ChefsiResult(NamedTuple):
    X: torch.Tensor                 # [nk, nb, nG]
    eigenvalues: torch.Tensor       # [nk, nb], ascending
    residual_norms: torch.Tensor    # [nk, nb]
    upper_bound: float


def _rayleigh(X, AX):
    num = torch.sum(X.conj() * AX, -1).real
    return num / torch.clamp(torch.sum(X.real ** 2 + X.imag ** 2, -1), min=1e-30)


def estimate_upper_bound(apply_A, shape_like, mask, n_iter=12, generator=None, comm=None):
    """Spectral upper bound by power iteration on one random band, drawn from
    `generator` (a torch.Generator on shape_like's device; a new one seeded
    with 17 by default).  comm: a distributed basis' KComm; the band is
    drawn at every k-point and sliced to this rank's rows, and the bound is
    the maximum over "kpts"."""
    if generator is None:
        generator = torch.Generator(device=shape_like.device).manual_seed(17)
    nk, _, nG = shape_like.shape
    v = torch.randn((nk if comm is None else comm.n_kpoints, 1, nG), dtype=shape_like.dtype,
                    device=shape_like.device, generator=generator)
    v = (v if comm is None else comm.rows(v)) * mask[:, None, :]
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    for _ in range(n_iter):
        w = apply_A(v)
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=1e-30)
    return 1.1 * kmax(comm, _rayleigh(v, apply_A(v)).max())      # safety margin


def chebyshev_filter(apply_A, X, degree, lb, ub, band_chunk=None,
                     enter=None, leave=None):
    """p_m(H) X with the Chebyshev polynomial mapped so that [lb, ub] is
    damped (scaled three-term recurrence, Zhou et al. Algorithm 4.3 style).

    band_chunk: filter in blocks of this many bands (the recurrence is
    independent per band; chunks bound its three live temporaries).

    enter/leave: a change of representation around the whole recurrence
    (the compact-cube-resident filter of `ops/engine_split.py::
    compact_filter_ops`); apply_A then acts in the entered representation.
    If apply_A has a `dtype` attribute, the recurrence runs in that dtype:
    the entered block is cast to it once, and the result back to X's dtype
    once, per filter.
    """
    e = (ub - lb) / 2
    c = (ub + lb) / 2
    work_dtype = getattr(apply_A, "dtype", None)

    def filter_block(Xb):
        if enter is not None:
            Xb = enter(Xb)
        if work_dtype is not None:
            Xb = Xb.to(work_dtype)
        tm1, t = Xb, (apply_A(Xb) - c * Xb) * (1.0 / e)
        for _ in range(degree - 1):
            tm1, t = t, 2.0 / e * (apply_A(t) - c * t) - tm1
        t = t.to(X.dtype)
        return leave(t) if leave is not None else t

    nb = X.shape[1]
    if band_chunk is None or band_chunk >= nb:
        return filter_block(X)
    return torch.cat([filter_block(X[:, i:i + band_chunk])
                      for i in range(0, nb, band_chunk)], dim=1)


def chefsi_step(apply_A, X, mask, degree=8, lb=None, ub=None, n_conv=None,
                lb_margin=0.05, cycles=1, apply_filter=None, band_chunk=None,
                csplit=False, filter_wrap=None, apply_filter_last=None,
                n_exact_last=1, comm=None):
    """Filter + orthonormalise + Rayleigh-Ritz cycles.

    The damping window is [lb, ub]: everything above the wanted spectrum.
    lb defaults to the Ritz value at index n_conv (the first unwanted
    state), ub to a power-iteration bound on apply_A.

    apply_filter: a cheaper H apply used only inside the Chebyshev
    recurrence; Rayleigh-Ritz and residuals stay on apply_A.
    apply_filter_last: a separate filter apply for the last n_exact_last of
    the `cycles` cycles (the "mixed" schedule of the split SCF: bf16 filter
    cycles, then exact ones).
    filter_wrap: (enter, leave) around each filter (see chebyshev_filter).
    comm: a distributed basis' KComm (`parallel/mesh.py`): the rows are this
    rank's k rows, the damping window's bounds take the maximum over
    "kpts", and on a "bands" axis each rank filters and applies apply_A to
    its band slice, the block gathered for the orthonormalisation and
    Rayleigh-Ritz.
    """
    if csplit:
        raise NotImplementedError(
            "csplit: the realified complex algebra is a TPU workaround the "
            "port does not carry (ROADMAP, 'Not to port'); pass complex X")
    if cycles < 1:
        raise ValueError("chefsi_step needs cycles >= 1")
    if apply_filter is None:
        apply_filter = apply_A
    apply_A = band_apply(apply_A, comm)
    if apply_filter_last is None:
        apply_filter_last = apply_filter
    if ub is None:
        # with filter_wrap, apply_filter acts in the wrapped representation
        ub = estimate_upper_bound(
            apply_A if filter_wrap is not None else apply_filter, X, mask, comm=comm)
    ub = float(ub)
    nb = X.shape[1]
    if n_conv is None:
        n_conv = max(1, (3 * nb) // 4)
    idx = min(n_conv, nb - 1)
    enter, leave = filter_wrap if filter_wrap is not None else (None, None)

    theta = None
    if lb is None:
        # sorted Ritz estimates for the first damping window
        theta = torch.sort(_rayleigh(X, apply_A(X)), dim=1).values
    for i in range(cycles):
        lb_cur = kmax(comm, theta[:, idx].max()) + lb_margin if lb is None else float(lb)
        lb_cur = min(lb_cur, ub - 0.2 * abs(ub))
        af = apply_filter_last if i >= cycles - n_exact_last else apply_filter
        Y = band_apply(lambda Xs: chebyshev_filter(af, Xs, degree, lb_cur, ub,
                                                   band_chunk=band_chunk, enter=enter,
                                                   leave=leave), comm)(X) * mask[:, None, :]
        Y = ortho_qr(Y)
        AY = apply_A(Y)
        Hred = _inner(Y, AY)
        Hred = (Hred + Hred.conj().transpose(1, 2)) / 2
        theta, C = torch.linalg.eigh(Hred)
        X, AX = _rotate(C, Y), _rotate(C, AY)

    R = AX - theta[:, :, None].to(X.dtype) * X
    return ChefsiResult(X=X, eigenvalues=theta,
                        residual_norms=torch.linalg.vector_norm(R, dim=-1),
                        upper_bound=ub)
