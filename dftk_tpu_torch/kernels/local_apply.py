"""The local-potential apply V(r).psi through pruned DFTs on the compact cube.

Counterpart of the two TPU kernels of the JAX package:
  * `dftk_tpu/kernels/fused_local.py::fused_local_apply`: the whole chain,
    here `local_apply` = kernel A (forward) -> kernel B -> kernel A (backward);
  * `dftk_tpu/kernels/fused_filter.py::fused_filter_mid`: the y/x plane
    chain with the potential, here `local_plane` (kernel B).

The kernels are hand-written CUDA C++ for sm_90a (`dftk_tpu_torch/csrc`),
built with nvcc at first use on a CUDA tensor and bound through ctypes
(`kernels/build.py`).  Each has a plain PyTorch version in this module
(`*_plain`): a chain of `torch.einsum`s over the same complex factors.

Precision: "highest" computes in the data's own type (complex64 or
complex128).  "default" is the TPU kernels' one-pass bf16 mode, used by the
Chebyshev filter: complex64 data and factors in memory, the real and
imaginary parts of both operands of every complex product rounded to bf16
(round to nearest even), f32 accumulation, the V multiply in f32.  Its
launches and plain calls count under "<name>[bf16]".

Dispatch is by device only.  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  No failure of the build or of a
launch falls back to the plain version.

Layouts (complex64 or complex128; V real of the same precision):
  compact cube  xc [nk, nb, m1, m2, m3]
  z-transformed t  [nk, nb, n3, m1, m2]   one [m1, m2] plane per (k, band, z)
  potential     V  [nk, n3, n1, n2]       one [n1, n2] plane per (k, z)
  factors: LocalFactors(fwd=(F1 [m1,n1], F2 [m2,n2], F3 [m3,n3]),
                        bwd=(B1 [n1,m1], B2 [n2,m2], B3 [n3,m3]))
so that local_apply(xc) = B3 . B2 . B1 . V . F1 . F2 . F3 (xc), with each
factor contracting its own axis (see `ops/pruned.py` for their values).
"""
from typing import NamedTuple

import torch

# The most dynamic shared memory one block may use on sm_90 (227 KB).
SMEM_MAX = 232448
_GRID_Y_MAX = 65535
_AXIS_TILE_ROWS = 32        # kTileRows of csrc/pruned_axis_dft.cu


class LocalFactors(NamedTuple):
    fwd: tuple    # 3 x [m_a, n_a] complex: compact -> grid, e^{+i}
    bwd: tuple    # 3 x [n_a, m_a] complex: grid -> compact, e^{-i}/n_a


class KernelCounts:
    """Launch counts of the kernels and call counts of their plain versions.

    A wrapper adds one to `launches[name]` where it launches its kernel and
    nowhere else; a plain version adds one to `plain[name]` per call."""

    NAMES = ("pruned_axis_dft", "local_plane",
             "pruned_axis_dft[bf16]", "local_plane[bf16]")

    def __init__(self, names=NAMES):
        self.names = tuple(names)
        self.reset()

    def reset(self):
        self.launches = dict.fromkeys(self.names, 0)
        self.plain = dict.fromkeys(self.names, 0)


counts = KernelCounts()
_library = None


def library():
    """The built kernel library (built on first call)."""
    global _library
    if _library is None:
        from .build import build_library
        _library = build_library()
    return _library


def _count_name(name, precision):
    if precision == "highest":
        return name
    if precision == "default":
        return f"{name}[bf16]"
    raise ValueError(f"{name}: precision must be 'highest' or 'default', "
                     f"got {precision!r}")


def round_bf16(x):
    """Real and imaginary parts of a complex64 tensor rounded to bf16 (round
    to nearest even), returned as complex64: an operand of the 'default'
    precision."""
    if x.dtype != torch.complex64:
        raise TypeError(f"the bf16 mode takes complex64 data, got {x.dtype}")
    return torch.complex(x.real.to(torch.bfloat16).float(),
                         x.imag.to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def pruned_axis_dft_plain(x, F, forward, precision="highest"):
    counts.plain[_count_name("pruned_axis_dft", precision)] += 1
    if precision == "default":
        x, F = round_bf16(x), round_bf16(F)
    if forward:
        return torch.einsum("kbxyc,cz->kbzxy", x, F)
    return torch.einsum("kbzxy,zc->kbxyc", x, F)


def local_plane_plain(t, V, factors: LocalFactors, precision="highest"):
    counts.plain[_count_name("local_plane", precision)] += 1
    F1, F2 = factors.fwd[0], factors.fwd[1]
    B1, B2 = factors.bwd[0], factors.bwd[1]
    r = round_bf16 if precision == "default" else (lambda a: a)
    u = torch.einsum("kbzxy,yj->kbzxj", r(t), r(F2))
    u = torch.einsum("kbzxj,xi->kbzij", r(u), r(F1)) * V[:, None]
    u = torch.einsum("kbzij,ix->kbzxj", r(u), r(B1))
    return torch.einsum("kbzxj,jy->kbzxy", r(u), r(B2))


def local_apply_plain(xc, V, factors: LocalFactors, precision="highest"):
    t = pruned_axis_dft_plain(xc, factors.fwd[2], True, precision)
    t = local_plane_plain(t, V, factors, precision)
    return pruned_axis_dft_plain(t, factors.bwd[2], False, precision)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, precision, x, *others, real=()):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device or the "
                         f"CPU, got {x.device}")
    if x.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"{name}: complex64 or complex128 expected, got {x.dtype}")
    if precision == "default" and x.dtype != torch.complex64:
        raise TypeError(f"{name}: the bf16 mode takes complex64 data, got {x.dtype}")
    rdt = torch.float64 if x.dtype == torch.complex128 else torch.float32
    for t in (x,) + others + tuple(real):
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    for t in others:
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: factor dtype {t.dtype} != {x.dtype}")
    for t in real:
        if t.dtype != rdt:
            raise TypeError(f"{name}: potential dtype {t.dtype} != {rdt}")


def _raise_on_error(name, err):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def _suffix(x, precision):
    if precision == "default":
        return "bf16"
    return "c128" if x.dtype == torch.complex128 else "c64"


def pruned_axis_dft(x, F, forward, precision="highest"):
    """Kernel A: contract the z axis with F and move it ahead of (x, y).

    forward:  x [nk, nb, m1, m2, m3], F [m3, n3] -> [nk, nb, n3, m1, m2]
    backward: x [nk, nb, n3, m1, m2], F [n3, m3] -> [nk, nb, m1, m2, m3]
    """
    name = _count_name("pruned_axis_dft", precision)
    if x.device.type == "cpu":
        return pruned_axis_dft_plain(x, F, forward, precision)
    _check("pruned_axis_dft", precision, x, F)
    if x.dim() != 5 or F.dim() != 2:
        raise ValueError("pruned_axis_dft: x must be 5-D and F 2-D")
    nk, nb = x.shape[:2]
    K, J = F.shape
    if forward:
        m1, m2, m3 = x.shape[2:]
        if m3 != K:
            raise ValueError(f"pruned_axis_dft: x has m3={m3}, F has {K} rows")
        out = torch.empty((nk, nb, J, m1, m2), dtype=x.dtype, device=x.device)
        smem = _AXIS_TILE_ROWS * (K + 1) * x.element_size()
    else:
        n3, m1, m2 = x.shape[2:]
        if n3 != K:
            raise ValueError(f"pruned_axis_dft: x has n3={n3}, F has {K} rows")
        out = torch.empty((nk, nb, m1, m2, J), dtype=x.dtype, device=x.device)
        smem = _AXIS_TILE_ROWS * K * x.element_size()
    if smem > SMEM_MAX or nk * nb > _GRID_Y_MAX:
        raise ValueError(f"pruned_axis_dft: shape {tuple(x.shape)} with "
                         f"factor {tuple(F.shape)} is beyond this kernel "
                         f"({smem} B shared memory, {nk * nb} batches)")
    fn = getattr(library(), f"dftk_axis_dft_{_suffix(x, precision)}")
    err = fn(x.data_ptr(), F.data_ptr(), out.data_ptr(), nk * nb, m1 * m2,
             K, J, int(bool(forward)), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error("pruned_axis_dft", err)
    counts.launches[name] += 1
    return out


def local_plane_strip(t, n1, n2, strip=None):
    """Width of the y strips kernel B processes at once: all of n2 when
    the planes fit in shared memory, else the widest strip that does."""
    m1, m2 = t.shape[-2:]
    es = t.element_size()
    fixed = (m1 * m2 + m1 * n2) * es
    widest = min(n2, (SMEM_MAX - fixed) // (n1 * es))
    if widest < 1:
        raise ValueError(
            f"local_plane: planes m=({m1},{m2}), n=({n1},{n2}) in {t.dtype} "
            f"need {fixed + n1 * es} B of shared memory, more than the "
            f"{SMEM_MAX} B a block may use")
    if strip is None:
        return widest
    if not 1 <= strip <= widest:
        raise ValueError(f"local_plane: strip {strip} outside [1, {widest}]")
    return strip


def local_plane(t, V, factors: LocalFactors, strip=None, precision="highest"):
    """Kernel B: y forward, x forward, *V, x backward, y backward, per
    (k, band, z) plane.  t [nk, nb, n3, m1, m2], V [nk, n3, n1, n2]."""
    name = _count_name("local_plane", precision)
    if t.device.type == "cpu":
        return local_plane_plain(t, V, factors, precision)
    F1, F2 = factors.fwd[0], factors.fwd[1]
    B1, B2 = factors.bwd[0], factors.bwd[1]
    _check("local_plane", precision, t, F1, F2, B1, B2, real=(V,))
    nk, nb, n3, m1, m2 = t.shape
    n1, n2 = V.shape[-2:]
    if (tuple(V.shape) != (nk, n3, n1, n2) or tuple(F1.shape) != (m1, n1)
            or tuple(F2.shape) != (m2, n2) or tuple(B1.shape) != (n1, m1)
            or tuple(B2.shape) != (n2, m2)):
        raise ValueError(
            f"local_plane: inconsistent shapes t {tuple(t.shape)}, V "
            f"{tuple(V.shape)}, factors {[tuple(f.shape) for f in (F1, F2, B1, B2)]}")
    if nk * nb * n3 >= 2 ** 31:
        raise ValueError("local_plane: more than 2^31 - 1 planes")
    strip = local_plane_strip(t, n1, n2, strip)
    out = torch.empty_like(t)
    fn = getattr(library(), f"dftk_local_plane_{_suffix(t, precision)}")
    err = fn(t.data_ptr(), V.data_ptr(), F2.data_ptr(), F1.data_ptr(),
             B1.data_ptr(), B2.data_ptr(), out.data_ptr(),
             nk, nb, n3, m1, m2, n1, n2, strip,
             torch.cuda.current_stream(t.device).cuda_stream)
    _raise_on_error("local_plane", err)
    counts.launches[name] += 1
    return out


def local_apply(xc, V, factors: LocalFactors, precision="highest"):
    """V(r) applied to compact cubes xc [nk, nb, m1, m2, m3] (see module
    docstring); returns the same layout."""
    if xc.device.type == "cpu":
        return local_apply_plain(xc, V, factors, precision)
    t = pruned_axis_dft(xc, factors.fwd[2], True, precision)
    t = local_plane(t, V, factors, precision=precision)
    return pruned_axis_dft(t, factors.bwd[2], False, precision)
