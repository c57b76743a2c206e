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
launches and plain calls count under "<name>[bf16]".  The bf16 kernels read
the factors rounded to bf16 (`round_bf16`'s rounding) and packed in the
order of the tensor cores' fragments (`bf16_axis_pack`, `bf16_plane_packs`),
made once per factor tensor and kept while it is unchanged.

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
import torch.nn.functional as tnf
from torch.utils.weak import WeakTensorKeyDictionary

# The most dynamic shared memory one block may use on sm_90 (227 KB).
SMEM_MAX = 232448
_GRID_Y_MAX = 65535
_AXIS_TILE_ROWS = 32        # kTileRows of csrc/pruned_axis_dft.cu (complex64)
# Half an sm_90 SM's 228 KB, less the 1 KB reserved per block: two blocks fit.
_TWO_BLOCK_SMEM = 233472 // 2 - 1024
# The complex128 kernel B's block layouts, (warps, out column tiles a warp
# holds in registers; 0: the output accumulates in device memory), in the
# order they are preferred; csrc/local_plane.cu instantiates these six.
_PLANE_LAYOUTS_C128 = ((8, 1), (8, 2), (16, 1), (16, 2), (16, 4), (16, 0))


def _plane_smem_c128(m1, m2, n1, strip):
    """Shared memory of the complex128 kernel B at one strip width: the
    plane, T1s, S and the F2f and F2b slices, re and im, on whole 8-tiles
    with rows padded by 4 (the kernel's own count,
    `dftk_local_plane_c128_smem`, is held to it by a CUDA test)."""
    m1p, m2p, n1p, wp = (8 * -(-d // 8) for d in (m1, m2, n1, strip))
    return 16 * (m1p * (m2p + 4) + (m1p + n1p + m2p) * (wp + 4) + wp * (m2p + 4))


def _pad(d, q):
    return q * -(-d // q)


def _plane_smem_bf16(m1, m2, n1, strip):
    """Shared memory of the bf16 kernel B at one strip width: the plane, one
    strip of T1s and S, re and im in bf16, on whole 16-tiles with rows
    padded by 8 (the kernel's own count, `dftk_local_plane_bf16_smem`, is
    held to it by a CUDA test)."""
    m1p, m2p, n1p, wp = (_pad(d, 16) for d in (m1, m2, n1, strip))
    return 4 * (m1p * (m2p + 8) + (m1p + n1p) * (wp + 8))


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
# The bf16 kernels' factors: rounded once, in fragment order
# ---------------------------------------------------------------------------
#
# mma.sync m16n8k16 fragments (csrc/dftk_complex.cuh), lane = 4 gr + tg:
#   A (16 x 16): a0 (row gr, k 2tg, 2tg+1), a1 (row gr+8), a2 (k +8), a3 (both)
#   B (16 x 8):  b0 (k 2tg, 2tg+1, column gr), b1 (k +8)
# each register two bf16, the lower index in the low half.

def _frags_a(M):
    """A fragments of real bf16 matrices [..., R, C], zero-padded to 16 x 16
    tiles: [..., R/16, C/16, 32 lanes, 8] (a0..a3, two values each)."""
    *lead, R, C = M.shape
    M = tnf.pad(M, (0, _pad(C, 16) - C, 0, _pad(R, 16) - R))
    Rt, Ct, n = M.shape[-2] // 16, M.shape[-1] // 16, len(lead)
    M = M.reshape(*lead, Rt, 2, 8, Ct, 2, 4, 2)       # rows (rh, gr), columns (ch, tg, e)
    order = (n, n + 3, n + 2, n + 5, n + 4, n + 1, n + 6)   # Rt, Ct, gr, tg, ch, rh, e
    return M.permute(*range(n), *order).reshape(*lead, Rt, Ct, 32, 8)


def _frags_b(M):
    """B fragments of real bf16 matrices [..., K, N], zero-padded to 16 x 8
    tiles: [..., N/8, K/16, 32 lanes, 4] (b0, b1, two values each)."""
    *lead, K, N = M.shape
    M = tnf.pad(M, (0, _pad(N, 8) - N, 0, _pad(K, 16) - K))
    Kt, Nt, n = M.shape[-2] // 16, M.shape[-1] // 8, len(lead)
    M = M.reshape(*lead, Kt, 2, 4, 2, Nt, 8)          # k (kh, tg, e), columns gr
    order = (n + 4, n, n + 5, n + 2, n + 1, n + 3)    # Nt, Kt, gr, tg, kh, e
    return M.permute(*range(n), *order).reshape(*lead, Nt, Kt, 32, 4)


def _pack_a(F):
    """Complex F [..., R, C] rounded to bf16 as A fragments: [..., R/16,
    C/16, (re, im), 32, 8] bf16, one uint4 a lane and part."""
    return torch.stack((_frags_a(F.real.to(torch.bfloat16)),
                        _frags_a(F.imag.to(torch.bfloat16))), dim=-3).contiguous()


def _pack_b(F):
    """Complex F [..., K, N] rounded to bf16 as B fragments: [..., N/8, K/16,
    32, 8] bf16, one uint4 {re b0, re b1, im b0, im b1} a lane."""
    return torch.cat((_frags_b(F.real.to(torch.bfloat16)),
                      _frags_b(F.imag.to(torch.bfloat16))), dim=-1).contiguous()


_PACKS = WeakTensorKeyDictionary()


def _packed(F, key, make):
    """make() for factor F, made once per key while F is unchanged (its
    in-place version counter) and dropped with F."""
    version, packs = _PACKS.get(F, (None, None))
    if version != F._version:
        packs = {}
        _PACKS[F] = (F._version, packs)
    if key not in packs:
        packs[key] = make()
    return packs[key]


def bf16_axis_pack(F, forward):
    """Kernel A's factor F [K, J] for the bf16 kernel: forward F^T as A
    fragments [ceil(J/16), ceil(K/16), 2, 32, 8], backward F as B fragments
    [ceil(J/8), ceil(K/16), 32, 8]."""
    return _packed(F, ("z", bool(forward)),
                   lambda: _pack_a(F.T) if forward else _pack_b(F))


def bf16_plane_packs(factors, strip):
    """Kernel B's factors for the bf16 kernel at this strip width: (F2f per
    strip as B fragments [strips, 2 wt, m2t, 32, 8], F1f^T and F1b^T as A
    fragments [n1t, m1t, ...] and [m1t, n1t, ...], F2b per strip as B
    fragments [strips, 2 m2t, wt, 32, 8]); m1t = ceil(m1/16), wt =
    ceil(strip/16), each strip zero-padded to wt tiles."""
    (F1, F2), (B1, B2) = factors.fwd[:2], factors.bwd[:2]
    (m2, n2), m1 = F2.shape, F1.shape[0]
    ns, wp = -(-n2 // strip), _pad(strip, 16)

    def y_fwd():        # [m2, n2] -> strips [ns, m2, wp] -> B (K = m2, N = strip)
        G = tnf.pad(F2, (0, ns * strip - n2)).reshape(m2, ns, strip).permute(1, 0, 2)
        return _pack_b(tnf.pad(G, (0, wp - strip)))

    def y_bwd():        # [n2, m2] -> strips [ns, wp, m2p] -> B (K = strip, N = m2)
        H = tnf.pad(B2, (0, 0, 0, ns * strip - n2)).reshape(ns, strip, m2)
        return _pack_b(tnf.pad(H, (0, _pad(m2, 16) - m2, 0, wp - strip)))

    return (_packed(F2, ("y", strip), y_fwd), _packed(F1, ("x",), lambda: _pack_a(F1.T)),
            _packed(B1, ("x",), lambda: _pack_a(B1.T)), _packed(B2, ("y", strip), y_bwd))


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
    else:
        n3, m1, m2 = x.shape[2:]
        if n3 != K:
            raise ValueError(f"pruned_axis_dft: x has n3={n3}, F has {K} rows")
        out = torch.empty((nk, nb, m1, m2, J), dtype=x.dtype, device=x.device)
    # complex128 and bf16 stream their input past a fixed shared-memory
    # tile; complex64 stages a [32, K (+1 forward)] tile
    smem = 0 if x.dtype == torch.complex128 or precision == "default" else \
        _AXIS_TILE_ROWS * (K + int(bool(forward))) * x.element_size()
    if smem > SMEM_MAX or nk * nb > _GRID_Y_MAX:
        raise ValueError(f"pruned_axis_dft: shape {tuple(x.shape)} with "
                         f"factor {tuple(F.shape)} is beyond this kernel "
                         f"({smem} B shared memory, {nk * nb} batches)")
    Fk = bf16_axis_pack(F, forward) if precision == "default" else F
    fn = getattr(library(), f"dftk_axis_dft_{_suffix(x, precision)}")
    err = fn(x.data_ptr(), Fk.data_ptr(), out.data_ptr(), nk * nb, m1 * m2,
             K, J, int(bool(forward)), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on_error("pruned_axis_dft", err)
    counts.launches[name] += 1
    return out


def local_plane_layout_c128(m1, m2, n1, n2, strip=None):
    """(strip, warps, out tiles) of the complex128 kernel B: the width of the
    y strips it processes at once (`strip`, checked, or chosen when None)
    and its block layout, one of `_PLANE_LAYOUTS_C128`.

    A block holds the plane, one strip of T1 and S and the strip's y factor
    slices in shared memory (`_plane_smem_c128`), and the output in its
    warps' registers where they hold it (16 row tiles of 4 column tiles of
    8 x 8 at most), else in device memory.  The chosen strip is the widest
    with which two blocks of 8 warps share an SM, where 8 warps hold the
    output and that strip spans 32 columns or all of n2 (so the x factors
    are read at most n2 / 32 times a plane); else the widest that fits one
    block of 16 warps.  Explicit strips up to the latter are taken."""
    need = lambda w: _plane_smem_c128(m1, m2, n1, w)

    def fit(cap):       # need() steps with whole 8-column tiles of the strip
        if need(n2) <= cap:
            return n2
        return max((w for w in range(8, n2, 8) if need(w) <= cap), default=0)

    widest = fit(SMEM_MAX)
    if widest < 1:
        raise ValueError(
            f"local_plane: planes m=({m1},{m2}), n=({n1},{n2}) in "
            f"torch.complex128 need {need(1)} B of shared memory, more than "
            f"the {SMEM_MAX} B a block may use")
    m1t, m2t = -(-m1 // 8), -(-m2 // 8)
    holds = lambda warps, oc: oc == 0 or m1t * -(-m2t // oc) <= warps
    if strip is None:
        two = fit(_TWO_BLOCK_SMEM)
        strip = two if holds(8, 2) and two >= min(n2, 32) else widest
    elif not 1 <= strip <= widest:
        raise ValueError(f"local_plane: strip {strip} outside [1, {widest}]")
    two_blocks = need(strip) <= _TWO_BLOCK_SMEM
    return next((strip, warps, oc) for warps, oc in _PLANE_LAYOUTS_C128
                if (warps == 16 or two_blocks) and holds(warps, oc))


def local_plane_strip_bf16(m1, m2, n1, n2, strip=None):
    """Width of the y strips of the bf16 kernel B (`strip`, checked, or
    chosen when None).  A block holds the plane, one strip of T1s and S in
    shared memory (`_plane_smem_bf16`; the output, in registers or device
    memory, and the packed factors, read through L1, take none).  The
    chosen strip is the widest of all of n2 and the even splits of n2 into
    16-column multiples with which two blocks share an SM, else the widest
    that fits one block.  Explicit strips up to the widest that fits are
    taken."""
    need = lambda w: _plane_smem_bf16(m1, m2, n1, w)
    if need(n2) <= SMEM_MAX:
        widest = n2
    else:
        widest = max((w for w in range(16, n2, 16) if need(w) <= SMEM_MAX), default=0)
    if widest < 1:
        raise ValueError(
            f"local_plane: planes m=({m1},{m2}), n=({n1},{n2}) in bf16 need "
            f"{need(1)} B of shared memory, more than the {SMEM_MAX} B a block "
            f"may use")
    if strip is None:
        splits = [n2] + [_pad(-(-n2 // ns), 16) for ns in range(2, -(-n2 // 16) + 1)]
        return next((w for w in splits if w <= widest and need(w) <= _TWO_BLOCK_SMEM),
                    widest)
    if not 1 <= strip <= widest:
        raise ValueError(f"local_plane: strip {strip} outside [1, {widest}]")
    return strip


def local_plane_strip(t, n1, n2, strip=None):
    """Width of the y strips kernel B processes at once (`strip`, checked,
    or the widest that suits when None).  complex128: see
    `local_plane_layout_c128`; bf16: `local_plane_strip_bf16`.  complex64
    holds the plane and the whole [m1, n2] T1 besides the [n1, strip]
    buffer in shared memory and takes the widest strip that fits."""
    m1, m2 = t.shape[-2:]
    if t.dtype == torch.complex128:
        return local_plane_layout_c128(m1, m2, n1, n2, strip)[0]
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
    mats = (F2, F1, B1, B2)
    if t.dtype == torch.complex128:
        layout = local_plane_layout_c128(m1, m2, n1, n2, strip)
    elif precision == "default":
        layout = (local_plane_strip_bf16(m1, m2, n1, n2, strip),)
        mats = bf16_plane_packs(factors, layout[0])
    else:
        layout = (local_plane_strip(t, n1, n2, strip),)
    out = torch.empty_like(t)
    fn = getattr(library(), f"dftk_local_plane_{_suffix(t, precision)}")
    err = fn(t.data_ptr(), V.data_ptr(), *(f.data_ptr() for f in mats), out.data_ptr(),
             nk, nb, n3, m1, m2, n1, n2, *layout,
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
