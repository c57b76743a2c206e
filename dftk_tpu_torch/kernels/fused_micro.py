"""The band-major fully fused three-axis chain and its swap-only ablation.

Counterpart of the TPU probe kernels of `tools/bench_fused_micro.py`:
`micro_full` (kernel_full: kernel A + B + A in one kernel, band-major) and
`micro_swaponly` (kernel_swaponly: the chain's twelve axis swaps at
production-like sizes, no GEMMs), hand-written CUDA C++ for sm_90a in
`csrc/fused_micro.cu`, built and bound like the local-apply kernels
(`kernels/build.py`).  Each has a plain PyTorch version here (`*_plain`)
that replays the JAX body's swaps and matmuls on all bands at once.

Layout, the JAX probe's own (f32): xr, xi [K, NB, M, M, M], one [M, M, M]
cube per band; V [K, N, N, N]; F [2M, 2N]; G [2N, 2M].  Every contraction
is `cmul`: the last axis of (re, im) concatenated, times F (or G), the
result split into re and im; the swaps s23 and s12 bring each axis last.
micro_full runs three forward contractions with F, multiplies by V[k] in
the swapped order, and runs three backward ones with G.  micro_swaponly
broadcasts x[..., :1] to [M, M, n], swaps 3 x (s23, s12, s23, s12) and
returns big[..., :M, :M, :M] + x, for re and im.

The probe's F and G are unscaled normals: one apply multiplies magnitudes
by about 10^5-6, so a chain of applies overflows f32 after about seven;
compare one application.

Dispatch is by device only: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""
import torch

from .filter_stages import _check_cuda as fs_check_cuda
from .local_apply import KernelCounts, _raise_on_error, library

# micro_full's blocks per SM (64 KB of shared memory each at M = 32, N = 64)
# and micro_swaponly's (4 KB each): the persistent grid, which sizes the
# per-block scratch in device memory.
FULL_BLOCKS_PER_SM = 3
SWAP_BLOCKS_PER_SM = 4

counts = KernelCounts(("micro_full", "micro_swaponly"))


def _s23(a):
    return a.transpose(-2, -1)


def _s12(a):
    return a.transpose(-3, -2)


def _cmul(ar, ai, W, n_out):
    cat = torch.cat([ar, ai], dim=-1)
    y = torch.matmul(cat.reshape(-1, cat.shape[-1]), W).reshape(
        ar.shape[:-1] + (2 * n_out,))
    return y[..., :n_out], y[..., n_out:]


def _shapes(xr, xi, V=None, F=None, G=None):
    if xr.dim() != 5 or xr.shape != xi.shape or not (
            xr.shape[2] == xr.shape[3] == xr.shape[4]):
        raise ValueError(f"fused_micro: xr, xi must be [K, NB, M, M, M], got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    K, NB, M = xr.shape[:3]
    if F is None:
        return K, NB, M, None
    N = F.shape[-1] // 2
    if tuple(F.shape) != (2 * M, 2 * N) or tuple(G.shape) != (2 * N, 2 * M) \
            or tuple(V.shape) != (K, N, N, N):
        raise ValueError(f"micro_full: F [2M, 2N], G [2N, 2M] and V [K, N, N, N] "
                         f"for M = {M}, got {tuple(F.shape)}, {tuple(G.shape)} and "
                         f"{tuple(V.shape)}")
    return K, NB, M, N


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def micro_full_plain(xr, xi, V, F, G):
    """kernel_full on every band: (out_re, out_im), each [K, NB, M, M, M]."""
    counts.plain["micro_full"] += 1
    _, _, M, N = _shapes(xr, xi, V, F, G)
    ar, ai = _cmul(xr, xi, F, N)                   # [M, M, N]
    ar, ai = _s23(ar), _s23(ai)                    # [M, N, M]
    ar, ai = _cmul(ar, ai, F, N)                   # [M, N, N]
    ar, ai = _s12(ar), _s12(ai)                    # [N, M, N]
    ar, ai = _s23(ar), _s23(ai)                    # [N, N, M]
    ar, ai = _cmul(ar, ai, F, N)                   # [N, N, N]
    v = V[:, None]
    ar, ai = ar * v, ai * v
    ar, ai = _cmul(ar, ai, G, M)                   # [N, N, M]
    ar, ai = _s23(ar), _s23(ai)                    # [N, M, N]
    ar, ai = _s12(ar), _s12(ai)                    # [M, N, N]
    ar, ai = _cmul(ar, ai, G, M)                   # [M, N, M]
    ar, ai = _s23(ar), _s23(ai)                    # [M, M, N]
    ar, ai = _cmul(ar, ai, G, M)                   # [M, M, M]
    return ar, ai


def micro_swaponly_plain(xr, xi, n):
    """kernel_swaponly on every band, with the JAX module's N = n:
    (out_re, out_im)."""
    counts.plain["micro_swaponly"] += 1
    _, _, M, _ = _shapes(xr, xi)
    big_r = xr[..., :1].expand(xr.shape[:-1] + (n,)) * 1.0
    big_i = xi[..., :1].expand(xi.shape[:-1] + (n,)) * 1.0
    for _ in range(3):
        big_r, big_i = _s23(big_r), _s23(big_i)
        big_r, big_i = _s12(big_r), _s12(big_i)
        big_r, big_i = _s23(big_r), _s23(big_i)
        big_r, big_i = _s12(big_r), _s12(big_i)
    return big_r[..., :M, :M, :M] + xr, big_i[..., :M, :M, :M] + xi


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name, *xs):
    fs_check_cuda(name, *xs)
    if xs[0].numel() >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 - 1 elements")


def _tile_dims(name, *dims):
    for d in dims:
        if d < 1 or 128 % d:
            raise ValueError(f"{name}: M and N must divide 128 (a thread per output "
                             f"column of 2M or 2N in a 256-thread block), got {dims}")


def _blocks(device, jobs, per_sm):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(jobs, per_sm * sms))


def micro_full(xr, xi, V, F, G):
    """kernel_full on every band of xr, xi [K, NB, M, M, M]: (out_re, out_im)."""
    if xr.device.type == "cpu":
        return micro_full_plain(xr, xi, V, F, G)
    _check_cuda("micro_full", xr, xi, V, F, G)
    K, NB, M, N = _shapes(xr, xi, V, F, G)
    _tile_dims("micro_full", M, N)
    bands = K * NB
    blocks = _blocks(xr.device, bands, FULL_BLOCKS_PER_SM)
    per_block = 2 * (max(M * M * N, N ** 3) + M * N * N)
    scratch = torch.empty(blocks * per_block, dtype=torch.float32, device=xr.device)
    outr, outi = torch.empty_like(xr), torch.empty_like(xi)
    err = library().dftk_micro_full(
        xr.data_ptr(), xi.data_ptr(), V.data_ptr(), F.data_ptr(), G.data_ptr(),
        outr.data_ptr(), outi.data_ptr(), scratch.data_ptr(), bands, NB, M, N, blocks,
        torch.cuda.current_stream(xr.device).cuda_stream)
    _raise_on_error("micro_full", err)
    counts.launches["micro_full"] += 1
    return outr, outi


def micro_swaponly(xr, xi, n):
    """kernel_swaponly on every band of xr, xi [K, NB, M, M, M], with the
    JAX module's N = n: (out_re, out_im)."""
    if xr.device.type == "cpu":
        return micro_swaponly_plain(xr, xi, n)
    _check_cuda("micro_swaponly", xr, xi)
    K, NB, M, _ = _shapes(xr, xi)
    if n < M:
        raise ValueError(f"micro_swaponly: n = {n} is below M = {M}")
    bands = K * NB
    blocks = _blocks(xr.device, 2 * bands, SWAP_BLOCKS_PER_SM)
    scratch = torch.empty(blocks * 2 * M * M * n, dtype=torch.float32, device=xr.device)
    outr, outi = torch.empty_like(xr), torch.empty_like(xi)
    err = library().dftk_micro_swaponly(
        xr.data_ptr(), xi.data_ptr(), outr.data_ptr(), outi.data_ptr(), scratch.data_ptr(),
        bands, M, n, blocks, torch.cuda.current_stream(xr.device).cuda_stream)
    _raise_on_error("micro_swaponly", err)
    counts.launches["micro_swaponly"] += 1
    return outr, outi
