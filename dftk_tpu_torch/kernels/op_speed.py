"""The op-speed probes: one op repeated R times on data that stays on the chip.

Counterpart of the TPU probe kernel of `tools/probe_mosaic_speed.py`
(`run`: eleven bodies, each repeating one op R = 100 times in a
`fori_loop` on arrays held in VMEM), hand-written CUDA C++ for sm_90a in
`csrc/op_speed.cu`, built and bound like the other kernels
(`kernels/build.py`): three kernels, eleven instantiations, one per JAX
body, each counted under its own name.  Each launch runs all R steps;
each block keeps its part of the data in shared memory or registers.

  body                 wrapper                          kernel       R times (f32)
  rep_dot_KxN          `rep_gemm(acc, F, R, body, p)`   op_rep_gemm  acc <- 1e-3 (F @ acc)
  d1                   (acc [Z, K, N]: F on axis 1)                   + 0.5 acc
  tp, tp2, tp3         `rep_swap(x, perm, R, body)`     op_rep_swap  x <- 0.999 x.permute(perm)
  vm                   `rep_vmul(x, V, R)`              op_rep_vmul  x <- (x V[a, k]) 1.001

rep_dot_KxN: acc [K, N] (K, N of the body's name); d1: acc [64, 64, 128],
the JAX body's dot over dim 1 followed by its (1, 0, 2) transpose, which
is F applied to axis 1 of each acc[a].  precision p 'highest' computes in
f32; 'default' rounds F and each step's acc operand to bf16 (round to
nearest even) with f32 products and sums, as the TPU's one-pass bf16
product of Precision.DEFAULT does; the 0.5 acc term takes the unrounded
acc.  perm swaps two axes of equal length (kern_tp (2, 1, 0, 3) on [64, 2,
64, 128], kern_tp2 (1, 0, 2) on [64, 64, 128], kern_tp3 (0, 2, 1) on [64,
128, 128]).  vm: x [A, J, Bk, L], V [A, Bk] (the JAX body's V[:, None, :,
None]).

Each body has a plain PyTorch version here (`*_plain`) that replays the
JAX body step by step.  Dispatch is by device only: a CPU tensor takes the
plain version; a CUDA tensor launches the kernel or raises.  Bad shapes,
dtypes, R < 1 and K above 128 raise ValueError.  The source picks the
tiles and sizes the shared memory (at most 84,496 bytes a block, op_rep_gemm
at K = 128); its static_asserts hold that within what a block may use.
"""
import torch

from .local_apply import KernelCounts, _raise_on_error, library
from .op_probes import _check, _check_cuda, _stream, swap_dims

SCALE_SWAP = 0.999          # kern_tp, kern_tp2, kern_tp3
SCALE_VMUL = 1.001          # kern_vm
GEMM_K_MAX = 128            # kMaxK of the source: a thread owns rows ty + 32 i, i < 4

REP_DOTS = ((128, 4096, "highest"), (128, 4096, "default"), (64, 4096, "highest"),
            (64, 4096, "default"), (64, 8192, "highest"), (128, 8192, "highest"))


def gemm_name(body, precision):
    return f"op_rep_gemm[{body}]" + ("[default]" if precision == "default" else "")


NAMES = tuple(gemm_name(f"rep_dot_{K}x{N}", p) for K, N, p in REP_DOTS) + (
    "op_rep_gemm[d1]", "op_rep_swap[tp]", "op_rep_swap[tp2]", "op_rep_vmul[vm]",
    "op_rep_swap[tp3]")
counts = KernelCounts(NAMES)


def _name(name):
    if name not in NAMES:
        raise ValueError(f"no instantiation {name} (one of {NAMES})")
    return name


def _steps(name, R):
    if int(R) != R or R < 1:
        raise ValueError(f"{name}: R must be a whole number >= 1, got {R}")
    return int(R)


def gemm_smem(K):
    """Dynamic shared memory of one op_rep_gemm block at K (needs the card's
    build)."""
    return library().dftk_op_rep_gemm_smem(K)


def swap_smem(P, L):
    """Dynamic shared memory of one op_rep_swap block on x viewed
    [B, P, M, P, L] (needs the card's build)."""
    return library().dftk_op_rep_swap_smem(P, L)


# ---------------------------------------------------------------------------
# rep_dot and kern_d1
# ---------------------------------------------------------------------------

def _gemm_shapes(name, acc, F):
    if acc.dim() not in (2, 3) or F.dim() != 2 or F.shape[0] != F.shape[1] \
            or acc.shape[-2] != F.shape[0]:
        raise ValueError(f"{name}: acc [K, N] or [Z, K, N] with F [K, K], got "
                         f"{tuple(acc.shape)} and {tuple(F.shape)}")


def _precision(precision):
    if precision not in ("highest", "default"):
        raise ValueError(f"precision must be 'highest' or 'default', got {precision!r}")


def rep_gemm_steps(acc, F, R, precision="highest"):
    """The R steps in torch, uncounted: rep_gemm_plain's body, and the
    other precision's reference of a check."""
    Fo = F.to(torch.bfloat16).float() if precision == "default" else F
    for _ in range(R):
        x = acc.to(torch.bfloat16).float() if precision == "default" else acc
        acc = torch.matmul(Fo, x) * 1e-3 + acc * 0.5
    return acc


def rep_gemm_plain(acc, F, R, body, precision="highest"):
    counts.plain[_name(gemm_name(body, precision))] += 1
    return rep_gemm_steps(acc, F, R, precision)


def rep_gemm(acc, F, R, body, precision="highest"):
    """R steps of acc <- 1e-3 (F @ acc) + 0.5 acc (F on axis -2 of acc)."""
    _precision(precision)
    name = _name(gemm_name(body, precision))
    _check(name, acc, F)
    _gemm_shapes(name, acc, F)
    R = _steps(name, R)
    K = F.shape[0]
    if K > GEMM_K_MAX:
        raise ValueError(f"{name}: K = {K} is above {GEMM_K_MAX} (a thread owns 4 rows "
                         f"of 32)")
    if acc.device.type == "cpu":
        return rep_gemm_plain(acc, F, R, body, precision)
    _check_cuda(name, acc, F)
    N = acc.shape[-1]
    Z = acc.numel() // (K * N)
    out = torch.empty_like(acc)
    err = library().dftk_op_rep_gemm(acc.data_ptr(), F.data_ptr(), out.data_ptr(), Z, K, N,
                                     R, int(precision == "default"), _stream(acc))
    _raise_on_error(name, err)
    counts.launches[name] += 1
    return out


# ---------------------------------------------------------------------------
# kern_tp, kern_tp2, kern_tp3
# ---------------------------------------------------------------------------

def _swap_dims(name, x, perm):
    B, P, M, Q, L = swap_dims(x.shape, perm)
    if P != Q:
        raise ValueError(f"{name}: the swapped axes must be of one length, got {P} and {Q}")
    return B, P, M, L


def rep_swap_plain(x, perm, R, body):
    counts.plain[_name(f"op_rep_swap[{body}]")] += 1
    for _ in range(R):
        x = x.permute(perm).contiguous() * SCALE_SWAP
    return x


def rep_swap(x, perm, R, body):
    """R steps of x <- 0.999 x.permute(perm); perm swaps two axes of one
    length."""
    name = _name(f"op_rep_swap[{body}]")
    _check(name, x)
    B, P, M, L = _swap_dims(name, x, perm)
    R = _steps(name, R)
    if x.device.type == "cpu":
        return rep_swap_plain(x, perm, R, body)
    _check_cuda(name, x)
    out = torch.empty_like(x)
    err = library().dftk_op_rep_swap(x.data_ptr(), out.data_ptr(), B, P, M, L, R, SCALE_SWAP,
                                     _stream(x))
    _raise_on_error(name, err)
    counts.launches[name] += 1
    return out


# ---------------------------------------------------------------------------
# kern_vm
# ---------------------------------------------------------------------------

def _vmul_shapes(x, V):
    if x.dim() != 4 or V.dim() != 2 or V.shape[0] != x.shape[0] or V.shape[1] != x.shape[2]:
        raise ValueError(f"vm: x [A, J, Bk, L] with V [A, Bk], got {tuple(x.shape)} and "
                         f"{tuple(V.shape)}")


def rep_vmul_plain(x, V, R):
    counts.plain["op_rep_vmul[vm]"] += 1
    V4 = V[:, None, :, None]
    for _ in range(R):
        x = x * V4 * SCALE_VMUL
    return x


def rep_vmul(x, V, R):
    """R steps of x <- (x V[a, k]) 1.001, each product rounded in f32."""
    name = "op_rep_vmul[vm]"
    _check(name, x, V)
    _vmul_shapes(x, V)
    R = _steps(name, R)
    if x.device.type == "cpu":
        return rep_vmul_plain(x, V, R)
    _check_cuda(name, x, V)
    out = torch.empty_like(x)
    err = library().dftk_op_rep_vmul(x.data_ptr(), V.data_ptr(), out.data_ptr(), *x.shape, R,
                                     _stream(x))
    _raise_on_error(name, err)
    counts.launches[name] += 1
    return out
