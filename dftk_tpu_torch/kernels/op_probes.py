"""The op probes: transposes and copies, a realified GEMM, the axis chain.

Counterpart of the TPU probe kernels of `tools/probe_pallas_fused.py`
(t_kernel, s_kernel, g_kernel, f_kernel), `tools/probe_pallas_fused2.py`
(k_a, k_b, k_c) and `tools/probe_mosaic_ops.py` (the eight bodies of
`try_kernel`), hand-written CUDA C++ for sm_90a in `csrc/op_probes.cu`,
built and bound like the local-apply kernels (`kernels/build.py`): three
kernels, fifteen instantiations, one per JAX body, each counted in
`counts` under its own name.

  body    wrapper        kernel          what it computes (f32)
  t2d     `t2d(x)`       op_transpose    x [R, C] -> x.T
  swap    `swap(y)`      op_transpose    y [X, R, C] -> [X, C, R]
  k_a     `k_a(x)`       op_transpose    x [T, A, R, C] -> [T, A, C, R]
  k_b     `k_b(x)`       op_transpose    x [T, m, n1, n2] viewed [T, m, n1 n2],
                                         swapped, viewed [T, n1, n2, m]
  gemm    `gemm(a, b)`   op_gemm         a @ b ([M, K] @ [K, N], or batched)
  k_c     `k_c(ar, ai, F)` op_gemm       concat(ar, ai) @ F split into (re, im)
  fused   `fused(xb, F, V)` op_fused_axis  per band of xb [nb, m1, R]: swap,
                                         [R/2, 2 m1] @ F, x V [R/2, 1, m1]
                                         broadcast over the halves, @ F^T,
                                         swap back
  probe_mosaic_ops (f32 out; body names as the counts give them):
  view1, view5, view7  `reshape_copy(x, shape, body)`  op_transpose  the
                                         values of x in a new tensor of `shape`
  perm2   `permute(x, perm, "perm2")`  op_transpose  x permuted by a `perm`
                                         that swaps two axes, the axes
                                         between and after them moving whole
  dot3    `mosaic_dot(F, d, "highest", "dot3")`  op_gemm  F @ d in f32
  dot4    `mosaic_dot(F, d3, "default", "dot4")` op_gemm  F [M, K] against
                                         d3 [K, ...] over d3's first axis,
                                         operands rounded to bf16, f32 sums
  dot6    `mosaic_dot(X, M, "default", "dot6")`  op_gemm  batched X [Z, M, K]
                                         @ M [Z, K, N], the same rounding
  dot8    `mosaic_dot(Fb, db, "highest", "dot8")` op_gemm  bf16 operands in
                                         memory, f32 products and sums

The wrappers take views of contiguous tensors, which cost nothing: each
body is one launch.  Each body has a plain PyTorch version here (`*_plain`)
that replays the JAX body's swaps, matmuls, concatenation and slices.

Dispatch is by device only: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  Bad shapes and dtypes raise
ValueError on both.
"""
import math

import torch

from .local_apply import KernelCounts, _raise_on_error, library

TRANSPOSE_TILE = 1024      # values per transpose block (kTileSmem of the source / 2)
FUSED_M1_MAX = 32          # op_fused_axis: 2 m1 columns over 16 threads x 4

GEMM_MODES = {"highest": 0, "default": 1, "bf16": 2}     # dftk_op_gemm's mode
MOSAIC_NAMES = ("op_transpose[view1]", "op_transpose[perm2]", "op_gemm[dot3]",
                "op_gemm[dot4][default]", "op_transpose[view5]", "op_gemm[dot6][default]",
                "op_transpose[view7]", "op_gemm[dot8][bf16]")

counts = KernelCounts(("op_transpose[t2d]", "op_transpose[swap]", "op_gemm[gemm]",
                       "op_fused_axis[fused]", "op_transpose[k_a]", "op_transpose[k_b]",
                       "op_gemm[k_c]") + MOSAIC_NAMES)


def _check(name, *xs, dtype=torch.float32):
    for x in xs:
        if x.dtype != dtype:
            raise ValueError(f"{name}: {str(dtype).split('.')[-1]} expected, got {x.dtype}")
        if x.device != xs[0].device:
            raise ValueError(f"{name}: all tensors must be on {xs[0].device}")


def _check_cuda(name, *xs):
    if xs[0].device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device or the CPU, "
                         f"got {xs[0].device}")
    for x in xs:
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if x.numel() >= 2 ** 31:
            raise ValueError(f"{name}: more than 2^31 - 1 elements")


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def transpose_tile(B, R, C):
    """(TR, TC, G): the transpose's block moves G batch entries' [TR, TC]
    tiles, TR TC G <= TRANSPOSE_TILE values.  The short axis is taken
    whole (up to 32), the other up to the tile, and G folds batch entries
    where the tile is below TRANSPOSE_TILE."""
    if C <= R:
        TC = min(C, 32)
        TR = min(R, max(32, TRANSPOSE_TILE // TC))
    else:
        TR = min(R, 32)
        TC = min(C, max(32, TRANSPOSE_TILE // TR))
    return TR, TC, min(B, max(1, TRANSPOSE_TILE // (TR * TC)))


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors, checked by the body wrappers)
# ---------------------------------------------------------------------------

def _transpose(x, name):
    """op_transpose on x [B, R, C]: [B, C, R]."""
    _check_cuda(name, x)
    B, R, C = x.shape
    out = torch.empty((B, C, R), dtype=x.dtype, device=x.device)
    err = library().dftk_op_transpose(x.data_ptr(), out.data_ptr(), B, R, C,
                                      *transpose_tile(B, R, C), _stream(x))
    _raise_on_error(name, err)
    counts.launches[name] += 1
    return out


def _permute_rows(x, dims, name):
    """op_transpose on x viewed [B, P, M, Q, L] (dims): a new tensor holding
    [B, Q, M, P, L], returned flat (M = L = 1 takes the tiled transpose)."""
    B, P, M, Q, L = dims
    if M == L == 1:
        return _transpose(x.view(B, P, Q), name).view(-1)
    _check_cuda(name, x)
    out = torch.empty(x.numel(), dtype=x.dtype, device=x.device)
    err = library().dftk_op_permute_rows(x.data_ptr(), out.data_ptr(), *dims, _stream(x))
    _raise_on_error(name, err)
    counts.launches[name] += 1
    return out


def _gemm(parts, W, Q, name, mode="highest"):
    """op_gemm: concat(parts, -1) @ W split into Q equal column parts, f32.
    parts: P (<= 2) tensors [Z, M, K/P]; W [Z, K, N] or [K, N]; mode: a key
    of GEMM_MODES (f32 operands, or bf16 ones for "bf16")."""
    _check_cuda(name, *parts, W)
    Z, M, Kp = parts[0].shape
    K, N = W.shape[-2:]
    outs = [torch.empty((Z, M, N // Q), dtype=torch.float32, device=W.device)
            for _ in range(Q)]
    a = [p.data_ptr() for p in parts] * (3 - len(parts))
    c = [o.data_ptr() for o in outs] * (3 - Q)
    err = library().dftk_op_gemm(a[0], a[1], W.data_ptr(), c[0], c[1], Z, M, K, N,
                                 len(parts), Q, Kp, N, N // Q, M * Kp,
                                 K * N if W.dim() == 3 else 0, M * N // Q,
                                 GEMM_MODES[mode], _stream(W))
    _raise_on_error(name, err)
    counts.launches[name] += 1
    return outs


def _fused_axis(xb, F, V, name):
    _check_cuda(name, xb, F, V)
    nb, m1, R = xb.shape
    if m1 > FUSED_M1_MAX:
        raise ValueError(f"{name}: m1 = {m1} is above {FUSED_M1_MAX} (a thread per "
                         f"column of 2 m1 in 16 x 4)")
    out = torch.empty_like(xb)
    err = library().dftk_op_fused_axis(xb.data_ptr(), F.data_ptr(), V.data_ptr(),
                                       out.data_ptr(), nb, m1, R, _stream(xb))
    _raise_on_error(name, err)
    counts.launches[name] += 1
    return out


# ---------------------------------------------------------------------------
# The bodies: shape checks, then the plain version (CPU) or the kernel (CUDA)
# ---------------------------------------------------------------------------

def _dims(name, x, n):
    if x.dim() != n:
        raise ValueError(f"{name}: a {n}-D tensor expected, got {tuple(x.shape)}")


def t2d_plain(x):
    counts.plain["op_transpose[t2d]"] += 1
    return x.T.contiguous()


def t2d(x):
    """t_kernel: x [R, C] -> x.T [C, R]."""
    _check("t2d", x)
    _dims("t2d", x, 2)
    if x.device.type == "cpu":
        return t2d_plain(x)
    return _transpose(x[None], "op_transpose[t2d]")[0]


def swap_plain(y):
    counts.plain["op_transpose[swap]"] += 1
    return torch.swapaxes(y, 1, 2).contiguous()


def swap(y):
    """s_kernel: y [X, R, C] -> [X, C, R]."""
    _check("swap", y)
    _dims("swap", y, 3)
    if y.device.type == "cpu":
        return swap_plain(y)
    return _transpose(y, "op_transpose[swap]")


def k_a_plain(x):
    counts.plain["op_transpose[k_a]"] += 1
    return torch.swapaxes(x, 2, 3).contiguous()


def k_a(x):
    """k_a: x [T, A, R, C] -> [T, A, C, R]."""
    _check("k_a", x)
    _dims("k_a", x, 4)
    if x.device.type == "cpu":
        return k_a_plain(x)
    _check_cuda("k_a", x)
    T, A, R, C = x.shape
    return _transpose(x.view(T * A, R, C), "op_transpose[k_a]").view(T, A, C, R)


def k_b_plain(x):
    counts.plain["op_transpose[k_b]"] += 1
    T, m, n1, n2 = x.shape
    return torch.swapaxes(x.reshape(T, m, n1 * n2), 1, 2).reshape(T, n1, n2, m).contiguous()


def k_b(x):
    """k_b: x [T, m, n1, n2] viewed [T, m, n1 n2], swapped, viewed
    [T, n1, n2, m]."""
    _check("k_b", x)
    _dims("k_b", x, 4)
    if x.device.type == "cpu":
        return k_b_plain(x)
    _check_cuda("k_b", x)
    T, m, n1, n2 = x.shape
    return _transpose(x.view(T, m, n1 * n2), "op_transpose[k_b]").view(T, n1, n2, m)


def _gemm_shapes(a, b):
    if a.dim() not in (2, 3) or b.dim() not in (2, a.dim()) or a.shape[-1] != b.shape[-2] \
            or (b.dim() == 3 and a.shape[0] != b.shape[0]):
        raise ValueError(f"gemm: a [M, K] @ b [K, N], or a [Z, M, K] @ b [Z, K, N] or "
                         f"[K, N], got {tuple(a.shape)} and {tuple(b.shape)}")


def gemm_plain(a, b):
    counts.plain["op_gemm[gemm]"] += 1
    return a @ b


def gemm(a, b):
    """g_kernel: a @ b in f32 ([M, K] @ [K, N]; batched: a [Z, M, K] with
    b [Z, K, N] or [K, N])."""
    _check("gemm", a, b)
    _gemm_shapes(a, b)
    if a.device.type == "cpu":
        return gemm_plain(a, b)
    out = _gemm([a if a.dim() == 3 else a[None]], b, 1, "op_gemm[gemm]")[0]
    return out if a.dim() == 3 else out[0]


def _k_c_shapes(ar, ai, F):
    m = ar.shape[-1]
    if ar.dim() < 1 or ar.shape != ai.shape or F.dim() != 2 or F.shape[0] != 2 * m \
            or F.shape[1] % 2:
        raise ValueError(f"k_c: ar, ai [..., m] of one shape and F [2m, 2n], got "
                         f"{tuple(ar.shape)}, {tuple(ai.shape)} and {tuple(F.shape)}")
    return m, F.shape[1] // 2


def k_c_plain(ar, ai, F):
    counts.plain["op_gemm[k_c]"] += 1
    _, n = _k_c_shapes(ar, ai, F)
    cat = torch.cat([ar, ai], dim=-1)
    y = (cat.reshape(-1, cat.shape[-1]) @ F).reshape(ar.shape[:-1] + (2 * n,))
    return y[..., :n].contiguous(), y[..., n:].contiguous()


def k_c(ar, ai, F):
    """k_c: concat(ar, ai) on the last axis @ F [2m, 2n], split into
    (re, im), each ar.shape[:-1] + (n,)."""
    _check("k_c", ar, ai, F)
    m, n = _k_c_shapes(ar, ai, F)
    if ar.device.type == "cpu":
        return k_c_plain(ar, ai, F)
    _check_cuda("k_c", ar, ai, F)
    M = ar.numel() // m
    re, im = _gemm([ar.view(1, M, m), ai.view(1, M, m)], F, 2, "op_gemm[k_c]")
    shape = ar.shape[:-1] + (n,)
    return re.view(shape), im.view(shape)


def _fused_shapes(xb, F, V):
    if xb.dim() != 3 or xb.shape[2] % 2:
        raise ValueError(f"fused: xb must be [nb, m1, R] with R even, got {tuple(xb.shape)}")
    _, m1, R = xb.shape
    if tuple(F.shape) != (2 * m1, 2 * m1) or tuple(V.shape) != (R // 2, 1, m1):
        raise ValueError(f"fused: F [2 m1, 2 m1] and V [R/2, 1, m1] for m1 = {m1}, R = {R}, "
                         f"got {tuple(F.shape)} and {tuple(V.shape)}")


def fused_plain(xb, F, V):
    counts.plain["op_fused_axis[fused]"] += 1
    nb, m1, R = xb.shape
    y = torch.swapaxes(xb, 1, 2).reshape(nb * (R // 2), 2 * m1)
    y = (y @ F).reshape(nb, R // 2, 2, m1) * V[None]
    y = y.reshape(nb * (R // 2), 2 * m1) @ F.T
    return torch.swapaxes(y.reshape(nb, R, m1), 1, 2).contiguous()


def fused(xb, F, V):
    """f_kernel on every band of xb [nb, m1, R]: [nb, m1, R]."""
    _check("fused", xb, F, V)
    _fused_shapes(xb, F, V)
    if xb.device.type == "cpu":
        return fused_plain(xb, F, V)
    return _fused_axis(xb, F, V, "op_fused_axis[fused]")


# ---------------------------------------------------------------------------
# tools/probe_mosaic_ops.py: reshapes, a permute, f32 / 'default' / bf16 dots
# ---------------------------------------------------------------------------

def _mosaic_name(kernel, body, suffix=""):
    name = f"{kernel}[{body}]{suffix}"
    if name not in MOSAIC_NAMES:
        raise ValueError(f"{kernel}: no instantiation {name} (one of {MOSAIC_NAMES})")
    return name


def reshape_copy_plain(x, shape, body):
    counts.plain[_mosaic_name("op_transpose", body)] += 1
    return x.reshape(shape).clone()


def reshape_copy(x, shape, body):
    """Bodies (1), (5), (7): x's values in a new tensor of `shape` (a
    pallas_call writes a new buffer: one launch, a copy)."""
    name = _mosaic_name("op_transpose", body)
    _check(body, x)
    shape = tuple(shape)
    if math.prod(shape) != x.numel() or any(n < 1 for n in shape):
        raise ValueError(f"{body}: cannot reshape {tuple(x.shape)} to {shape}")
    if x.device.type == "cpu":
        return reshape_copy_plain(x, shape, body)
    return _permute_rows(x, (1, 1, 1, 1, x.numel()), name).view(shape)


def swap_dims(shape, perm):
    """(B, P, M, Q, L): a tensor of `shape` viewed so that permuting it by
    `perm`, which swaps two axes i < j and keeps the others, is
    [B, P, M, Q, L] -> [B, Q, M, P, L]."""
    perm = tuple(perm)
    moved = [k for k, p in enumerate(perm) if p != k]
    if sorted(perm) != list(range(len(shape))) or len(moved) != 2 \
            or perm[moved[0]] != moved[1]:
        raise ValueError(f"perm {perm} does not swap two axes of a {len(shape)}-D tensor")
    i, j = moved
    return (math.prod(shape[:i]), shape[i], math.prod(shape[i + 1:j]), shape[j],
            math.prod(shape[j + 1:]))


def permute_plain(x, perm, body):
    counts.plain[_mosaic_name("op_transpose", body)] += 1
    return x.permute(perm).contiguous()


def permute(x, perm, body):
    """Body (2): x permuted by `perm` (two axes swapped), in a new tensor."""
    name = _mosaic_name("op_transpose", body)
    _check(body, x)
    dims = swap_dims(x.shape, perm)
    if x.device.type == "cpu":
        return permute_plain(x, perm, body)
    return _permute_rows(x, dims, name).view([x.shape[p] for p in perm])


def _dot_shapes(body, a, b):
    """(Z, M, K, N, output shape): a [M, K] against b [K, ...] over b's
    first axis, or a [Z, M, K] @ b [Z, K, N]."""
    if a.dim() == 2 and b.dim() >= 2 and b.shape[0] == a.shape[1]:
        N = b.numel() // b.shape[0]
        return 1, a.shape[0], a.shape[1], N, (a.shape[0],) + tuple(b.shape[1:])
    if a.dim() == 3 and b.dim() == 3 and a.shape[0] == b.shape[0] and a.shape[2] == b.shape[1]:
        return a.shape[0], a.shape[1], a.shape[2], b.shape[2], \
            (a.shape[0], a.shape[1], b.shape[2])
    raise ValueError(f"{body}: a [M, K] with b [K, ...], or a [Z, M, K] with b [Z, K, N], "
                     f"got {tuple(a.shape)} and {tuple(b.shape)}")


def _dot_mode(a, precision):
    if precision not in ("highest", "default"):
        raise ValueError(f"precision must be 'highest' or 'default', got {precision!r}")
    if a.dtype == torch.bfloat16:
        if precision != "highest":
            raise ValueError("bf16 operands take precision 'highest' (nothing to round)")
        return "bf16"
    return precision


def mosaic_dot_plain(a, b, precision, body):
    mode = _dot_mode(a, precision)
    counts.plain[_mosaic_name("op_gemm", body, "" if mode == "highest" else f"[{mode}]")] += 1
    Z, M, K, N, shape = _dot_shapes(body, a, b)
    if mode == "default":
        a, b = (t.to(torch.bfloat16) for t in (a, b))
    a, b = a.float(), b.float()
    return (a @ b.reshape(K, N) if a.dim() == 2 else a @ b).reshape(shape)


def mosaic_dot(a, b, precision, body):
    """Bodies (3), (4), (6), (8): a against b in f32 out.  precision
    'highest': f32 operands; 'default': f32 operands rounded to bf16 (the
    TPU's Precision.DEFAULT), f32 products and sums; bf16 tensors: bf16
    operands, f32 products and sums."""
    mode = _dot_mode(a, precision)
    name = _mosaic_name("op_gemm", body, "" if mode == "highest" else f"[{mode}]")
    _check(body, a, b, dtype=torch.bfloat16 if mode == "bf16" else torch.float32)
    Z, M, K, N, shape = _dot_shapes(body, a, b)
    if a.device.type == "cpu":
        return mosaic_dot_plain(a, b, precision, body)
    _check_cuda(body, a, b)
    W = b.view(Z, K, N) if a.dim() == 3 else b.view(K, N)
    return _gemm([a.view(Z, M, K)], W, 1, name, mode)[0].view(shape)
