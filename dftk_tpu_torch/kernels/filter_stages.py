"""Stage probes of the realified filter chain (kernel B's work torn down).

Counterpart of the TPU probe kernels of `tools/probe_pallas_fixed.py`,
`tools/probe_kernel_pipe.py`, `tools/probe_kernel_variants.py` and
`tools/probe_kernel_incr.py`: one copy kernel (`probe_copy`) and one
stage-chain kernel template (`probe_stages`), hand-written CUDA C++ for
sm_90a in `csrc/filter_stages.cu` (which lists the JAX body each stage set
replaces), built and bound like the local-apply kernels (`kernels/build.py`).
Each has a plain PyTorch version in this module (`*_plain`).

Layout, the JAX probes' own (f32): t [n3, m2, 2, m1, nbt] (realified
band-minor filter layout), V [n3, n1, n2], factors (F2f [2n2, 2m2],
F1f [2n1, 2m1], F1b [2m1, 2n1], F2b [2m2, 2n2]).  Per z-plane the full chain
is F2f dot, repair (transpose), F1f dot, V multiply, F1b dot, repair, F2b
dot; the stage sets (STAGES) keep parts of it:
  f2         F2f, F2b                      (probe_kernel_incr k1, k1b)
  f2_rep     + both repairs                (k2)
  f2_rep_f1  + F1f, F1b                    (k3)
  full       + V: the whole chain          (k4, k_full, full(zblk), k_mdim;
                                            'default' precision: k_full_bf)
  rep        both repairs and V[z, :m1, :m2], no dots (k_rep; no factors)
  dots       full with each repair replaced by a reshape and the V multiply
             by V[z, :, 0] per row: the same dots and FLOPs, wrong math
             (what k_dots meant; that body cannot run at its own shapes).

Precision: "highest" is f32; "default" (stage set "full" only) rounds both
operands of every dot to bf16 (round to nearest even) and sums in f32, the
V multiply in f32, as k_full_bf does.  The plain versions run their dots
through torch.matmul in f32 (TF32 is off by default for matmul on CUDA).

The planar chain (`probe_planar`, a second kernel template in the same
source) is the counterpart of `tools/probe_kernel_planar.py` (k_planar,
k_planar_bf): the same chain on t [n3, 2, m2, m1, nbt] (the re and im
planes of each z-plane), V [n3, n1, n2] and eight real factors, the cosine
and sine parts of G2f [n2, m2], G1f [n1, m1], G1b [m1, n1], G2b [m2, n2]
(PLANAR_FACTORS), each complex contraction four real dots
(yr = C.xr - S.xi, yi = S.xr + C.xi) along axes 0, 1, 0, 1 of the plane:
  out[z, P, Q, b] = sum G2b[P, j] G1b[Q, i] V[z, i, j] G1f[i, q] G2f[j, p]
                    A[z, p, q, b],  A = t[:, 0] + i t[:, 1].
"default" rounds both operands of each real dot to bf16.

Dispatch is by device only: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""
import torch

from .local_apply import KernelCounts, SMEM_MAX, _raise_on_error, library

STAGES = ("f2", "f2_rep", "f2_rep_f1", "full", "rep", "dots")
BANDS_PER_BLOCK = 4                 # kBands of csrc/filter_stages.cu
COPY_SCALE = 0.999

PLANAR_FACTORS = ("C2f", "S2f", "C1f", "S1f", "C1b", "S1b", "C2b", "S2b")

counts = KernelCounts(("probe_copy",) + tuple(f"probe_stages[{s}]" for s in STAGES)
                      + ("probe_stages[full][bf16]", "probe_planar", "probe_planar[bf16]"))


def count_name(stages, precision="highest"):
    """The counts' name of one instantiation; raises on an unknown one."""
    if stages not in STAGES:
        raise ValueError(f"probe_stages: stages must be one of {STAGES}, got {stages!r}")
    if precision == "highest":
        return f"probe_stages[{stages}]"
    if precision == "default" and stages == "full":
        return "probe_stages[full][bf16]"
    raise ValueError(f"probe_stages: precision 'highest', or 'default' with stages "
                     f"'full', got {precision!r} with {stages!r}")


def _shapes(t, V, factors, stages, zblk):
    if t.dim() != 5 or t.shape[2] != 2 or V.dim() != 3:
        raise ValueError(f"probe_stages: t must be [n3, m2, 2, m1, nbt] and V "
                         f"[n3, n1, n2], got {tuple(t.shape)} and {tuple(V.shape)}")
    n3, m2, _, m1, nbt = t.shape
    _, n1, n2 = V.shape
    if V.shape[0] != n3:
        raise ValueError(f"probe_stages: V has {V.shape[0]} planes, t has {n3}")
    if zblk < 1 or n3 % zblk:
        raise ValueError(f"probe_stages: zblk {zblk} does not divide n3 = {n3}")
    if stages == "rep":
        if m1 > n1 or m2 > n2:
            raise ValueError("probe_stages: 'rep' takes V[z, :m1, :m2]; V is too small")
    else:
        want = ((2 * n2, 2 * m2), (2 * n1, 2 * m1), (2 * m1, 2 * n1), (2 * m2, 2 * n2))
        got = tuple(tuple(f.shape) for f in factors)
        if got != want:
            raise ValueError(f"probe_stages: factors {got}, expected {want}")
    return n3, m1, m2, n1, n2, nbt


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def probe_copy_plain(t):
    counts.plain["probe_copy"] += 1
    return t * COPY_SCALE


def _swap_pairs(x, r, s):
    """The repair: x [n3, 2r, s, nbt] -> [n3, 2s, r, nbt],
    out[:, s_*2+c, r_] = x[:, r_*2+c, s_]."""
    n3, nbt = x.shape[0], x.shape[-1]
    return x.reshape(n3, r, 2, s, nbt).permute(0, 3, 2, 1, 4).reshape(n3, 2 * s, r, nbt)


def probe_stages_plain(t, V, factors, stages="full", precision="highest", zblk=1):
    """The stage set `stages` applied to every z-plane of t (module
    docstring); zblk does not change the result."""
    counts.plain[count_name(stages, precision)] += 1
    n3, m1, m2, n1, n2, nbt = _shapes(t, V, factors, stages, zblk)
    if precision == "default":
        r = lambda x: x.to(torch.bfloat16).float()
    else:
        r = lambda x: x

    def dot(F, x):      # F [P, Q] . x [n3, Q, ...] -> [n3, P, cols, nbt]
        return torch.matmul(r(F), r(x).reshape(n3, F.shape[1], -1)).reshape(
            n3, F.shape[0], -1, nbt)

    A = t.reshape(n3, 2 * m2, m1, nbt)
    if stages == "rep":
        Bt = _swap_pairs(A, m2, m1)                                   # [2m1, m2]
        Cv = Bt.reshape(n3, m1, 2, m2, nbt) * V[:, :m1, None, :m2, None]
        return _swap_pairs(Cv.reshape(n3, 2 * m1, m2, nbt), m1, m2).reshape(t.shape)
    F2f, F1f, F1b, F2b = factors
    B = dot(F2f, A)                                                   # [2n2, m1]
    if stages == "dots":
        C = dot(F1f, B.reshape(n3, 2 * m1, n2, nbt))                  # [2n1, n2]
        Cv = C.reshape(n3, n1, 2, n2, nbt) * V[:, :, 0, None, None, None]
        D = dot(F1b, Cv.reshape(n3, 2 * n1, n2, nbt))                 # [2m1, n2]
        return dot(F2b, D.reshape(n3, 2 * n2, m1, nbt)).reshape(t.shape)
    if stages != "f2":
        D = _swap_pairs(B, n2, m1)                                    # Bt [2m1, n2]
        if stages != "f2_rep":
            C = dot(F1f, D)                                           # [2n1, n2]
            if stages == "full":
                C = (C.reshape(n3, n1, 2, n2, nbt)
                     * V[:, :, None, :, None]).reshape(n3, 2 * n1, n2, nbt)
            D = dot(F1b, C)                                           # [2m1, n2]
        B = _swap_pairs(D, m1, n2)                                    # Dt [2n2, m1]
    return dot(F2b, B).reshape(t.shape)


def planar_count_name(precision):
    """The counts' name of one planar instantiation; raises on an unknown one."""
    if precision not in ("highest", "default"):
        raise ValueError(f"probe_planar: precision 'highest' or 'default', got "
                         f"{precision!r}")
    return "probe_planar" if precision == "highest" else "probe_planar[bf16]"


def _planar_shapes(t, V, factors):
    if t.dim() != 5 or t.shape[1] != 2 or V.dim() != 3:
        raise ValueError(f"probe_planar: t must be [n3, 2, m2, m1, nbt] and V "
                         f"[n3, n1, n2], got {tuple(t.shape)} and {tuple(V.shape)}")
    n3, _, m2, m1, nbt = t.shape
    _, n1, n2 = V.shape
    if V.shape[0] != n3:
        raise ValueError(f"probe_planar: V has {V.shape[0]} planes, t has {n3}")
    want = tuple(s for s in ((n2, m2), (n1, m1), (m1, n1), (m2, n2)) for _ in range(2))
    got = tuple(tuple(f.shape) for f in factors)
    if got != want:
        raise ValueError(f"probe_planar: factors {PLANAR_FACTORS} {got}, expected {want}")
    return n3, m1, m2, n1, n2, nbt


def probe_planar_plain(t, V, factors, precision="highest"):
    """The planar chain on every z-plane of t (module docstring), each real
    dot one torch.matmul in f32."""
    counts.plain[planar_count_name(precision)] += 1
    n3, m1, m2, n1, n2, nbt = _planar_shapes(t, V, factors)
    r = (lambda x: x.to(torch.bfloat16).float()) if precision == "default" else (lambda x: x)

    def dot(F, x, axis):      # F [P, Q] contracts axis 0 or 1 of x [n3, R0, R1, nbt]
        if axis == 0:
            return torch.matmul(r(F), r(x).reshape(n3, x.shape[1], -1)).reshape(
                n3, F.shape[0], x.shape[2], nbt)
        return torch.matmul(r(F), r(x)).transpose(1, 2)

    def cplx(Cm, Sm, xr, xi, axis):
        return (dot(Cm, xr, axis) - dot(Sm, xi, axis),
                dot(Sm, xr, axis) + dot(Cm, xi, axis))

    c2f, s2f, c1f, s1f, c1b, s1b, c2b, s2b = factors
    Br, Bi = cplx(c2f, s2f, t[:, 0], t[:, 1], 0)                   # [n2, m1]
    Cr, Ci = cplx(c1f, s1f, Br, Bi, 1)                             # [n1, n2]
    Vz = V[:, :, :, None]
    Dr, Di = cplx(c1b, s1b, Cr * Vz, Ci * Vz, 0)                   # [m1, n2]
    Er, Ei = cplx(c2b, s2b, Dr, Di, 1)                             # [m2, m1]
    return torch.stack((Er, Ei), dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name, t, *others):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device or the CPU, "
                         f"got {t.device}")
    for x in (t,) + others:
        if x.device != t.device:
            raise ValueError(f"{name}: all tensors must be on {t.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: float32 expected, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _plane_checks(name, t, zblk):
    if t.dim() != 5:
        raise ValueError(f"{name}: t must be [n3, m2, 2, m1, nbt], got {tuple(t.shape)}")
    n3, nbt = t.shape[0], t.shape[-1]
    if nbt % BANDS_PER_BLOCK:
        raise ValueError(f"{name}: nbt = {nbt} is not a multiple of {BANDS_PER_BLOCK}")
    if zblk < 1 or n3 % zblk:
        raise ValueError(f"{name}: zblk {zblk} does not divide n3 = {n3}")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: more than 2^31 - 1 elements")


def probe_copy(t, zblk=1):
    """out = 0.999 t, one block per zblk planes of t [n3, ...]."""
    if t.device.type == "cpu":
        return probe_copy_plain(t)
    _check_cuda("probe_copy", t)
    _plane_checks("probe_copy", t, zblk)
    if t.data_ptr() % 16:
        raise ValueError("probe_copy: t must be 16-byte aligned")
    out = torch.empty_like(t)
    err = library().dftk_probe_copy(t.data_ptr(), out.data_ptr(), t.shape[0],
                                    t[0].numel(), zblk,
                                    torch.cuda.current_stream(t.device).cuda_stream)
    _raise_on_error("probe_copy", err)
    counts.launches["probe_copy"] += 1
    return out


def probe_stages_smem(stages, m1, m2, n1, n2, strip):
    """Bytes of dynamic shared memory one block of the stage kernel uses."""
    per_band = 2 * (2 * m1 * (m2 if stages == "rep" else max(m2, n2)))
    if stages in ("f2_rep_f1", "full", "dots"):
        per_band += 2 * n1 * strip
    return per_band * BANDS_PER_BLOCK * 4


def _widest_strip(name, fixed, m1, m2, n1, n2):
    """The widest divisor of n2 whose [2n1, strip] buffer of BANDS_PER_BLOCK
    bands fits in shared memory beside `fixed` bytes."""
    widest = min(n2, (SMEM_MAX - fixed) // (2 * n1 * BANDS_PER_BLOCK * 4))
    if widest < 1:
        raise ValueError(f"{name}: planes m=({m1},{m2}), n=({n1},{n2}) need "
                         f"more than the {SMEM_MAX} B of shared memory a block may use")
    return max(w for w in range(1, widest + 1) if n2 % w == 0)


def probe_stages_strip(m1, m2, n1, n2):
    """Columns of j2 per F1 strip: the widest divisor of n2 whose strip
    buffer fits beside the two ping-pong buffers."""
    return _widest_strip("probe_stages", probe_stages_smem("full", m1, m2, n1, n2, 0),
                         m1, m2, n1, n2)


def probe_stages(t, V, factors, stages="full", precision="highest", zblk=1):
    """The stage set `stages` on every z-plane of t [n3, m2, 2, m1, nbt]
    (module docstring), one block per 4 bands of zblk planes; `factors`
    (F2f, F1f, F1b, F2b) may be None for 'rep'."""
    name = count_name(stages, precision)
    if t.device.type == "cpu":
        return probe_stages_plain(t, V, factors, stages, precision, zblk)
    factors = () if stages == "rep" else tuple(factors)     # 'rep' reads none
    _check_cuda("probe_stages", t, V, *factors)
    _plane_checks("probe_stages", t, zblk)
    n3, m1, m2, n1, n2, nbt = _shapes(t, V, factors, stages, zblk)
    strip = 1 if stages == "rep" else probe_stages_strip(m1, m2, n1, n2)
    f_ptrs = [f.data_ptr() for f in factors] or [None] * 4
    out = torch.empty_like(t)
    err = library().dftk_probe_stages(
        t.data_ptr(), V.data_ptr(), *f_ptrs, out.data_ptr(), n3, m1, m2, n1, n2, nbt,
        zblk, strip,
        STAGES.index(stages), int(precision == "default"),
        torch.cuda.current_stream(t.device).cuda_stream)
    _raise_on_error("probe_stages", err)
    counts.launches[name] += 1
    return out


def probe_planar_smem(m1, m2, n1, n2, strip):
    """Bytes of dynamic shared memory one block of the planar kernel uses:
    A/D (D's rows padded by one band group), B (rows padded), the strip."""
    b = BANDS_PER_BLOCK
    x = max(2 * m2 * m1 * b, 2 * m1 * (n2 + 1) * b)
    return (x + 2 * n2 * (m1 + 1) * b + 2 * n1 * strip * b) * 4


def probe_planar_strip(m1, m2, n1, n2):
    """Columns of j2 per C/D strip of the planar kernel: the widest divisor
    of n2 that fits."""
    return _widest_strip("probe_planar", probe_planar_smem(m1, m2, n1, n2, 0),
                         m1, m2, n1, n2)


def probe_planar(t, V, factors, precision="highest"):
    """The planar chain on every z-plane of t [n3, 2, m2, m1, nbt] (module
    docstring), one block per 4 bands of one plane; `factors` are the eight
    real factors in the order PLANAR_FACTORS."""
    name = planar_count_name(precision)
    factors = tuple(factors)
    if t.device.type == "cpu":
        return probe_planar_plain(t, V, factors, precision)
    _check_cuda("probe_planar", t, V, *factors)
    _plane_checks("probe_planar", t, 1)
    n3, m1, m2, n1, n2, nbt = _planar_shapes(t, V, factors)
    strip = probe_planar_strip(m1, m2, n1, n2)
    out = torch.empty_like(t)
    err = library().dftk_probe_planar(
        t.data_ptr(), V.data_ptr(), *(f.data_ptr() for f in factors), out.data_ptr(),
        n3, m1, m2, n1, n2, nbt, strip, int(precision == "default"),
        torch.cuda.current_stream(t.device).cuda_stream)
    _raise_on_error("probe_planar", err)
    counts.launches[name] += 1
    return out
