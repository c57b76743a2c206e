"""What the filter-stage probe tools share: inputs, chain timing, lines.

The probes time a chain of launches, each fed the previous output, as the
JAX probes time a `fori_loop` of their Pallas call: with CUDA events on the
card, with the host clock on the CPU (where the wrappers run their plain
versions, so those times say nothing of the card).
"""
import subprocess
import time

import numpy as np
import torch

from dftk_tpu_torch.kernels import filter_stages as fs


def device_of(device):
    """The device to run on; "cuda" without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the plain "
                           "versions on the CPU")
    return device


def header(tool, device):
    """Print the tool's name and the device (on a card: its name and power
    limit as nvidia-smi gives them)."""
    if device.type == "cuda":
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True, check=True).stdout.strip()
        except (OSError, subprocess.CalledProcessError):
            smi = "nvidia-smi not available"
        print(f"{tool}: {torch.cuda.get_device_name(device)} ({smi})", flush=True)
    else:
        print(f"{tool}: CPU, plain versions (times are not device times)", flush=True)


def make_inputs(seed, n3, m1, m2, n1, n2, nbt, t_scale, f_div, device):
    """t [n3, m2, 2, m1, nbt] * t_scale, V [n3, n1, n2] and the realified
    factors (F2f, F1f, F1b, F2b) / f_div, normal from `seed`, f32."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n3, m2, 2, m1, nbt)) * t_scale
    V = rng.standard_normal((n3, n1, n2))
    F = [rng.standard_normal(s) / f_div
         for s in ((2 * n2, 2 * m2), (2 * n1, 2 * m1), (2 * m1, 2 * n1), (2 * m2, 2 * n2))]
    conv = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return conv(t), conv(V), tuple(map(conv, F))


def make_planar_inputs(seed, n3, m1, m2, n1, n2, nbt, device):
    """The planar probe's inputs, as `tools/probe_kernel_planar.py` scales
    them: t [n3, 2, m2, m1, nbt] / 8, V [n3, n1, n2] and the eight real
    factors / 8 in the order `fs.PLANAR_FACTORS`, normal from `seed`, f32."""
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((n3, 2, m2, m1, nbt)) / 8
    V = rng.standard_normal((n3, n1, n2))
    F = [rng.standard_normal(s) / 8
         for s in ((n2, m2), (n1, m1), (m1, n1), (m2, n2)) for _ in range(2)]
    conv = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return conv(t), conv(V), tuple(map(conv, F))


def mean_ms(fn, device, iters=1):
    """Mean milliseconds of `iters` calls of fn() after one warm-up call:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def chain_total_ms(fn, x, loop):
    """Milliseconds of `loop` chained calls y = fn(y) from y = x, after one
    warm-up chain."""
    def chain():
        y = x
        for _ in range(loop):
            y = fn(y)
        return y

    return mean_ms(chain, x.device)


def vs_plain(out, ref):
    """(max abs difference, the same over max|ref|) of one application."""
    err = float((out - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-300)


def op_line(results, name, label, kernel, plain, device, iters):
    """Print one op probe's line: mean ms of `iters` back-to-back calls of
    kernel() and the kernel-vs-plain error (a tuple result compared
    stacked); results[name] = ms."""
    ms = mean_ms(kernel, device, iters)
    out, ref = kernel(), plain()
    if isinstance(out, tuple):
        out, ref = torch.stack(out), torch.stack(ref)
    err, rel = vs_plain(out, ref)
    results[name] = ms
    print(f"[ok]   {label}: {tuple(out.shape)} {ms:8.4f} ms  vs plain max_abs_err "
          f"{err:.2e} rel {rel:.2e}", flush=True)


def run_line(results, name, fn, x, loop, kernel_once, plain_once, note=""):
    """Time a chain of `loop` calls of fn from x and print the probe's line:
    ms per call and the kernel-vs-plain error of one application."""
    ms = chain_total_ms(fn, x, loop) / loop
    err, rel = vs_plain(kernel_once(), plain_once())
    results[name] = ms
    print(f"{name:56s}: {ms:8.3f} ms  vs plain max_abs_err {err:.2e} rel {rel:.2e}"
          + (f"  ({note})" if note else ""), flush=True)


def stage_line(results, name, t, V, factors, stages, loop, precision="highest",
               zblk=1, note=""):
    """run_line for one stage set of `fs.probe_stages`."""
    run_line(results, name,
             lambda a: fs.probe_stages(a, V, factors, stages, precision, zblk), t, loop,
             lambda: fs.probe_stages(t, V, factors, stages, precision, zblk),
             lambda: fs.probe_stages_plain(t, V, factors, stages, precision, zblk), note)


def copy_line(results, name, t, loop, zblk=1, note=""):
    """run_line for `fs.probe_copy`."""
    run_line(results, name, lambda a: fs.probe_copy(a, zblk), t, loop,
             lambda: fs.probe_copy(t, zblk), lambda: fs.probe_copy_plain(t), note)


def planar_line(results, name, t, V, factors, loop, precision="highest"):
    """run_line for `fs.probe_planar`."""
    run_line(results, name, lambda a: fs.probe_planar(a, V, factors, precision), t, loop,
             lambda: fs.probe_planar(t, V, factors, precision),
             lambda: fs.probe_planar_plain(t, V, factors, precision))
