"""Timing and tracing utilities.

Port of `dftk_tpu/utils/timer.py` (reference `src/common/timer.jl`'s
TimerOutputs `@timing`):
  * `Timer`: seconds accumulated per label.  Where a CUDA card is
    available a section is timed with CUDA events recorded on the current
    stream around it, read after `torch.cuda.synchronize()` when the report
    (or `totals`) is asked for, so a section costs no synchronisation of
    its own; without a card it is host wall time (`time.perf_counter`).
  * `trace_scope`: a `torch.profiler.record_function` range around the
    section (it shows in a `torch.profiler` trace) that the global timer
    also times.
"""
import collections
import contextlib
import time

import torch


class Timer:
    def __init__(self):
        self._host = collections.defaultdict(float)
        self._events = collections.defaultdict(list)
        self.counts = collections.defaultdict(int)

    @contextlib.contextmanager
    def section(self, label):
        """Time the block under `label`."""
        if torch.cuda.is_available():
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            try:
                yield
            finally:
                end.record()
                self._events[label].append((start, end))
                self.counts[label] += 1
        else:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._host[label] += time.perf_counter() - t0
                self.counts[label] += 1

    @property
    def totals(self):
        """label -> seconds (synchronises the card where sections were timed
        on it)."""
        if any(self._events.values()):
            torch.cuda.synchronize()
        out = collections.defaultdict(float, self._host)
        for label, pairs in self._events.items():
            out[label] += sum(s.elapsed_time(e) for s, e in pairs) / 1e3
        return out

    def report(self):
        totals = self.totals
        lines = ["timer:"]
        for label in sorted(totals, key=totals.get, reverse=True):
            lines.append(f"  {label:<40s} {totals[label]:10.3f}s "
                         f"x{self.counts[label]}")
        return "\n".join(lines)

    def reset(self):
        self._host.clear()
        self._events.clear()
        self.counts.clear()


timer = Timer()


@contextlib.contextmanager
def trace_scope(label):
    """Annotate a region for torch.profiler (and time it on the global
    timer)."""
    with torch.profiler.record_function(label):
        with timer.section(label):
            yield


def versioninfo():
    """Environment report (analogue of DFTK.versioninfo()): the package,
    torch, CUDA, numpy, the card's name and the built kernels' directory."""
    import numpy as np
    import dftk_tpu_torch
    from ..kernels.build import _BUILD_DIR
    cuda = torch.cuda.is_available()
    lines = [
        f"dftk_tpu_torch {dftk_tpu_torch.__version__}",
        f"torch {torch.__version__} / CUDA {torch.version.cuda}",
        f"numpy {np.__version__}",
        f"device: {torch.cuda.get_device_name(0) if cuda else 'cpu (no CUDA device)'}",
        f"kernels: {_BUILD_DIR}",
    ]
    return "\n".join(lines)


def memory_usage(obj, _seen=None):
    """Rough deep memory of a basis/scfres-like object (tensors on any
    device and numpy arrays), in bytes."""
    import numpy as np
    if _seen is None:
        _seen = set()
    oid = id(obj)
    if oid in _seen:
        return 0
    _seen.add(oid)
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(memory_usage(v, _seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(memory_usage(v, _seen) for v in obj)
    if hasattr(obj, "__dict__"):
        return sum(memory_usage(v, _seen) for v in vars(obj).values())
    return 0
