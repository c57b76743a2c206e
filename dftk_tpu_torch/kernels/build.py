"""Build and load the hand-written CUDA kernels of `dftk_tpu_torch/csrc`.

The sources are compiled with nvcc for sm_90a, one nvcc process per source
and all started together, and linked into one shared library with a plain
C interface, loaded with ctypes.  The build runs at first use on a
CUDA tensor, never at import, into `build/dftk_tpu_torch/` at the root of
the checkout, keyed by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads the existing library.

A missing nvcc or a failed build raises: there is no fallback.
"""
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = _CSRC.parent.parent / "build" / "dftk_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_MODES = ("c128", "c64", "bf16")
_SIGNATURES = {
    **{f"dftk_axis_dft_{m}": [_P, _P, _P, _I, _I, _I, _I, _I, _P] for m in _MODES},
    **{f"dftk_local_plane_{m}": [_P] * 7 + [_I] * 8 + [_P] for m in _MODES},
    "dftk_probe_copy": [_P, _P, _I, _I, _I, _P],
    "dftk_probe_stages": [_P] * 7 + [_I] * 10 + [_P],
}


class KernelLibrary:
    """The loaded library, with what its build printed and how long it took."""

    def __init__(self, path, build_seconds, log):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int

    def __getattr__(self, name):
        return getattr(self.lib, name)


def _find_nvcc():
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").is_file():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "of dftk_tpu_torch cannot be built")
    return nvcc


def build_library():
    """Compile (if needed) and load the kernel library."""
    sources = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    path = _BUILD_DIR / f"libdftk_tpu_torch_kernels-{h.hexdigest()[:16]}.so"
    log_path = path.with_suffix(".log")
    if path.is_file():
        return KernelLibrary(path, 0.0, log_path.read_text()
                             if log_path.is_file() else "")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    tag = f"tmp{os.getpid()}"
    t0 = time.perf_counter()
    objects, procs = [], []
    for src in (s for s in sources if s.suffix == ".cu"):
        obj = _BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
        objects.append(obj)
    tmp = path.with_suffix(f".{tag}.so")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}):\n"
                          f"{' '.join(link)}\n{logs[-1]}")
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    log_path.write_text(log)
    os.replace(tmp, path)
    return KernelLibrary(path, seconds, log)
