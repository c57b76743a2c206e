"""Build and load the hand-written CUDA kernels of `dftk_tpu_torch/csrc`.

The sources are compiled with nvcc for sm_90a into one shared library with
a plain C interface, loaded with ctypes.  The build runs at first use on a
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dftk_axis_dft_c128": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "dftk_axis_dft_c64": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "dftk_local_plane_c128": [_P] * 7 + [_I] * 8 + [_P],
    "dftk_local_plane_c64": [_P] * 7 + [_I] * 8 + [_P],
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
    tmp = path.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    log_path.write_text(log)
    os.replace(tmp, path)
    return KernelLibrary(path, seconds, log)
