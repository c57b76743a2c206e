"""ctypes loader of the native (C++) symmetry engine.

Port of `dftk_tpu/utils/native.py`.  The port builds its own copy of the
engine, `dftk_tpu_torch/csrc/symmetry_engine.cpp`, with g++ at first use
into `build/dftk_tpu_torch/` at the root of the checkout, named by a hash
of the source, so a changed source rebuilds and an unchanged one loads the
existing library.  A failed build raises with the compiler's message.  The
caller takes its numpy path only where the engine reports that its buffer
of operations is too small (`native_symmetry_operations` returns None).
"""
import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

from .lattice import estimate_integer_lattice_bounds

_SRC = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "symmetry_engine.cpp"
_BUILD_DIR = _SRC.parent.parent.parent / "build" / "dftk_tpu_torch"
_LIB = None

_D = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)


def load_native():
    """The loaded engine, built from its source if no library of that source
    exists yet."""
    global _LIB
    if _LIB is not None:
        return _LIB
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:12]
    path = _BUILD_DIR / f"libdftk_tpu_torch_symmetry-{tag}.so"
    if not path.is_file():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found: the symmetry engine "
                               f"{_SRC.name} cannot be built") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        tmp.replace(path)
    lib = ctypes.CDLL(str(path))
    lib.lattice_point_group.restype = ctypes.c_int
    lib.lattice_point_group.argtypes = [_D, ctypes.c_double, ctypes.c_int, _IP,
                                        ctypes.c_int]
    lib.crystal_symmetries.restype = ctypes.c_int
    lib.crystal_symmetries.argtypes = [_D, _IP, ctypes.c_int, _IP, ctypes.c_int,
                                       ctypes.c_double, _IP, _D, ctypes.c_int]
    _LIB = lib
    return _LIB


def native_symmetry_operations(lattice, positions, types, tol=1e-5, max_ops=512):
    """(W list, w list) of the crystal's operations from the engine, or None
    where more than max_ops operations exist (the engine's buffer)."""
    lib = load_native()
    lattice = np.ascontiguousarray(np.asarray(lattice, dtype=np.float64))
    positions = np.ascontiguousarray(np.mod(np.asarray(positions, dtype=np.float64), 1.0))
    types = np.ascontiguousarray(np.asarray(types, dtype=np.int32))
    norms = np.linalg.norm(lattice, axis=0)
    bound = max(estimate_integer_lattice_bounds(lattice, norms.max() * (1 + 10 * tol)))

    Wbuf = np.zeros((max_ops, 9), dtype=np.int32)
    n_W = lib.lattice_point_group(lattice.ctypes.data_as(_D), tol, int(bound),
                                  Wbuf.ctypes.data_as(_IP), max_ops)
    if n_W < 0:
        return None
    if len(types) == 0:
        return [Wbuf[i].reshape(3, 3) for i in range(n_W)], [np.zeros(3)] * n_W

    Wout = np.zeros((max_ops, 9), dtype=np.int32)
    wout = np.zeros((max_ops, 3), dtype=np.float64)
    n_ops = lib.crystal_symmetries(
        positions.ctypes.data_as(_D), types.ctypes.data_as(_IP), len(types),
        Wbuf.ctypes.data_as(_IP), n_W, tol, Wout.ctypes.data_as(_IP),
        wout.ctypes.data_as(_D), max_ops)
    if n_ops < 0:
        return None
    return ([Wout[i].reshape(3, 3).astype(int) for i in range(n_ops)],
            [wout[i].copy() for i in range(n_ops)])
