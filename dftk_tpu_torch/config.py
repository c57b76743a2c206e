"""The dtype policy a basis may carry.

Port of `dftk_tpu/config.py`'s `Precision`, `default_precision` and
`mixed_precision` as torch dtypes.  The port runs in float64/complex128 by
default (`PlaneWaveBasis(dtype=torch.complex128)`); the mixed policy holds
the orbitals and transforms in complex64.  The JAX package's x64 switch and
matmul-precision setting have no counterpart (torch keeps float64 without
a switch; `dftk_tpu_torch/__init__.py` turns TF32 off), and its XLA
compile cache is a TPU measure the port leaves out (ROADMAP, "Not to
port").
"""
import dataclasses

import torch


@dataclasses.dataclass
class Precision:
    """Dtype policy carried by a PlaneWaveBasis."""
    real: torch.dtype = torch.float64
    complex: torch.dtype = torch.complex128


def default_precision():
    return Precision()


def mixed_precision():
    """complex64 orbitals and transforms (float32 real parts)."""
    return Precision(real=torch.float32, complex=torch.complex64)
