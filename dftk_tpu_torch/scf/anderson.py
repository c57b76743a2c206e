"""Anderson (DIIS / Pulay) acceleration of the SCF fixed point.

Port of `dftk_tpu/scf/anderson.py` (reference `src/scf/anderson.jl:37-130`):
a sliding window of (x_i, f_i = g(x_i) - x_i) pairs, the least-squares
problem  min || f_n - sum_i gamma_i (f_n - f_i) ||  and the extrapolation

    x_{n+1} = x_n + beta f_n - sum_i gamma_i [ (x_n - x_i) + beta (f_n - f_i) ],

regularised by column-norm scaling and a ridge.
"""
import dataclasses

import torch


@dataclasses.dataclass
class AndersonAcceleration:
    m: int = 10                # history window

    def __post_init__(self):
        self._xs = []
        self._fs = []

    def reset(self):
        """Forget the history (potential mixing's backtracking)."""
        self._xs.clear()
        self._fs.clear()

    def __call__(self, x, f, beta):
        """x, f: tensors of one shape; returns the accelerated x_{n+1}."""
        xnext = x + beta * f
        if self._xs:
            dX = torch.stack([x - xi for xi in self._xs])
            dF = torch.stack([f - fi for fi in self._fs])
            M = dF.reshape(len(self._fs), -1).T             # [N, m]
            colnorm = torch.linalg.vector_norm(M, dim=0)
            scale = torch.where(colnorm > 0, 1.0 / torch.clamp(colnorm, min=1e-300), 0.0)
            Ms = M * scale[None, :]
            ridge = 100 * torch.finfo(Ms.dtype).eps
            A = Ms.T @ Ms + ridge * torch.eye(Ms.shape[1], dtype=Ms.dtype,
                                              device=Ms.device)
            gammas = torch.linalg.solve(A, Ms.T @ f.reshape(-1)) * scale
            xnext = xnext - torch.tensordot(gammas, dX + beta * dF, dims=([0], [0]))
        self._xs.append(x)
        self._fs.append(f)
        if len(self._xs) > self.m:
            self._xs.pop(0)
            self._fs.pop(0)
        return xnext
