"""15-DoF navigation state as a dataclass of tensors (port of
`voxelslam_tpu/core/state.py`).

Mirrors the reference's `IMUST` (tools.hpp:135-199): rotation R,
position p, velocity v, gyro/accel biases bg/ba, gravity g, time t and a
15x15 covariance, with boxplus/boxminus in the order [dR, dp, dv, dbg,
dba]. Every field carries the same leading batch dims, so a sliding
window is a NavState whose fields lead with `win_size`.
"""

from __future__ import annotations

import dataclasses

import torch

from . import so3
from .tensors import tmap, stack

DIM = 15          # error-state dimension (reference tools.hpp:16)
GRAVITY = 9.8     # G_m_s2 (reference tools.hpp:15)


@dataclasses.dataclass
class NavState:
    R: torch.Tensor    # (..., 3, 3)
    p: torch.Tensor    # (..., 3)
    v: torch.Tensor    # (..., 3)
    bg: torch.Tensor   # (..., 3)
    ba: torch.Tensor   # (..., 3)
    g: torch.Tensor    # (..., 3)
    t: torch.Tensor    # (...)
    cov: torch.Tensor  # (..., 15, 15)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32,
                 device=None) -> "NavState":
        """Zero state with the reference's prior covariance
        (tools.hpp:188-197): 1e-4 I, biases 1e-5 I."""
        bs = tuple(batch_shape)
        kw = dict(dtype=dtype, device=device)
        cov = torch.eye(DIM, **kw) * 1e-4
        cov[9:, 9:] = torch.eye(6, **kw) * 1e-5
        g = torch.tensor([0.0, 0.0, -GRAVITY], **kw)
        return NavState(
            R=torch.eye(3, **kw).expand(bs + (3, 3)).clone(),
            p=torch.zeros(bs + (3,), **kw),
            v=torch.zeros(bs + (3,), **kw),
            bg=torch.zeros(bs + (3,), **kw),
            ba=torch.zeros(bs + (3,), **kw),
            g=g.expand(bs + (3,)).clone(),
            t=torch.zeros(bs, **kw),
            cov=cov.expand(bs + (DIM, DIM)).clone(),
        )

    def boxplus(self, dx: torch.Tensor) -> "NavState":
        """R <- R Exp(dx[0:3]); p, v, bg, ba additive."""
        return dataclasses.replace(
            self,
            R=self.R @ so3.exp(dx[..., 0:3]),
            p=self.p + dx[..., 3:6],
            v=self.v + dx[..., 6:9],
            bg=self.bg + dx[..., 9:12],
            ba=self.ba + dx[..., 12:15],
        )

    def boxminus(self, other: "NavState") -> torch.Tensor:
        """self [-] other -> (..., 15)."""
        return torch.cat([
            so3.log(other.R.transpose(-1, -2) @ self.R),
            self.p - other.p,
            self.v - other.v,
            self.bg - other.bg,
            self.ba - other.ba,
        ], dim=-1)

    def __getitem__(self, idx) -> "NavState":
        """Index/slice the leading batch axis of every field."""
        return tmap(lambda x: x[idx], self)


def stack_states(states) -> NavState:
    """Stack a list of NavState into one batched NavState."""
    return stack(states)
