"""Parametric Gaussian obstacles (counterpart of `GaussianObstacles`,
`blob_cost`, `blob_concave_bl` and `blob_terms_bl` in
`mpc_ros_tpu/models/obstacles.py`).

    cost(x, y) = sum_k w[k] * exp(-((x - cx[k])^2 + (y - cy[k])^2) gamma[k])

with gamma = 1 / (2 sigma^2). The penalty is smooth with an analytic
gradient and a PSD Gauss-Newton curvature, and is elementwise per lane, so
the whole-solve kernel evaluates it inline (`csrc/solve_mega.cu` under the
template flag BLOBS). Grid costmaps (`ObstacleMap`) and the fits from a
grid to blobs are ROADMAP Queue 1, item 5.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GaussianObstacles:
    """K Gaussian blobs per scenario: each leaf batch-major (B, K), or (K,)
    for one scenario."""

    cx: torch.Tensor      # blob centres x
    cy: torch.Tensor      # blob centres y
    gamma: torch.Tensor   # 1 / (2 sigma^2)
    w: torch.Tensor       # weights (penalty height)

    @staticmethod
    def from_sigmas(cx, cy, sigma, w) -> "GaussianObstacles":
        cx = torch.as_tensor(cx)
        sigma = torch.as_tensor(sigma, dtype=cx.dtype,
                                device=cx.device).expand(cx.shape)
        return GaussianObstacles(
            cx=cx, cy=torch.as_tensor(cy),
            gamma=1.0 / (2.0 * sigma * sigma),
            w=torch.as_tensor(w, dtype=cx.dtype,
                              device=cx.device).expand(cx.shape))

    @property
    def n_blobs(self) -> int:
        return self.cx.shape[-1]

    def to_frame(self, pose) -> "GaussianObstacles":
        """World-frame blobs in the frame of `pose` (x, y, yaw): the centres
        rotated and translated (isotropic gamma and w do not change), with
        the tracking controller's convention x_veh = dx ct + dy st,
        y_veh = dy ct - dx st."""
        px, py, yaw = (torch.as_tensor(pose[i], dtype=self.cx.dtype,
                                       device=self.cx.device)
                       for i in range(3))
        ct, st = torch.cos(yaw), torch.sin(yaw)
        dx = self.cx - px
        dy = self.cy - py
        return GaussianObstacles(cx=dx * ct + dy * st, cy=dy * ct - dx * st,
                                 gamma=self.gamma, w=self.w)

    def lane(self):
        """Lane-major views: four contiguous (K, B) tensors (cx, cy, gamma,
        w), the layout the kernel reads."""
        def t(a):
            return torch.atleast_2d(a).transpose(0, 1).contiguous()

        return t(self.cx), t(self.cy), t(self.gamma), t(self.w)


def blob_cost(blobs: GaussianObstacles, xy: torch.Tensor) -> torch.Tensor:
    """Total blob penalty over points xy (..., 2) for one scenario (blob
    leaves (K,)), summed over every leading axis."""
    dx = xy[..., 0:1] - blobs.cx
    dy = xy[..., 1:2] - blobs.cy
    return torch.sum(blobs.w * torch.exp(-(dx * dx + dy * dy) * blobs.gamma))


def blob_concave_bl(bx, by, bg, bw, x, y):
    """The blob Hessian's concave isotropic magnitude sum_k 2 g_k v_k, the
    part Gauss-Newton drops (see `blob_terms_bl`); the gated DDP backward
    subtracts it from the curvature diagonal."""
    corr = torch.zeros_like(x)
    for k in range(bx.shape[0]):
        dx = x - bx[k]
        dy = y - by[k]
        v = bw[k] * torch.exp(-(dx * dx + dy * dy) * bg[k])
        corr = corr + 2.0 * bg[k] * v
    return corr


def blob_terms_bl(bx, by, bg, bw, x, y):
    """Batch-last blob cost, gradient and Gauss-Newton curvature at points.

    bx, by, bg, bw: (K, B) lane-major blob parameters
    (`GaussianObstacles.lane`); x, y: (..., B). Returns (val, gx, gy, hxx,
    hxy, hyy), each (..., B), summed over the blobs. A blob's exact Hessian
    is v (4 g^2 d d' - 2 g I); Gauss-Newton keeps the PSD outer product
    4 g^2 v d d'."""
    zero = torch.zeros_like(x)
    val = gx = gy = hxx = hxy = hyy = zero
    for k in range(bx.shape[0]):
        dx = x - bx[k]
        dy = y - by[k]
        g = bg[k]
        v = bw[k] * torch.exp(-(dx * dx + dy * dy) * g)
        tg = 2.0 * g
        val = val + v
        gx = gx - tg * dx * v
        gy = gy - tg * dy * v
        s = tg * tg * v
        hxx = hxx + s * dx * dx
        hxy = hxy + s * dx * dy
        hyy = hyy + s * dy * dy
    return val, gx, gy, hxx, hxy, hyy
