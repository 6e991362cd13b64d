"""Obstacle penalty terms (counterpart of `mpc_ros_tpu/models/obstacles.py`):
grid costmaps (`ObstacleMap`) and parametric Gaussian blobs
(`GaussianObstacles`).

A grid costmap is a cost grid in [0, 1] sampled along the predicted (x, y)
horizon in one of three ways (`ObstacleMap.sampling`): "bilinear" (C0,
value-exact at the cells), "spline" (the C1 quadratic B-spline, 9-tap
stencil) and "spline_coeff" (the same surface from per-cell bi-quadratic
coefficient planes). Grid maps never run in a kernel: they take the XLA
lane path and the single-scenario solver, as in the JAX package. The
production route turns each grid into blobs (`fit_gaussians_to_map` on the
host, `fit_gaussians_to_maps` on the device for a batch of maps), which
the whole-solve kernel evaluates inline (`csrc/solve_mega.cu` under the
template flag BLOBS):

    cost(x, y) = sum_k w[k] * exp(-((x - cx[k])^2 + (y - cy[k])^2) gamma[k])

with gamma = 1 / (2 sigma^2), smooth with an analytic gradient and a PSD
Gauss-Newton curvature.

Out-of-range coordinates. The JAX functions convert floor(fx) (or
round(fx)) to int32 and clip it to the grid, where XLA saturates NaN to 0
and +-inf to the int32 limits. A float-to-int conversion of NaN or inf is
undefined in PyTorch, so every index here is clamped in floating point
first (NaN to 0, then the clip's range) and converted after: the same
cell as the JAX package for every state, far-off, infinite and NaN ones
included, and every gather provably in range.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.consts import const
from ..ops.linspace import linspace


@dataclasses.dataclass(frozen=True)
class ObstacleMap:
    """Robot- or world-frame cost grid: grid[iy, ix] in [0, 1] at
    x = origin[0] + ix * resolution, y = origin[1] + iy * resolution.

    One map has grid (H, W), origin (2,), 0-d resolution and weight; a
    batch of maps (one per scenario or robot) has grid (B, H, W), origin
    (B, 2), resolution (B,) and weight (B,). `sampling` is "bilinear",
    "spline" or "spline_coeff" (see the module docstring); `coeff`, when
    attached, holds the spline's per-cell coefficient planes ((H, W, 9) or
    (B, H, W, 9), `spline_coeff_planes`) so that spline sampling is one
    row gather and a Horner evaluation. Update the grid through
    `with_grid`, which re-derives attached planes; `replace(grid=...)`
    keeps the old ones."""

    grid: torch.Tensor
    origin: torch.Tensor
    resolution: torch.Tensor
    weight: torch.Tensor
    sampling: str = "bilinear"
    coeff: Optional[torch.Tensor] = None

    @staticmethod
    def empty(extent: float = 4.0, cells: int = 64, weight: float = 0.0,
              dtype=torch.float32, device=None) -> "ObstacleMap":
        """Centred empty map of +-extent/2 metres."""
        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        return ObstacleMap(
            grid=torch.zeros((cells, cells), dtype=dtype, device=device),
            origin=t([-extent / 2, -extent / 2]),
            resolution=t(extent / cells), weight=t(weight))

    def replace(self, **kw) -> "ObstacleMap":
        return dataclasses.replace(self, **kw)

    def to(self, dtype=None, device=None) -> "ObstacleMap":
        """Every tensor leaf as `dtype` on `device` (numpy leaves become
        tensors); the leaves already there are not copied."""
        def t(a):
            if a is None:
                return None
            a = torch.as_tensor(a)
            return a.to(device=device if device is not None else a.device,
                        dtype=dtype if dtype is not None else a.dtype)

        return self.replace(grid=t(self.grid), origin=t(self.origin),
                            resolution=t(self.resolution),
                            weight=t(self.weight), coeff=t(self.coeff))

    def for_solver(self, dtype, device) -> "ObstacleMap":
        """The map as the solvers read it: its leaves as `dtype` on
        `device`, and a spline_coeff map's planes attached (derived here
        once, not on every sampling)."""
        m = self.to(dtype, device)
        if m.coeff is None and m.sampling == "spline_coeff":
            m = m.with_spline_coeffs()
        return m

    def with_spline_coeffs(self) -> "ObstacleMap":
        """The map with its spline coefficient planes attached (9x the
        grid's memory); spline sampling only."""
        assert self.sampling in ("spline", "spline_coeff"), \
            "coefficient planes apply to spline sampling only"
        return self.replace(coeff=spline_coeff_planes(self.grid))

    def with_grid(self, grid) -> "ObstacleMap":
        """A new cost grid, the attached coefficient planes re-derived from
        it."""
        m = self.replace(grid=torch.as_tensor(
            grid, dtype=self.grid.dtype, device=self.grid.device))
        if self.coeff is not None:
            m = m.replace(coeff=spline_coeff_planes(m.grid))
        return m


def _sampling_mode(omap) -> str:
    """'spline' (the stencil and the coefficient-plane spelling, one
    surface) or 'bilinear'; an unknown string raises."""
    s = omap.sampling
    if s in ("spline", "spline_coeff"):
        return "spline"
    if s == "bilinear":
        return "bilinear"
    raise ValueError(
        f"unknown ObstacleMap.sampling {s!r}; expected 'bilinear', "
        f"'spline', or 'spline_coeff'")


def _cell_index(f, op, lo: int, hi: int) -> torch.Tensor:
    """clip(int32(op(f)), lo, hi) as XLA computes it (NaN -> 0, +-inf ->
    the int32 limits, then the clip), clamped in floating point before
    the conversion: an int64 index tensor."""
    g = torch.nan_to_num(op(f), nan=0.0)
    return torch.clamp(g, lo, hi).to(torch.int64)


def _lane_leaf(v, nd: int):
    """A per-map leaf (B,) shaped (B, 1, ..., 1) to broadcast against
    (B, ...) points of `nd` dims; a 0-d leaf unchanged."""
    if v.dim() == 0:
        return v
    return v.reshape(v.shape[:1] + (1,) * (nd - 1))


def _map_index(grid, like: torch.Tensor):
    """For a batch of maps, the map index of every point of `like`
    (B, ...); None for one map."""
    if grid.dim() == 2:
        return None
    return torch.arange(grid.shape[0], device=grid.device).reshape(
        (-1,) + (1,) * (like.dim() - 1)).expand(like.shape)


def _at(grid, b, iy, ix):
    return grid[iy, ix] if b is None else grid[b, iy, ix]


def _xy_frac(origin, resolution, xy):
    """fx, fy in cell units (and the resolution, shaped to broadcast) for
    points xy (..., 2) of one map, or (B, ..., 2) of a batch of maps."""
    nd = xy.dim() - 1
    res = _lane_leaf(resolution, nd)
    ox = _lane_leaf(origin[..., 0], nd)
    oy = _lane_leaf(origin[..., 1], nd)
    return (xy[..., 0] - ox) / res, (xy[..., 1] - oy) / res, res


def _bilinear_frac(grid, fx, fy, b):
    """The bilinear corners and offsets at fx, fy (cell units)."""
    H, W = grid.shape[-2:]
    x0 = _cell_index(fx, torch.floor, 0, W - 2)
    y0 = _cell_index(fy, torch.floor, 0, H - 2)
    tx = torch.clamp(fx - x0.to(fx.dtype), 0.0, 1.0)
    ty = torch.clamp(fy - y0.to(fy.dtype), 0.0, 1.0)
    return (tx, ty, _at(grid, b, y0, x0), _at(grid, b, y0, x0 + 1),
            _at(grid, b, y0 + 1, x0), _at(grid, b, y0 + 1, x0 + 1))


def bilinear_sample(grid: torch.Tensor, origin, resolution,
                    xy: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample grid at continuous points xy (..., 2); a batch of
    grids (B, H, W) with origin (B, 2) and resolution (B,) samples points
    (B, ..., 2), map b at points b. Out-of-map points clamp to the border
    cell."""
    fx, fy, _ = _xy_frac(origin, resolution, xy)
    tx, ty, g00, g01, g10, g11 = _bilinear_frac(grid, fx, fy,
                                                _map_index(grid, fx))
    return ((1 - ty) * ((1 - tx) * g00 + tx * g01)
            + ty * ((1 - tx) * g10 + tx * g11))


def _spline_terms_xy(omap: ObstacleMap, xy: torch.Tensor):
    """(val, dx, dy, hxx, hyy) per point of the spline surface, weight-
    scaled: the single-map form (a batch of maps samples points (B, ...,
    2), as the JAX form mapped over the maps)."""
    grid = omap.grid
    H, W = grid.shape[-2:]
    # the centre knot clamps to [1, n-2]: an empty range below 3x3
    assert H >= 3 and W >= 3, \
        f"sampling='spline' needs a >=3x3 grid, got {H}x{W}"
    if omap.coeff is None and omap.sampling == "spline_coeff":
        # planes asked for but not attached: derived from the grid here
        omap = omap.replace(coeff=spline_coeff_planes(grid))
    fx, fy, res = _xy_frac(omap.origin, omap.resolution, xy)
    b = _map_index(grid, fx)
    wgt = _lane_leaf(omap.weight, fx.dim())
    if omap.coeff is not None:
        return _coeff_terms_core(omap.coeff.reshape(-1, 9), fx, fy, H, W,
                                 res, wgt, b_idx=b)
    mx, wx, dwx = _spline_weights(fx, W)
    my, wy, dwy = _spline_weights(fy, H)
    zero = torch.zeros_like(fx)
    val = dx = dy = hxx = hyy = zero
    d2 = (1.0, -2.0, 1.0)
    for j in range(3):
        for i in range(3):
            g = _at(grid, b, my + (j - 1), mx + (i - 1))
            val = val + wx[i] * wy[j] * g
            dx = dx + dwx[i] * wy[j] * g
            dy = dy + wx[i] * dwy[j] * g
            hxx = hxx + d2[i] * wy[j] * g
            hyy = hyy + wx[i] * d2[j] * g
    return _masked_terms(val, dx, dy, hxx, hyy, fx, fy, H, W, res, wgt)


def _masked_terms(val, dx, dy, hxx, hyy, fx, fy, H: int, W: int, res, wgt):
    """The spline terms scaled by the weight and 1/res, the gradient and
    curvature masked per axis: outside in x the field is frozen along x,
    so dx and hxx are 0 there while dy and hyy in the x border strip stay
    (and the other way round)."""
    in_x = torch.logical_and(fx >= 0.0, fx <= W - 1.0).to(fx.dtype)
    in_y = torch.logical_and(fy >= 0.0, fy <= H - 1.0).to(fy.dtype)
    inv_r = 1.0 / res
    return (wgt * val,
            wgt * dx * inv_r * in_x,
            wgt * dy * inv_r * in_y,
            wgt * torch.clamp_min(hxx, 0.0) * inv_r * inv_r * in_x,
            wgt * torch.clamp_min(hyy, 0.0) * inv_r * inv_r * in_y)


def obstacle_cost(omap: ObstacleMap, xy: torch.Tensor) -> torch.Tensor:
    """Total obstacle penalty over points xy (..., 2), summed over every
    leading axis."""
    if _sampling_mode(omap) == "spline":
        val, _, _, _, _ = _spline_terms_xy(omap, xy)
        return torch.sum(val)
    vals = bilinear_sample(omap.grid, omap.origin, omap.resolution, xy)
    return omap.weight * torch.sum(vals)


def obstacle_knot_cost(omap: ObstacleMap, xy: torch.Tensor) -> torch.Tensor:
    """`obstacle_cost` of each trajectory: points xy (..., N, 2) summed
    over the knot axis alone -> (...). A batch of maps takes points (B,
    ..., N, 2), map b on trajectories b (the JAX function mapped over the
    scenarios)."""
    if _sampling_mode(omap) == "spline":
        val, _, _, _, _ = _spline_terms_xy(omap, xy)
        return torch.sum(val, dim=-1)
    vals = bilinear_sample(omap.grid, omap.origin, omap.resolution, xy)
    return _lane_leaf(omap.weight, vals.dim() - 1) * torch.sum(vals, dim=-1)


def obstacle_grad_xy(omap: ObstacleMap, xy: torch.Tensor) -> torch.Tensor:
    """Analytic d(weight * sample)/d(x, y) per point; shape like xy.
    Bilinear: d/dx = [(1-ty)(g01-g00) + ty(g11-g10)] / res, d/dy =
    [(1-tx)(g10-g00) + tx(g11-g01)] / res, 0 outside the map per axis."""
    if _sampling_mode(omap) == "spline":
        _, dx, dy, _, _ = _spline_terms_xy(omap, xy)
        return torch.stack([dx, dy], dim=-1)
    grid = omap.grid
    H, W = grid.shape[-2:]
    fx, fy, res = _xy_frac(omap.origin, omap.resolution, xy)
    tx, ty, g00, g01, g10, g11 = _bilinear_frac(grid, fx, fy,
                                                _map_index(grid, fx))
    dx = ((1 - ty) * (g01 - g00) + ty * (g11 - g10)) / res
    dy = ((1 - tx) * (g10 - g00) + tx * (g11 - g01)) / res
    # outside the map the sample is flat per axis: no phantom slope
    dx = dx * torch.logical_and(fx >= 0.0, fx <= W - 1.0).to(dx.dtype)
    dy = dy * torch.logical_and(fy >= 0.0, fy <= H - 1.0).to(dy.dtype)
    wgt = _lane_leaf(omap.weight, fx.dim() + 1)
    return wgt * torch.stack([dx, dy], dim=-1)


def obstacle_curv_xy(omap: ObstacleMap, xy: torch.Tensor):
    """PSD curvature (hxx, hyy) per point, weight-scaled: the spline's
    analytic second derivatives, or for bilinear the one-cell central
    second difference clamped at 0 (the form of `obstacle_curv_bl`)."""
    if _sampling_mode(omap) == "spline":
        _, _, _, hxx, hyy = _spline_terms_xy(omap, xy)
        return hxx, hyy
    nd = xy.dim() - 1
    res = _lane_leaf(omap.resolution, nd)
    wgt = _lane_leaf(omap.weight, nd)
    x, y = xy[..., 0], xy[..., 1]

    def v(qx, qy):
        return wgt * bilinear_sample(omap.grid, omap.origin,
                                     omap.resolution,
                                     torch.stack([qx, qy], dim=-1))

    # xy +- (res, 0) and +- (0, res): y + 0 * res is y
    c0 = v(x, y)
    inv_r2 = 1.0 / (res * res)
    hxx = torch.clamp_min((v(x + res, y) - 2.0 * c0 + v(x - res, y))
                          * inv_r2, 0.0)
    hyy = torch.clamp_min((v(x, y + res) - 2.0 * c0 + v(x, y - res))
                          * inv_r2, 0.0)
    return hxx, hyy


# per-axis quadratic B-spline basis as polynomials in the fractional offset
# s (cell units, s in [-0.5, 0.5]): w_i(s) = sum_p A[p, i] s^p with
#   w0 = 0.5(0.5-s)^2, w1 = 0.75 - s^2, w2 = 0.5(0.5+s)^2
_SPLINE_A = ((0.125, 0.75, 0.125),
             (-0.5, 0.0, 0.5),
             (0.5, -1.0, 0.5))


def spline_coeff_planes(grid: torch.Tensor) -> torch.Tensor:
    """Per-cell bi-quadratic coefficient planes of the quadratic B-spline
    surface: grid (..., H, W) -> (..., H, W, 9) with
        value(sx, sy) = sum_{p,q} C[..., my, mx, 3 p + q] sx^p sy^q,
    sx, sy the offsets from the (clamped) centre knot. The border rows and
    columns are edge-padded copies, never addressed (the centre knot
    clamps to [1, n-2])."""
    g = grid
    assert g.shape[-2] >= 3 and g.shape[-1] >= 3, \
        ("spline coefficient planes need >=3x3 grids (the center knot "
         f"clamps to [1, n-2]), got {g.shape[-2]}x{g.shape[-1]}")
    H, W = g.shape[-2], g.shape[-1]
    # edge padding by one cell on both axes
    iy = torch.clamp(torch.arange(-1, H + 1, device=g.device), 0, H - 1)
    ix = torch.clamp(torch.arange(-1, W + 1, device=g.device), 0, W - 1)
    gp = g[..., iy, :][..., ix]
    A = _SPLINE_A
    planes = []
    for p in range(3):
        for q in range(3):
            c = None
            for i in range(3):
                for j in range(3):
                    aa = A[p][i] * A[q][j]
                    if aa == 0.0:
                        continue
                    term = aa * gp[..., j:j + H, i:i + W]
                    c = term if c is None else c + term
            planes.append(c)
    return torch.stack(planes, dim=-1)           # (..., H, W, 9)


def _spline_coeff_eval(c9, sx, sy):
    """The bi-quadratic and its derivatives from gathered per-cell
    coefficients c9 (..., 9) at offsets sx, sy: (val, d/dsx, d/dsy,
    d2/dsx2, d2/dsy2) in cell units."""
    c = [c9[..., k] for k in range(9)]
    # S_q(sx) = sum_p c[3p+q] sx^p
    S = [c[q] + sx * (c[3 + q] + sx * c[6 + q]) for q in range(3)]
    dS = [c[3 + q] + 2.0 * sx * c[6 + q] for q in range(3)]
    val = S[0] + sy * (S[1] + sy * S[2])
    dvx = dS[0] + sy * (dS[1] + sy * dS[2])
    dvy = S[1] + 2.0 * sy * S[2]
    hxx = 2.0 * (c[6] + sy * (c[7] + sy * c[8]))
    hyy = 2.0 * (S[2])
    return val, dvx, dvy, hxx, hyy


def _coeff_terms_core(coeff_rows, fx, fy, H: int, W: int, res, wgt,
                      b_idx=None):
    """The coefficient-plane evaluation shared by the single-map and lane
    forms: the centre knot and offsets clamped as in `_spline_weights`,
    one row gather (rows of map b_idx when given), Horner, the per-axis
    masks and the weight and 1/res scaling."""
    mx = _cell_index(fx, torch.round, 1, W - 2)
    my = _cell_index(fy, torch.round, 1, H - 2)
    sx = torch.clamp(fx - mx.to(fx.dtype), -0.5, 0.5)
    sy = torch.clamp(fy - my.to(fy.dtype), -0.5, 0.5)
    cell = my * W + mx
    if b_idx is not None:
        cell = b_idx * (H * W) + cell
    c9 = coeff_rows[cell]
    val, dvx, dvy, hxx, hyy = _spline_coeff_eval(c9, sx, sy)
    return _masked_terms(val, dvx, dvy, hxx, hyy, fx, fy, H, W, res, wgt)


def _spline_weights(f, n: int):
    """3-tap quadratic B-spline weights and derivatives on one axis: f in
    cell units, n the axis size. The centre knot clamps one cell inside
    (every tap in range); the offset clamps to the basis support, which
    freezes the value in the half-cell border strip."""
    m = _cell_index(f, torch.round, 1, n - 2)
    s = torch.clamp(f - m.to(f.dtype), -0.5, 0.5)
    w = (0.5 * (0.5 - s) ** 2, 0.75 - s * s, 0.5 * (0.5 + s) ** 2)
    dw = (s - 0.5, -2.0 * s, s + 0.5)
    return m, w, dw


def _lane_frac(omaps: ObstacleMap, x, y):
    """fx, fy (..., B) of lane-major points against a batch of maps."""
    res = omaps.resolution
    return ((x - omaps.origin[:, 0]) / res, (y - omaps.origin[:, 1]) / res,
            res)


def _spline_coeff_terms_bl(omaps: ObstacleMap, x, y):
    """The coefficient-plane form of `_spline_terms_bl`: one row gather
    of the (B, H, W, 9) planes and Horner per point."""
    B, H, W = omaps.grid.shape
    fx, fy, res = _lane_frac(omaps, x, y)
    b_idx = torch.arange(B, device=x.device).expand(fx.shape)
    return _coeff_terms_core(omaps.coeff.reshape(B * H * W, 9), fx, fy,
                             H, W, res, omaps.weight, b_idx=b_idx)


def _spline_terms_bl(omaps: ObstacleMap, x, y):
    """The spline field's terms, lane-major: (val, dx, dy, hxx, hyy), each
    shaped like x (..., B), weight-scaled, the curvature PSD-clamped. With
    attached coefficient planes (or sampling 'spline_coeff', which derives
    them here) the evaluation takes the row-gather form."""
    assert omaps.grid.shape[-2] >= 3 and omaps.grid.shape[-1] >= 3, \
        ("sampling='spline' needs >=3x3 grids, got "
         f"{omaps.grid.shape[-2]}x{omaps.grid.shape[-1]}")
    if omaps.coeff is None and omaps.sampling == "spline_coeff":
        omaps = omaps.replace(coeff=spline_coeff_planes(omaps.grid))
    if omaps.coeff is not None:
        return _spline_coeff_terms_bl(omaps, x, y)
    grids = omaps.grid
    B, H, W = grids.shape
    flat = grids.reshape(B * H * W)
    fx, fy, res = _lane_frac(omaps, x, y)
    mx, wx, dwx = _spline_weights(fx, W)
    my, wy, dwy = _spline_weights(fy, H)
    b_idx = torch.arange(B, device=x.device).expand(mx.shape)
    base = (b_idx * H + my) * W + mx
    zero = torch.zeros_like(x)
    val = dx = dy = hxx = hyy = zero
    d2 = (1.0, -2.0, 1.0)
    for j in range(3):
        row = base + (j - 1) * W
        for i in range(3):
            g = flat[row + (i - 1)]
            val = val + wx[i] * wy[j] * g
            dx = dx + dwx[i] * wy[j] * g
            dy = dy + wx[i] * dwy[j] * g
            hxx = hxx + d2[i] * wy[j] * g
            hyy = hyy + wx[i] * d2[j] * g
    return _masked_terms(val, dx, dy, hxx, hyy, fx, fy, H, W, res,
                         omaps.weight)


def obstacle_cost_grad_bl(omaps: ObstacleMap, x: torch.Tensor,
                          y: torch.Tensor):
    """Lane-major sampling of per-scenario maps (leaves with a leading B)
    at points x, y (..., B): (cost, dx, dy), each (..., B), weight-scaled.
    Bilinear is four flat gathers per point; the spline modes take the
    9-tap or the coefficient-plane form."""
    if _sampling_mode(omaps) == "spline":
        val, dx, dy, _, _ = _spline_terms_bl(omaps, x, y)
        return val, dx, dy
    grids = omaps.grid                        # (B, H, W)
    B, H, W = grids.shape
    flat = grids.reshape(B * H * W)
    wgt = omaps.weight
    fx, fy, res = _lane_frac(omaps, x, y)
    x0 = _cell_index(fx, torch.floor, 0, W - 2)
    y0 = _cell_index(fy, torch.floor, 0, H - 2)
    tx = torch.clamp(fx - x0.to(fx.dtype), 0.0, 1.0)
    ty = torch.clamp(fy - y0.to(fy.dtype), 0.0, 1.0)
    b_idx = torch.arange(B, device=x.device).expand(x0.shape)
    base = (b_idx * H + y0) * W + x0
    g00 = flat[base]
    g01 = flat[base + 1]
    g10 = flat[base + W]
    g11 = flat[base + W + 1]
    val = ((1 - ty) * ((1 - tx) * g00 + tx * g01)
           + ty * ((1 - tx) * g10 + tx * g11))
    dx = ((1 - ty) * (g01 - g00) + ty * (g11 - g10)) / res
    dy = ((1 - tx) * (g10 - g00) + tx * (g11 - g01)) / res
    # the clamped axis has no gradient outside the map
    dx = dx * torch.logical_and(fx >= 0.0, fx <= W - 1.0).to(dx.dtype)
    dy = dy * torch.logical_and(fy >= 0.0, fy <= H - 1.0).to(dy.dtype)
    return wgt * val, wgt * dx, wgt * dy


def obstacle_curv_bl(omaps: ObstacleMap, x: torch.Tensor, y: torch.Tensor):
    """PSD curvature (hxx, hyy) of the grid penalty, lane-major,
    weight-scaled. A bilinear surface has no pure second derivative inside
    a cell, so a backward fed its gradient alone has no stiffness and hard
    lanes die in rejected-step spirals; this takes the one-cell central
    second difference of the bilinear surface, clamped at 0 (a
    Gauss-Newton-like diagonal; the gradient and the fixed points are
    unchanged). The spline modes return their analytic second
    derivatives."""
    if _sampling_mode(omaps) == "spline":
        _, _, _, hxx, hyy = _spline_terms_bl(omaps, x, y)
        return hxx, hyy
    c0, _, _ = obstacle_cost_grad_bl(omaps, x, y)
    res = omaps.resolution
    cxp, _, _ = obstacle_cost_grad_bl(omaps, x + res, y)
    cxm, _, _ = obstacle_cost_grad_bl(omaps, x - res, y)
    cyp, _, _ = obstacle_cost_grad_bl(omaps, x, y + res)
    cym, _, _ = obstacle_cost_grad_bl(omaps, x, y - res)
    inv_r2 = 1.0 / (res * res)
    hxx = torch.clamp_min((cxp - 2.0 * c0 + cxm) * inv_r2, 0.0)
    hyy = torch.clamp_min((cyp - 2.0 * c0 + cym) * inv_r2, 0.0)
    return hxx, hyy


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
        px, py, yaw = (const(pose[i], self.cx.dtype, self.cx.device)
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


def fit_gaussians_to_map(omap: ObstacleMap, n_blobs: int = 4,
                         min_peak: float = 1e-3,
                         refine: bool = True) -> GaussianObstacles:
    """Fit K Gaussian blobs to one grid costmap: greedy peak peeling, then
    (with `refine`) a bounded least-squares refinement of all of them.

    Greedy: take the residual grid's peak cell, sigma from the discrete
    log-curvature at the peak (d2/dx2 log g = -1/sigma^2), subtract the
    blob, clamp at 0, repeat. Peaks below `min_peak` give zero-weight
    padding blobs. The refinement (scipy `least_squares`, centres inside
    the map, w >= 0) tightens plateau-style inflated maps. Host numpy at
    map-update rate; the leaves come back as tensors of the grid's dtype
    on its device."""
    grid = np.asarray(torch.as_tensor(omap.grid).cpu(), np.float64).copy()
    H, W = grid.shape
    res = float(omap.resolution)
    ox, oy = float(omap.origin[0]), float(omap.origin[1])
    wmul = float(omap.weight)
    cxs, cys, sigmas, ws = [], [], [], []
    for _ in range(n_blobs):
        iy, ix = np.unravel_index(np.argmax(grid), grid.shape)
        peak = grid[iy, ix]
        if peak < min_peak:
            cxs.append(0.0), cys.append(0.0), sigmas.append(1.0), ws.append(0.0)
            continue
        # sigma from the discrete log-curvature at the peak (clamped inside)
        i0x, i1x = max(ix - 1, 0), min(ix + 1, W - 1)
        i0y, i1y = max(iy - 1, 0), min(iy + 1, H - 1)
        eps = 1e-12
        cxx = (np.log(grid[iy, i1x] + eps) - 2.0 * np.log(peak + eps)
               + np.log(grid[iy, i0x] + eps)) / res**2
        cyy = (np.log(grid[i1y, ix] + eps) - 2.0 * np.log(peak + eps)
               + np.log(grid[i0y, ix] + eps)) / res**2
        curv = max(-0.5 * (cxx + cyy), 1.0 / (20.0 * res) ** 2)
        sigma = 1.0 / np.sqrt(curv)
        cx = ox + ix * res
        cy = oy + iy * res
        X = ox + np.arange(W) * res
        Y = oy + np.arange(H) * res
        XX, YY = np.meshgrid(X, Y)
        blob = peak * np.exp(-((XX - cx) ** 2 + (YY - cy) ** 2)
                             / (2.0 * sigma**2))
        grid = np.maximum(grid - blob, 0.0)
        cxs.append(cx), cys.append(cy), sigmas.append(sigma)
        ws.append(peak * wmul)
    g = torch.as_tensor(omap.grid)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=g.dtype, device=g.device)

    blobs = GaussianObstacles.from_sigmas(t(cxs), t(cys), t(sigmas), t(ws))
    if not refine:
        return blobs
    return _refine_blobs_lsq(omap, blobs)


def _refine_blobs_lsq(omap: ObstacleMap,
                      blobs: GaussianObstacles) -> GaussianObstacles:
    """Joint bounded least-squares refinement of the K blobs against the
    whole grid (scipy trf): centres inside the map, log gamma in
    [log 1e-2, log 1e3] (1/m^2), amplitude in [0, 2 peak] grid units."""
    from scipy.optimize import least_squares

    g = torch.as_tensor(omap.grid)
    grid = np.asarray(g.cpu(), np.float64)
    H, W = grid.shape
    res = float(omap.resolution)
    ox, oy = float(omap.origin[0]), float(omap.origin[1])
    wmul = float(omap.weight)
    xf = (ox + np.arange(W) * res)[None, :].repeat(H, 0).ravel()
    yf = (oy + np.arange(H) * res)[:, None].repeat(W, 1).ravel()
    tgt = grid.ravel()
    peak = float(tgt.max())
    if peak <= 0.0 or wmul == 0.0:
        return blobs

    def host(a):
        return np.asarray(a.cpu(), float)

    cx, cy, g_ = host(blobs.cx), host(blobs.cy), host(blobs.gamma)
    w_ = host(blobs.w) / wmul
    K = len(cx)
    x_hi, y_hi = ox + (W - 1) * res, oy + (H - 1) * res
    p0 = np.concatenate([np.clip(cx, ox, x_hi), np.clip(cy, oy, y_hi),
                         np.log(np.clip(g_, 1e-2, 1e3)),
                         np.clip(w_, 0.0, 2.0 * peak)])
    lo = np.concatenate([np.full(K, ox), np.full(K, oy),
                         np.full(K, np.log(1e-2)), np.zeros(K)])
    hi = np.concatenate([np.full(K, x_hi), np.full(K, y_hi),
                         np.full(K, np.log(1e3)),
                         np.full(K, 2.0 * peak + 1e-9)])

    def resid(p):
        cxk, cyk, lg, wk = p[:K], p[K:2 * K], p[2 * K:3 * K], p[3 * K:]
        gam = np.exp(lg)
        f = np.zeros_like(tgt)
        for k in range(K):
            f += wk[k] * np.exp(-gam[k] * ((xf - cxk[k]) ** 2
                                           + (yf - cyk[k]) ** 2))
        return f - tgt

    r = least_squares(resid, p0, bounds=(lo, hi), max_nfev=120,
                      method="trf")
    p = r.x

    def t(a):
        return torch.as_tensor(a, dtype=g.dtype, device=g.device)

    return GaussianObstacles(cx=t(p[:K]), cy=t(p[K:2 * K]),
                             gamma=t(np.exp(p[2 * K:3 * K])),
                             w=t(p[3 * K:] * wmul))


def fit_gaussians_to_maps(omaps: ObstacleMap, n_blobs: int = 4,
                          min_peak: float = 1e-3) -> GaussianObstacles:
    """The batched greedy fit on the maps' device: (B, H, W) costmaps ->
    (B, K) blobs, the host greedy fit (`fit_gaussians_to_map`,
    refine=False) for every map at once. K peels over the (B, H, W)
    residual grids: one `argmax` per map over the flattened H*W cells (the
    first maximum, in that order), (B,)-sized gathers of the peak and its
    4 neighbours (clamped inside), sigma from the log-curvature, the blob
    subtracted and the residual clamped at 0. Dead peaks (< min_peak) give
    zero blobs with gamma 0.5. Leaves of `omaps`: grid (B, H, W), origin
    (B, 2), resolution (B,), weight (B,)."""
    grids = omaps.grid
    B, H, W = grids.shape
    dtype, dev = grids.dtype, grids.device
    eps = 1e-12
    res = omaps.resolution
    ox, oy = omaps.origin[:, 0], omaps.origin[:, 1]
    wmul = omaps.weight
    ixs = torch.arange(W, dtype=dtype, device=dev) * res[:, None] + ox[:, None]
    iys = torch.arange(H, dtype=dtype, device=dev) * res[:, None] + oy[:, None]
    rows = torch.arange(B, device=dev)
    g = grids.reshape(B, H * W)
    cxs, cys, gams, ws = [], [], [], []
    for _ in range(n_blobs):
        idx = torch.argmax(g, dim=1)
        iy = idx // W
        ix = idx % W
        peak = g[rows, idx]
        # sigma from the discrete log-curvature at the peak, the neighbour
        # indices clamped inside the map (as the host fit)
        gl = g[rows, iy * W + torch.clamp_min(ix - 1, 0)]
        gr = g[rows, iy * W + torch.clamp_max(ix + 1, W - 1)]
        gd = g[rows, torch.clamp_min(iy - 1, 0) * W + ix]
        gu = g[rows, torch.clamp_max(iy + 1, H - 1) * W + ix]
        lp = torch.log(peak + eps)
        cxx = (torch.log(gr + eps) - 2.0 * lp + torch.log(gl + eps)) / res**2
        cyy = (torch.log(gu + eps) - 2.0 * lp + torch.log(gd + eps)) / res**2
        curv = torch.maximum(-0.5 * (cxx + cyy), 1.0 / (20.0 * res) ** 2)
        inv2sig2 = 0.5 * curv            # 1 / (2 sigma^2)
        cx = ox + ix.to(dtype) * res
        cy = oy + iy.to(dtype) * res
        blob = peak[:, None, None] * torch.exp(
            -((ixs[:, None, :] - cx[:, None, None]) ** 2
              + (iys[:, :, None] - cy[:, None, None]) ** 2)
            * inv2sig2[:, None, None])
        live = (peak >= min_peak).to(dtype)
        g = torch.clamp_min(g.reshape(B, H, W) - live[:, None, None] * blob,
                            0.0).reshape(B, H * W)
        cxs.append(live * cx)
        cys.append(live * cy)
        gams.append(torch.where(live > 0, inv2sig2,
                                torch.full_like(inv2sig2, 0.5)))
        ws.append(live * peak * wmul)
    return GaussianObstacles(cx=torch.stack(cxs, 1), cy=torch.stack(cys, 1),
                             gamma=torch.stack(gams, 1),
                             w=torch.stack(ws, 1))


def gaussian_blob_map(center, sigma: float = 0.4, extent: float = 4.0,
                      cells: int = 64, weight: float = 50.0,
                      dtype=torch.float32, sampling: str = "bilinear",
                      device=None) -> ObstacleMap:
    """Synthetic costmap of one Gaussian blob at `center` (benchmarks and
    tests). `center` = (cx, cy), each a number or a (B,) tensor: the
    latter gives a batch of B maps (grid (B, H, W), origin (B, 2),
    resolution and weight (B,)), one blob each. sampling="spline_coeff"
    builds a spline map with its coefficient planes attached. The cell
    centres are `torch.linspace`, which may part from XLA's compiled
    `jnp.linspace` by one float32 ulp."""
    coeffs = sampling == "spline_coeff"
    if coeffs:
        sampling = "spline"
    xs = linspace(-extent / 2, extent / 2, cells, dtype=dtype,
                  device=device)
    Y, X = torch.meshgrid(xs, xs, indexing="ij")
    cx, cy = (torch.as_tensor(c, dtype=dtype, device=xs.device)
              for c in center)
    lead = cx.shape
    if cx.dim():
        cx, cy = cx[:, None, None], cy[:, None, None]
    g = torch.exp(-((X - cx) ** 2 + (Y - cy) ** 2) / (2.0 * sigma**2))

    def t(x, shape=()):
        return torch.as_tensor(x, dtype=dtype, device=xs.device).expand(
            lead + shape).clone()

    m = ObstacleMap(grid=g, origin=t([-extent / 2, -extent / 2], (2,)),
                    resolution=t(extent / (cells - 1)), weight=t(weight),
                    sampling=sampling)
    return m.with_spline_coeffs() if coeffs else m
