"""Built-in reference courses: infinity, epitrochoid, square (counterpart
of `mpc_ros_tpu/sim/shapes.py`, the same curves point for point). Each
generator returns (M, 3) waypoints (x, y, yaw), yaw the path tangent,
ready for `MPCPlanner.set_plan`."""

from __future__ import annotations

import numpy as np


def _with_tangent_yaw(xy: np.ndarray) -> np.ndarray:
    d = np.gradient(xy, axis=0)
    yaw = np.arctan2(d[:, 1], d[:, 0])
    return np.concatenate([xy, yaw[:, None]], axis=1)


def infinity(n_points: int = 600, scale: float = 3.0,
             gap: float = 0.05) -> np.ndarray:
    """Lemniscate of Gerono (a sin t, a sin t cos t), left open by `gap`
    (a fraction of the loop) so that start and goal are distinct, starting
    at the right lobe's apex."""
    t0 = np.pi / 2
    t = t0 + np.linspace(0.0, 2.0 * np.pi * (1.0 - gap), n_points)
    xy = np.stack([scale * np.sin(t), scale * np.sin(t) * np.cos(t)], axis=1)
    return _with_tangent_yaw(xy)


def epitrochoid(n_points: int = 900, R: float = 2.0, r: float = 0.667,
                d: float = 0.3, gap: float = 0.04) -> np.ndarray:
    """Curtate epitrochoid with R/r ~ 3 (minimum radius ~1 m), left open
    by `gap`."""
    t = np.linspace(0.0, 2.0 * np.pi * (1.0 - gap), n_points)
    k = (R + r) / r
    xy = np.stack(
        [(R + r) * np.cos(t) - d * np.cos(k * t),
         (R + r) * np.sin(t) - d * np.sin(k * t)], axis=1)
    return _with_tangent_yaw(xy)


def square(side: float = 4.0, n_per_side: int = 120,
           corner_radius: float = 0.5, gap_points: int = 12) -> np.ndarray:
    """Square course with filleted corners, left open by `gap_points`
    waypoints."""
    h = side / 2.0
    c = corner_radius
    pts = []
    # corner centres counter-clockwise from the bottom right
    centers = [(h - c, -h + c), (h - c, h - c), (-h + c, h - c),
               (-h + c, -h + c)]
    start_ang = [-np.pi / 2, 0.0, np.pi / 2, np.pi]
    n_arc = max(n_per_side // 6, 4)
    for i in range(4):
        cx, cy = centers[i]
        nx, ny = centers[(i + 1) % 4]
        a0 = start_ang[i]
        arc = np.linspace(a0, a0 + np.pi / 2, n_arc, endpoint=False)
        pts.extend([(cx + c * np.cos(a), cy + c * np.sin(a)) for a in arc])
        # the straight edge to the next corner
        ex = cx + c * np.cos(a0 + np.pi / 2)
        ey = cy + c * np.sin(a0 + np.pi / 2)
        sx = nx + c * np.cos(a0 + np.pi / 2)
        sy = ny + c * np.sin(a0 + np.pi / 2)
        seg = np.linspace(0.0, 1.0, n_per_side, endpoint=False)[1:]
        pts.extend([(ex + s * (sx - ex), ey + s * (sy - ey)) for s in seg])
    xy = np.asarray(pts)
    if gap_points > 0:
        xy = xy[:-gap_points]
    return _with_tangent_yaw(xy)


SHAPES = {
    "infinity": infinity,
    "epitrochoid": epitrochoid,
    "square": square,
}


def get_shape(name: str, **kwargs) -> np.ndarray:
    return SHAPES[name](**kwargs)
