"""Plan pipeline: cutoff, downsampling, truncation and heading extraction
(counterpart of `mpc_ros_tpu/planner/plan_utils.py`, whose docstrings
give the reference behaviour and the quirk fixes). Host numpy at the
control rate, as in the JAX package; the solve is the only device work
of a cycle."""

from __future__ import annotations

import numpy as np


def cutoff_plan(plan: np.ndarray, robot_xy: np.ndarray) -> np.ndarray:
    """Drop the already-passed prefix: walk the waypoints while the
    distance to the robot decreases and keep the plan from the nearest one
    on (the nearest waypoint is kept, so the plan is never emptied, quirk
    Q12). plan: (M, >=2) waypoints (x, y[, yaw])."""
    if len(plan) == 0:
        return plan
    d2 = np.sum((plan[:, :2] - robot_xy[None, :2]) ** 2, axis=1)
    inc = d2[1:] > d2[:-1]
    k = int(np.argmax(inc)) if inc.any() else len(plan) - 1
    return plan[k:].copy()


def downsample_plan(plan: np.ndarray, segments: int = 10) -> np.ndarray:
    """Subsample the plan to ~`segments` spans, keeping the final waypoint;
    the sampling interval is path_length / segments / waypoint spacing,
    the path length computed from the plan (quirk Q6 fixed)."""
    if len(plan) <= 2:
        return plan.copy()
    seglens = np.hypot(np.diff(plan[:, 0]), np.diff(plan[:, 1]))
    path_length = float(np.sum(seglens))
    waypoints_dist = float(np.hypot(plan[1, 0] - plan[0, 0],
                                    plan[1, 1] - plan[0, 1]))
    if waypoints_dist <= 0.0:
        waypoints_dist = max(path_length / max(len(plan) - 1, 1), 1e-9)
    sampling = max(int(path_length / segments / waypoints_dist), 1)
    out = list(plan[::sampling])
    if not np.array_equal(out[-1], plan[-1]):
        out.append(plan[-1])
    return np.asarray(out)


def truncate_by_length(plan: np.ndarray, max_length: float) -> np.ndarray:
    """Clip the plan to `max_length` meters of cumulative arclength (the
    local window the cubic is fitted to), keeping at least two
    waypoints."""
    if len(plan) <= 1:
        return plan.copy()
    seg = np.hypot(np.diff(plan[:, 0]), np.diff(plan[:, 1]))
    arclen = np.concatenate([[0.0], np.cumsum(seg)])
    k = int(np.searchsorted(arclen, max_length, side="right"))
    return plan[: max(k, 2)].copy()


def path_heading(plan: np.ndarray) -> float:
    """Direction of the leading plan segment: the stored yaw (column 2)
    when there is one, else the first segment's tangent."""
    if plan.shape[1] >= 3:
        return float(plan[0, 2])
    if len(plan) >= 2:
        return float(np.arctan2(plan[1, 1] - plan[0, 1],
                                plan[1, 0] - plan[0, 0]))
    return 0.0


def lookahead_heading(plan: np.ndarray,
                      frac: float = 0.3) -> tuple[float, bool]:
    """Aggregate path direction over the first `frac` of the waypoints
    (the reference's 30% lookahead). Returns (atan2(gy, gx), valid), valid
    when both displacement sums are nonzero (the reference's `gx && gy`
    guard)."""
    n_sample = int(len(plan) * frac)
    gx = 0.0
    gy = 0.0
    for i in range(1, n_sample):
        gx += plan[i, 0] - plan[i - 1, 0]
        gy += plan[i, 1] - plan[i - 1, 1]
    valid = (gx != 0.0) and (gy != 0.0)
    return float(np.arctan2(gy, gx)), valid
