"""Tracking CSV logger in the reference benchmark's schema (counterpart of
`mpc_ros_tpu/sim/logger.py`, the same format):

    idx,cte,etheta,cmd_vel.linear.x,cmd_vel.angular.z
    1,0.0325774,0.036887,0,0
    ...
    tracking time,<sec>,<nanosec>
"""

from __future__ import annotations

import numpy as np

HEADER = "idx,cte,etheta,cmd_vel.linear.x,cmd_vel.angular.z"


def write_tracking_csv(path: str, records: np.ndarray,
                       course_time_s: float) -> None:
    sec = int(course_time_s)
    nsec = int(round((course_time_s - sec) * 1e9))
    with open(path, "w") as f:
        f.write(HEADER + "\n")
        for row in records:
            f.write(
                f"{int(row[0])},{row[1]:.6g},{row[2]:.6g},"
                f"{row[3]:.6g},{row[4]:.6g}\n"
            )
        f.write(f"tracking time,{sec},{nsec}\n")


def read_tracking_csv(path: str) -> tuple[np.ndarray, float]:
    """Parse a tracking CSV. Returns (records (n, 5), course_time_s); the
    course time is NaN without a footer."""
    rows = []
    course_time = float("nan")
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("idx"):
                continue
            parts = line.split(",")
            if parts[0] == "tracking time":
                course_time = float(parts[1]) + float(parts[2]) * 1e-9
                continue
            if len(parts) == 5:
                try:
                    rows.append([float(p) for p in parts])
                except ValueError:
                    continue
    return np.asarray(rows), course_time
