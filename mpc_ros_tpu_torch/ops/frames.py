"""2-D frame transforms and angle utilities (counterpart of
`mpc_ros_tpu/ops/frames.py`): the world -> robot rotation of the reference
planner's path transform and a branchless angle wrap, elementwise over
tensors of any shape."""

from __future__ import annotations

import math

import torch


def world_to_robot(xs: torch.Tensor, ys: torch.Tensor, px, py, theta):
    """World points in the robot frame at pose (px, py, theta):
    x_veh = dx cos(theta) + dy sin(theta), y_veh = dy cos(theta) -
    dx sin(theta)."""
    theta = torch.as_tensor(theta, dtype=xs.dtype, device=xs.device)
    c = torch.cos(theta)
    s = torch.sin(theta)
    dx = xs - px
    dy = ys - py
    return dx * c + dy * s, dy * c - dx * s


def robot_to_world(xr: torch.Tensor, yr: torch.Tensor, px, py, theta):
    """Inverse of `world_to_robot`."""
    theta = torch.as_tensor(theta, dtype=xr.dtype, device=xr.device)
    c = torch.cos(theta)
    s = torch.sin(theta)
    return px + xr * c - yr * s, py + xr * s + yr * c


def _tensor(x) -> torch.Tensor:
    """x as it is if a tensor, else as a float64 tensor."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(
        x, dtype=torch.float64)


def normalize_angle(angle, amin=-math.pi, amax=math.pi) -> torch.Tensor:
    """Wrap `angle` into [amin, amax), branchless (a Python float is
    wrapped in float64)."""
    angle = _tensor(angle)
    span = amax - amin
    return angle - span * torch.floor((angle - amin) / span)


def angle_diff(a, b) -> torch.Tensor:
    """Shortest signed angular difference a - b, wrapped to [-pi, pi)."""
    return normalize_angle(_tensor(a) - _tensor(b))
