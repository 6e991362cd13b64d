"""Packed per-lane parameter tile read by the solve kernel (counterpart of
`pack_params` and the `P_*` rows of
`mpc_ros_tpu/kernels/backward_fused_pallas.py`)."""

from __future__ import annotations

import torch

P_WCTE, P_WETH, P_WVEL, P_WANG, P_WACC, P_WDANG, P_WDACC = range(7)
P_RVEL, P_RCTE, P_RETH, P_DT, P_LF = range(7, 12)
N_PAR = 12


def pack_params(p, B: int, dtype, device=None) -> torch.Tensor:
    """Stack the MPCParams leaves the kernel needs into a contiguous
    (12, B) tensor; each leaf is a scalar or a (B,) per-lane value."""
    rows = [p.w_cte, p.w_etheta, p.w_vel, p.w_angvel, p.w_accel,
            p.w_angvel_d, p.w_accel_d, p.ref_vel, p.ref_cte, p.ref_etheta,
            p.dt, p.lf]
    return torch.stack([
        torch.as_tensor(r, dtype=dtype, device=device).expand(B)
        for r in rows])
