"""A custom vehicle family with autodiff-only dynamics (counterpart of the
repository's `examples/custom_model.py`).

The reference's CppAD workflow writes the dynamics once and lets the
engine differentiate them. Here that is `models.model_from_step`: one step
function in torch ops, and the framework derives the Jacobians
(`torch.func.jacfwd`), builds the rate-cost augmentation and registers the
family with the solver stack (single solves, batches, the oracle, the
planner).

The "skid_drive" family is a differential drive whose commanded angular
velocity is attenuated by track slip growing with forward speed
(omega_eff = omega / (1 + k_slip v^2)). No Jacobian is written anywhere.

    python -m mpc_ros_tpu_torch.examples.custom_model [--cpu]
"""

import argparse

import numpy as np
import torch

from mpc_ros_tpu_torch import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import batch_solve, make_random_scenarios
from mpc_ros_tpu_torch.models import get_model, model_from_step
from mpc_ros_tpu_torch.ops.poly import polyeval
from mpc_ros_tpu_torch.planner.tracking import resolve_device
from mpc_ros_tpu_torch.solver import solve_jit

K_SLIP = 0.8  # track-slip coefficient [s^2/m^2]


def skid_step(z, u, coeffs, dt, sign, p):
    """One ZOH-Euler step; the 6-state error-state layout of diff_drive."""
    x, y, theta, v, cte, etheta = (z[..., i] for i in range(6))
    omega, accel = u[..., 0], u[..., 1]
    dt = torch.as_tensor(dt, dtype=z.dtype, device=z.device)
    omega_eff = omega / (1.0 + K_SLIP * v * v)   # slip attenuation
    f0 = polyeval(coeffs, x)
    return torch.stack([
        x + v * torch.cos(theta) * dt,
        y + v * torch.sin(theta) * dt,
        theta + omega_eff * dt,
        v + accel * dt,
        (f0 - y) + sign * v * torch.sin(etheta) * dt,
        etheta + omega_eff * dt,
    ], dim=-1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    # one call: Jacobians by jacfwd, the rate-cost augmentation, the
    # registration
    model_from_step("skid_drive", skid_step,
                    get_model("diff_drive").control_bounds,
                    allow_override=True)

    dtype = torch.float32
    p = MPCParams(ref_vel=0.5).astype(dtype, dev)
    cfg = SolverConfig(n_steps=30, model="skid_drive", backward="xla")

    # a single solve: the robot offset from a curved path
    f32 = dict(dtype=dtype, device=dev)
    coeffs = torch.tensor([0.05, -0.1, 0.2, -0.02], **f32)
    z0 = torch.tensor([0, 0, 0, 0.3, 0.05, float(np.arctan(-0.1))], **f32)
    res = solve_jit(z0, coeffs, p, cfg)
    omega, accel = res.us[0].tolist()
    print(f"skid_drive solve: omega={omega:.4f} rad/s accel={accel:.4f} "
          f"m/s^2 cost={float(res.cost):.3f} iters={int(res.n_iters)} "
          f"converged={bool(res.converged)}")

    # the slip correction matters: at v = 0.5 the effective turn rate is
    # omega / 1.2, so the solver commands a harder omega than diff_drive
    res_dd = solve_jit(z0, coeffs, p, SolverConfig(n_steps=30,
                                                   backward="xla"))
    w_dd = float(res_dd.us[0, 0])
    print(f"  vs diff_drive omega={w_dd:.4f} (skid commands "
          f"{abs(float(res.us[0, 0]) / w_dd):.2f}x)")

    # a batch: the custom family rides the same scale axis
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    z0s, cs = make_random_scenarios(gen, 256, dtype)
    bres = batch_solve(z0s, cs, p, cfg)
    conv = float(bres.converged.to(dtype).mean())
    print(f"batched 256 scenarios: converged={conv:.2%} "
          f"mean cost={float(bres.cost.mean()):.3f}")


if __name__ == "__main__":
    main()
