"""The comparison's controls: the plain reference put in the program's
place, computed in a precision below the configuration's.

The configurations state float32. K1 computes on the CUDA cores' float32
units and has no matrix product that TF32 could take, so the step below
that would tempt a later change is bfloat16: the reference's whole solve
in bfloat16. Each function returns a stand-in with the signature of the
program's entry that a driver calls, so that the rest of a run (the
window, the samples, the comparison) is the program's run unchanged.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from . import nlp


def batch_solve_lane(cfg: dict, dtype=torch.bfloat16):
    """A stand-in for `solver.batch_lane.batch_solve_lane`."""
    kn = nlp.Knobs.from_config(cfg)
    params = nlp.stated_params(cfg)

    def solve(z0s, coeffs, p, solver_cfg, u_init=None, **_):
        sol = nlp.solve(z0s.to(dtype), coeffs.to(dtype), params, kn,
                        u_init=None if u_init is None else u_init.to(dtype))
        return SimpleNamespace(us=sol.us.float(), cost=sol.cost.float(),
                               converged=sol.converged,
                               n_iters=sol.iters.to(torch.int32))
    return solve


def receding_horizon_rollout(cfg: dict, dtype=torch.bfloat16):
    """A stand-in for `engine.receding.receding_horizon_rollout`."""
    kn = nlp.Knobs.from_config(cfg)
    params = nlp.stated_params(cfg)

    def rollout(z0s, coeffs, p, solver_cfg, n_cycles=20, blobs=None):
        tr = nlp.receding(z0s.to(dtype), coeffs.to(dtype), params, kn,
                          n_cycles)
        return SimpleNamespace(zs=tr.zs.float(), us=tr.us.float(),
                               iters=tr.iters.to(torch.int32))
    return rollout


# the program's entries the stand-ins replace, by traffic entry
STAND_INS = {
    "batch_solve": ("mpc_ros_tpu_torch.solver.batch_lane",
                    "batch_solve_lane", batch_solve_lane),
    "rollout": ("mpc_ros_tpu_torch.engine.receding",
                "receding_horizon_rollout", receding_horizon_rollout),
}
