"""Monte-Carlo weight tuning: evaluate candidate cost weights in one batch
(counterpart of the repository's `examples/weight_tuning.py`).

    python -m mpc_ros_tpu_torch.examples.weight_tuning --candidates 8 \
        --scenarios 512 [--cpu]
"""

import argparse

import torch

from mpc_ros_tpu_torch import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine.sweep import (sample_weight_candidates,
                                            tuning_sweep)
from mpc_ros_tpu_torch.planner.tracking import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--candidates", type=int, default=8)
    ap.add_argument("--scenarios", type=int, default=512)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    dtype = torch.float32
    g0 = torch.Generator(device=dev)
    g0.manual_seed(0)
    g1 = torch.Generator(device=dev)
    g1.manual_seed(1)
    cands = sample_weight_candidates(g0, args.candidates, MPCParams(),
                                     dtype=dtype)
    res = tuning_sweep(g1, cands, args.scenarios,
                       SolverConfig(n_steps=30, max_sqp_iters=12,
                                    tol_grad=1e-4), dtype=dtype)
    best = res.best_params()
    i = int(res.best_index)
    print(f"evaluated {args.candidates} x {args.scenarios} solves; "
          f"best candidate #{i}: "
          f"w_cte={float(best.w_cte):.1f} w_etheta={float(best.w_etheta):.1f} "
          f"mean terminal |cte|={float(res.mean_terminal_cte[i]):.4f}")


if __name__ == "__main__":
    main()
