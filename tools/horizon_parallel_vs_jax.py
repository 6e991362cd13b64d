#!/usr/bin/env python3
"""The horizon-parallel solve against the sequential one, in the JAX
package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/horizon_parallel_vs_jax.py \
        [--batch 256] [--n-steps 100] [--dtype f32] [--cap 45]

Both packages solve the same numpy scenarios (`testing.numpy_scenarios`,
seed 5) with `SolverConfig(horizon_parallel=True)` and with the
sequential Gauss-Newton backward of the same profile (`ddp=False`), and
the script prints one JSON line: each pair held to
`verify.parity_gates` (JAX horizon-parallel vs JAX sequential, the port's
two, the port's horizon-parallel vs JAX's), and the port's active-set
sweeps per SQP iteration. It shows whether a disagreement between the
two backwards is the algorithm's (the JAX package's own pair disagrees
alike) or the port's. A CPU run: its seconds are not a device figure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n-steps", type=int, default=100)
    ap.add_argument("--dtype", choices=("f32", "f64"), default="f32")
    ap.add_argument("--cap", type=int, default=45)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    from mpc_ros_tpu.config import MPCParams as JMPCParams
    from mpc_ros_tpu.config import SolverConfig as JSolverConfig
    from mpc_ros_tpu.engine.batch import batch_solve as jbatch_solve
    from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
    from mpc_ros_tpu_torch.solver import ilqr, riccati
    from mpc_ros_tpu_torch.testing import numpy_scenarios
    from mpc_ros_tpu_torch.verify import parity_gates

    jd = jnp.float32 if args.dtype == "f32" else jnp.float64
    td = torch.float32 if args.dtype == "f32" else torch.float64
    z0, c = numpy_scenarios(5, args.batch)
    kw = dict(n_steps=args.n_steps, max_sqp_iters=args.cap, tol_grad=1e-4)
    cfgs = {"horizon": dict(kw, horizon_parallel=True),
            "sequential": dict(kw, ddp=False)}
    out = {"batch": args.batch, "n_steps": args.n_steps,
           "dtype": args.dtype, "cap": args.cap, "seconds": {}}
    res = {}
    for name, ckw in cfgs.items():
        t0 = time.perf_counter()
        r = jbatch_solve(jnp.asarray(z0, jd), jnp.asarray(c, jd),
                         JMPCParams().astype(jd), JSolverConfig(**ckw))
        jax.block_until_ready(r.us)
        out["seconds"][f"jax_{name}"] = time.perf_counter() - t0
        res[f"jax_{name}"] = r
        sweeps, reads = riccati.sweeps, ilqr.host_reads
        t0 = time.perf_counter()
        r = ilqr.solve(torch.tensor(z0, dtype=td), torch.tensor(c, dtype=td),
                       MPCParams().astype(td), SolverConfig(**ckw))
        out["seconds"][f"port_{name}"] = time.perf_counter() - t0
        res[f"port_{name}"] = r
        if name == "horizon":
            out["port_sweeps_per_iteration"] = (
                (riccati.sweeps - sweeps) / max(ilqr.host_reads - reads, 1))

    def gates(a, b):
        g = parity_gates(*(np.asarray(x) for x in (
            a.us, a.cost, a.converged, a.n_iters, b.us, b.cost, b.converged,
            b.n_iters)), args.n_steps)
        return {k: g[k] for k in ("max_du", "max_rel_dcost",
                                  "conv_match_frac", "iters_match_frac",
                                  "flip_or_oneside_frac", "mean_iters",
                                  "ok")}

    out["jax_horizon_vs_jax_sequential"] = gates(res["jax_horizon"],
                                                 res["jax_sequential"])
    out["port_horizon_vs_port_sequential"] = gates(res["port_horizon"],
                                                   res["port_sequential"])
    out["port_horizon_vs_jax_horizon"] = gates(res["port_horizon"],
                                               res["jax_horizon"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
