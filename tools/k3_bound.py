#!/usr/bin/env python3
"""The bound of K3, the compact schedule's host code around K1
(`kernels/solve_mega.py`: `compact_tail` and `_solve_compact`), from the
shapes it moves: the bytes of its argsort, gathers and scatters, each
input read once and each output written once, over the H100's HBM rate
(`kernels/roofline.py`'s DeviceSpec). The tail is `compact_n_tail(B, cfg)`
lanes whatever the data, so the count needs no run.

    python3 tools/k3_bound.py [--n-steps 48] [--batch 131072]

Prints one JSON line: the bytes per part, their sum, the bound in ms and
the K1 launches of one compact solve (pass 1 and the tail's pass 2).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from mpc_ros_tpu_torch.config import SolverConfig  # noqa: E402
from mpc_ros_tpu_torch.kernels import roofline  # noqa: E402
from mpc_ros_tpu_torch.kernels.pack import N_PAR  # noqa: E402
from mpc_ros_tpu_torch.kernels.solve_mega import (_M, _N,  # noqa: E402
                                                  compact_n_tail)

F32, IDX, KEY = 4, 8, 1      # bytes: a float32, an int64 index, a key


def k3_bytes(n_steps: int, B: int) -> dict:
    cfg = SolverConfig(n_steps=n_steps, max_sqp_iters=round(0.45 * n_steps),
                       tol_grad=1e-4)
    T = n_steps - 1
    tail = compact_n_tail(B, cfg)
    pair = cfg._long_horizon_pair(torch.float32, False)
    # argsort of the (B,) uint8 key: the keys read, the indices written
    argsort = B * KEY + B * IDX
    # the tail's inputs gathered with index_select (rows read and written
    # for the tail's lanes, the index read per call): zT, cT, params, lb,
    # ub, pass 1's controls and its done, conv, mu, gnorm; under the
    # long-horizon pair the params again for the weight-scaled mu reset
    rows = [6, cfg.n_coeffs, N_PAR, 2, 2, T * _M, 1, 1, 1, 1]
    if pair and cfg.scale_adaptive:
        rows.append(N_PAR)
    gather = sum(2 * tail * r * F32 + tail * IDX for r in rows)
    # pass 2's outputs scattered into pass 1's (index_copy / index_add
    # out of place: the full tensor and the tail read, the full tensor
    # written): ss, us, cost, conv, iterations, gnorm, mu, done
    out_rows = [(T + 1) * _N, T * _M, 1, 1, 1, 1, 1, 1]
    scatter = sum(2 * B * r * F32 + tail * r * F32 + tail * IDX
                  for r in out_rows)
    total = argsort + gather + scatter
    spec = roofline.DeviceSpec()
    return dict(n_steps=n_steps, batch=B, tail_lanes=tail,
                long_horizon_pair=pair, argsort_bytes=argsort,
                gather_bytes=gather, scatter_bytes=scatter,
                total_bytes=total, hbm_bytes_per_s=spec.hbm_bytes_per_s,
                bound_ms=total / spec.hbm_bytes_per_s * 1e3,
                k1_launches_per_solve=2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-steps", type=int, default=48)
    ap.add_argument("--batch", type=int, default=131072)
    a = ap.parse_args(argv)
    print(json.dumps(k3_bytes(a.n_steps, a.batch)))


if __name__ == "__main__":
    main()
