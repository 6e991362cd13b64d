#!/usr/bin/env python3
"""The pieces of one active-set sweep of the horizon-parallel backward on
the card, at the N=100 shape (B=16,384 lanes, T=99 stages, float32).

    python3 tools/riccati_sweep_probe.py

Times (host clock around synchronized calls, mean of 3 after one
warm-up) `riccati.make_elements`, `riccati.reverse_scan`, one `combine`
of two 50-stage halves, the batched 8x8 solve and inverse variants the
combine could use, one batched 8x8 product, and the stages' box QPs
(`boxqp.solve_boxqp_2d`); then prints a `torch.profiler` table of one
reverse scan. Random well-conditioned stage data from a fixed seed. Needs
a CUDA device.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from mpc_ros_tpu_torch.solver import riccati  # noqa: E402
from mpc_ros_tpu_torch.solver.boxqp import solve_boxqp_2d  # noqa: E402


def timed(name, fn, reps=3):
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    print(name, (time.perf_counter() - t) / reps * 1e3, "ms", flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("riccati_sweep_probe.py needs a CUDA device")
    dev = torch.device("cuda")
    torch.manual_seed(0)
    B, T, n = 16384, 99, 8

    def r(*s):
        return torch.randn(*s, device=dev)

    eye = torch.eye(n, device=dev)
    A = eye + 0.1 * r(B, T, n, n)
    Bm = 0.1 * r(B, T, n, 2)
    M = r(B, T, n, n) * 0.3
    lss = M @ M.transpose(-1, -2) + 0.5 * eye
    L = r(B, T, 2, 2) * 0.3
    luu = L @ L.transpose(-1, -2) + torch.eye(2, device=dev)
    lus, ls, lu = 0.2 * r(B, T, 2, n), r(B, T, n), r(B, T, 2)
    MT = r(B, n, n) * 0.3
    Vss, Vs = MT @ MT.transpose(-1, -2) + 0.5 * eye, r(B, n)
    el = timed("make_elements", lambda: riccati.make_elements(
        A, Bm, ls, lu, lss, luu, lus, Vs, Vss))
    timed("reverse_scan", lambda: riccati.reverse_scan(el))
    e1 = riccati.LQRElement(*(x[:, :50] for x in el))
    e2 = riccati.LQRElement(*(x[:, 50:] for x in el))
    timed("combine_50", lambda: riccati.combine(e2, e1))
    X = eye + 0.1 * r(B * 50, n, n)
    ident = eye.expand(X.shape)
    timed("linalg.solve", lambda: torch.linalg.solve(X, ident))
    timed("linalg.inv", lambda: torch.linalg.inv(X))
    timed("inv_ex", lambda: torch.linalg.inv_ex(X))
    timed("lu_factor_ex", lambda: torch.linalg.lu_factor_ex(X))
    timed("matmul", lambda: X @ X)
    Q = r(B, T, 2, 2)
    Q = Q @ Q.transpose(-1, -2) + torch.eye(2, device=dev)
    ones = torch.ones(B, T, 2, device=dev)
    timed("boxqp", lambda: solve_boxqp_2d(Q, r(B, T, 2), -ones, ones))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA,
                             ProfilerActivity.CPU]) as prof:
        riccati.reverse_scan(el)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15))


if __name__ == "__main__":
    main()
