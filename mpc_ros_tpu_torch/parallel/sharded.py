"""Sharded scenario sweeps, fleet solves, horizon solves and serving
(counterpart of `mpc_ros_tpu/parallel/sharded.py`).

The JAX module runs each function under `shard_map` over the mesh's data
axis. Here each data shard is a contiguous row block of the batch, moved
to its shard's device and solved there by the same batch-first function
the unsharded call runs (on its own CUDA stream, `Mesh.on`); results are
concatenated back in shard order. The design rule carries over: the
per-cycle control path never communicates across shards; only the sweep
statistics are reduced, `psum` as a sum of the per-shard partials in
shard order and `pmax` as a max, and across processes as
`torch.distributed.all_reduce` SUM and MAX over the mesh's group.

The time axis (`time_sharded_riccati`, `sharded_horizon_solve`) splits the
horizon of the associative-scan Riccati into n_time contiguous blocks on
a grid row's devices: each block reverse-scans locally, the block totals
pass from the later blocks to the earlier ones, and each block combines
its incoming suffix into its own values.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import MPCParams, SolverConfig
from ..solver import ilqr, riccati
from ..solver.types import SolveResult
from .mesh import Mesh, Partition, batch_sharding


@dataclasses.dataclass
class SweepStats:
    """Globally reduced sweep statistics (one value per sweep)."""

    mean_cost: torch.Tensor
    max_cost: torch.Tensor
    converged_frac: torch.Tensor
    mean_iters: torch.Tensor
    mean_abs_omega0: torch.Tensor
    mean_abs_accel0: torch.Tensor


# ------------------------------------------------------------------ helpers


def _rows(B: int, n: int) -> list:
    if B % n:
        raise ValueError(f"batch {B} not divisible by data axis {n}")
    k = B // n
    return [(i * k, (i + 1) * k) for i in range(n)]


def split_rows(where, x, B: int):
    """x per data shard, on the shard's device. `where` is a Mesh or a
    `Partition` of one (`batch_sharding`, `replicated`): split over the
    data axis, a tensor whose leading axis is the batch B is sliced and
    anything else (scalars, shared tensors, None) is replicated; under
    `replicated` every shard gets the whole of x. Dataclasses (MPCParams,
    GaussianObstacles) and dicts are split leaf by leaf."""
    part = where if isinstance(where, Partition) else batch_sharding(where)
    devs = part.mesh.data_devices()
    spans = _rows(B, len(devs))
    split = part.axis is not None

    def one(v, i):
        if isinstance(v, torch.Tensor):
            if split and v.dim() >= 1 and v.shape[0] == B:
                v = v[spans[i][0]:spans[i][1]]
            return v.to(devs[i], non_blocking=True)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return dataclasses.replace(v, **{
                f.name: one(getattr(v, f.name), i)
                for f in dataclasses.fields(v)})
        if isinstance(v, dict):
            return {k: one(a, i) for k, a in v.items()}
        return v

    return [one(x, i) for i in range(len(devs))]


def gather_rows(parts: list, dim: int = 0, device=None):
    """Concatenate per-shard results (tensors, or dataclasses of tensors)
    along `dim` on `device` (default: the first part's)."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        dev = first.device if device is None else device
        return torch.cat([p.to(dev, non_blocking=True) for p in parts],
                         dim=dim)
    return type(first)(**{
        f.name: gather_rows([getattr(p, f.name) for p in parts], dim, device)
        for f in dataclasses.fields(first)})


def _per_shard(mesh: Mesh, fn, *shard_args):
    """fn(i, *args_i) for every data shard i on its own stream."""
    out = []
    for i, args in enumerate(zip(*shard_args)):
        with mesh.on(i):
            out.append(fn(i, *args))
    return out


def time_sharded_scan(mesh: Mesh, i: int):
    """The reverse associative scan of `riccati` with the time axis split
    over grid row i's devices (the row's first device when n_time = 1)."""
    devs = mesh.devices[i]
    if len(devs) == 1:
        return riccati.reverse_scan

    def scan(elems):
        d = elems.A.dim() - 3
        home = elems.A.device
        n = len(devs)
        blocks = [riccati.LQRElement(*(x.to(devs[j], non_blocking=True)
                                       for x in blk))
                  for j, blk in enumerate(zip(*(torch.tensor_split(x, n, d)
                                                for x in elems)))]
        local = []
        for j, blk in enumerate(blocks):
            with mesh.on(i, j):
                local.append(riccati.reverse_scan(blk))
        # the block totals (each block's first suffix) pass from the later
        # blocks to the earlier ones
        suffix = [None] * n
        for j in range(n - 2, -1, -1):
            tot = riccati.LQRElement(*(x.narrow(d, 0, 1).to(devs[j])
                                       for x in local[j + 1]))
            suffix[j] = tot if suffix[j + 1] is None else riccati.combine(
                riccati.LQRElement(*(x.to(devs[j]) for x in suffix[j + 1])),
                tot)
        out = []
        for j in range(n):
            if suffix[j] is None:
                out.append(local[j])
                continue
            with mesh.on(i, j):
                out.append(riccati.combine(suffix[j], local[j]))
        return riccati.LQRElement(*(
            torch.cat([o[k].to(home, non_blocking=True) for o in out], dim=d)
            for k in range(5)))

    return scan


# ------------------------------------------------------------------- sweeps


def _reduce(mesh: Mesh, partials: list, op: str) -> torch.Tensor:
    """Per-shard partial tensors reduced in shard order (a sum, or a max),
    then across the mesh's process group."""
    dev = partials[0].device
    acc = partials[0]
    for p in partials[1:]:
        p = p.to(dev)
        acc = acc + p if op == "sum" else torch.maximum(acc, p)
    if mesh.group is not None:
        acc = acc.clone()
        rop = (torch.distributed.ReduceOp.SUM if op == "sum"
               else torch.distributed.ReduceOp.MAX)
        torch.distributed.all_reduce(acc, op=rop, group=mesh.group)
    return acc


def _sweep_stats(mesh: Mesh, results: list, dtype) -> SweepStats:
    def part(r):
        return torch.stack([
            torch.tensor(r.cost.shape[0], dtype=dtype, device=r.cost.device),
            torch.sum(r.cost), torch.sum(r.converged.to(dtype)),
            torch.sum(r.n_iters.to(dtype)),
            torch.sum(torch.abs(r.us[:, 0, 0])),
            torch.sum(torch.abs(r.us[:, 0, 1]))])

    s = _reduce(mesh, [part(r) for r in results], "sum")
    mx = _reduce(mesh, [torch.max(r.cost) for r in results], "max")
    n = s[0]
    return SweepStats(mean_cost=s[1] / n, max_cost=mx,
                      converged_frac=s[2] / n, mean_iters=s[3] / n,
                      mean_abs_omega0=s[4] / n, mean_abs_accel0=s[5] / n)


def sharded_sweep(mesh: Mesh, z0s: torch.Tensor, coeffs: torch.Tensor,
                  p: MPCParams, cfg: SolverConfig):
    """Solve a scenario batch split over the mesh's data axis, each shard
    by the batch-first `ilqr.solve` (the counterpart of `jax.vmap` of the
    single-scenario solve). The per-scenario results stay per shard, on
    their devices: returns (a list of per-shard SolveResults in shard
    order, the reduced SweepStats). In a multi-process run z0s and coeffs
    are this process's scenarios and the statistics cover every
    process's."""
    B = z0s.shape[0]
    res = _per_shard(
        mesh, lambda i, z, c, pp: ilqr.solve(z, c, pp, cfg),
        split_rows(mesh, z0s, B), split_rows(mesh, coeffs, B),
        split_rows(mesh, p, B))
    return res, _sweep_stats(mesh, res, z0s.dtype)


def time_sharded_riccati(mesh: Mesh, A, B, l_s, l_u, l_ss, l_uu, l_us, V_s,
                         V_ss):
    """Batched horizon-parallel Riccati (`riccati.parallel_gains`) with
    both axes sharded: the batch over `data`, the horizon over `time`.
    A, B, l_* (batch, T, ...); V_s, V_ss (batch, ...). Returns (ks, Ks,
    Ps, ps) gathered on the first data shard's device."""
    Bn = A.shape[0]
    args = [split_rows(mesh, x, Bn)
            for x in (A, B, l_s, l_u, l_ss, l_uu, l_us, V_s, V_ss)]
    out = _per_shard(
        mesh, lambda i, *a: riccati.parallel_gains(
            *a, scan=time_sharded_scan(mesh, i)), *args)
    return tuple(gather_rows([o[k] for o in out]) for k in range(4))


def sharded_batch_solve(mesh: Mesh, z0s: torch.Tensor, coeffs: torch.Tensor,
                        p: MPCParams, cfg: SolverConfig, u_init=None,
                        blobs=None) -> SolveResult:
    """`batch_solve_lane` split over the mesh's data axis: each shard
    solves B / n_data robots with the lane-major solver, one launch of the
    whole-solve kernel per shard on the card. MPCParams leaves shaped (B,),
    warm starts and blob leaves are sliced with the batch; scalars are
    replicated. No collectives on this control path. Requires B divisible
    by the data axis (and, for the kernel, B / n_data divisible by 128).
    Returns the result gathered on the first shard's device."""
    from ..solver.batch_lane import batch_solve_lane

    B = z0s.shape[0]
    res = _per_shard(
        mesh, lambda i, z, c, pp, u, bl: batch_solve_lane(
            z, c, pp, cfg, u_init=u, blobs=bl),
        split_rows(mesh, z0s, B), split_rows(mesh, coeffs, B),
        split_rows(mesh, p, B), split_rows(mesh, u_init, B),
        split_rows(mesh, blobs, B))
    return gather_rows(res)


def sharded_horizon_solve(mesh: Mesh, z0s, coeffs, p: MPCParams,
                          cfg: SolverConfig) -> SolveResult:
    """The batched NMPC solve with the batch split over `data` and the
    horizon-parallel backward's scan split over `time`; the linearization,
    the box QPs and the forward rollout run per data shard on the whole
    horizon (the rollout is sequential in T by nature). `cfg` is forced to
    `horizon_parallel=True`, so the solver profile resolves as the
    horizon-parallel backward's (GN, the 8-candidate line search).
    Returns the result gathered on the first shard's device."""
    cfg = dataclasses.replace(cfg, horizon_parallel=True)
    B = z0s.shape[0]
    res = _per_shard(
        mesh, lambda i, z, c, pp: ilqr.solve(
            z, c, pp, cfg, _scan=time_sharded_scan(mesh, i)),
        split_rows(mesh, z0s, B), split_rows(mesh, coeffs, B),
        split_rows(mesh, p, B))
    return gather_rows(res)


def sharded_receding_rollout(mesh: Mesh, z0s, coeffs, p: MPCParams,
                             cfg: SolverConfig, n_cycles: int = 20):
    """Fleet serving split over the data axis: each shard runs
    `engine.receding_horizon_rollout` for its B / n_data robots with its
    own warm-start bank, no communication between shards. Returns (the
    RecedingTrace gathered over robots, the mean final-cycle cost, the
    mean warm-started iterations), the two statistics reduced over every
    shard."""
    from ..engine.receding import receding_horizon_rollout

    B = z0s.shape[0]
    trs = _per_shard(
        mesh, lambda i, z, c, pp: receding_horizon_rollout(
            z, c, pp, cfg, n_cycles=n_cycles),
        split_rows(mesh, z0s, B), split_rows(mesh, coeffs, B),
        split_rows(mesh, p, B))
    dtype = z0s.dtype
    s = _reduce(mesh, [torch.stack([
        torch.tensor(tr.costs.shape[1], dtype=dtype, device=tr.costs.device),
        torch.sum(tr.costs[-1]),
        torch.sum(tr.iters[1:].to(dtype))]) for tr in trs], "sum")
    mean_cost = s[1] / s[0]
    warm_iters = s[2] / (s[0] * (n_cycles - 1))
    return gather_rows(trs, dim=1), mean_cost, warm_iters
