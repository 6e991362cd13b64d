"""Multi-process launch scaffolding and the scaling measurement
(counterpart of `mpc_ros_tpu/parallel/multihost.py`).

One program per process: each process builds its local scenario shard
(`host_local_scenarios`) and runs `sharded_sweep` on a mesh of its own
devices; the sweep statistics are reduced over the `torch.distributed`
group (NCCL between CUDA processes, gloo between CPU processes), and the
per-cycle control path never takes part. `init_multihost` is the only
piece that needs several processes; with one it is a no-op.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import MPCParams, SolverConfig
from ..engine.batch import make_random_scenarios
from .mesh import make_mesh
from .sharded import sharded_sweep


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device=None) -> dict:
    """Join a multi-process run (a no-op for one process): the
    `torch.distributed` process group at `tcp://<coordinator_address>`
    (host:port) with `num_processes` ranks, this one `process_id`; "nccl"
    when `device` is a CUDA device (the default, raising without a card),
    "gloo" on the CPU. Call once per process before any collective.

    Returns a topology summary {processes, process_index, local_devices,
    global_devices}."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to join a "
                           "gloo group on the CPU")
    dist = torch.distributed
    if num_processes is not None and num_processes > 1 and not (
            dist.is_initialized()):
        dist.init_process_group(
            backend="nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    return {
        "processes": n_proc,
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "local_devices": local,
        "global_devices": local * n_proc,
    }


def host_local_scenarios(seed: int, global_batch: int,
                         dtype=torch.float32, device=None, devices=None):
    """This process's shard of the global scenario batch, drawn from a
    generator seeded by (seed, rank) (the counterpart of
    `jax.random.fold_in(key, process_index)`), on `device` (default the
    card). Torch has no global array, so where the JAX function returns
    one array sharded over every process, this returns the local shard
    and the mesh of this process's devices (`devices`, default every
    visible card) that `sharded_sweep` reduces over the process group:
    (mesh, z0s_local, coeffs_local)."""
    dist = torch.distributed
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % n_proc:
        raise ValueError(
            f"global_batch={global_batch} must divide evenly over "
            f"{n_proc} processes (local shards must tile the global shape)")
    dev = torch.device("cuda" if device is None else device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(np.random.SeedSequence([seed, rank])
                        .generate_state(1, np.uint64)[0] >> 1))
    z0s, coeffs = make_random_scenarios(gen, global_batch // n_proc, dtype)
    mesh = make_mesh(devices=devices)
    return mesh, z0s, coeffs


def measure_scaling(n_devices_list, global_batch_per_device: int = 512,
                    n_steps: int = 30, dtype=torch.float32,
                    repeats: int = 3, devices=None) -> list:
    """Weak scaling: solves/s on meshes of increasing size at the same
    load per device. `devices` (default every visible card) are the
    devices to draw from; a mesh larger than that is skipped, as the JAX
    function skips one larger than `jax.devices()`."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices= to measure "
                               "on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    cfg = SolverConfig(n_steps=n_steps, max_sqp_iters=12,
                       tol_grad=1e-4 if dtype == torch.float32 else 1e-7)
    results = []
    base_rate = None
    for nd in n_devices_list:
        if nd > len(devices):
            continue
        mesh = make_mesh(n_data=nd, devices=devices[:nd])
        dev = mesh.data_devices()[0]
        p = MPCParams().astype(dtype, dev)
        batch = global_batch_per_device * nd
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        z0s, coeffs = make_random_scenarios(gen, batch, dtype)

        def sync(stats):
            return float(stats.mean_cost)

        res, stats = sharded_sweep(mesh, z0s, coeffs, p, cfg)
        sync(stats)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            res, stats = sharded_sweep(mesh, z0s, coeffs, p, cfg)
            sync(stats)
            times.append(time.perf_counter() - t0)
        rate = batch / min(times)
        if base_rate is None:
            base_rate = rate / nd
        results.append({
            "n_devices": nd,
            "batch": batch,
            "solves_per_s": round(rate, 1),
            "per_device": round(rate / nd, 1),
            "efficiency": round(rate / nd / base_rate, 3),
            "converged_frac": round(float(stats.converged_frac), 4),
        })
    return results
