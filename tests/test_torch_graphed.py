"""The captured solve (`solver/graphed.py`) on the CPU, where a
`CapturedSolve` calls its three bodies directly instead of replaying CUDA
graphs: the buffer protocol the card's graphs read.

* the hoisted constants: `ops.consts.const` builds a number with a fill
  and hands a tensor through; the box QP's tables are built once per
  (dtype, device);
* the planner's and the trajectory tracker's captured cycles against
  their eager cycles (`_graphed = False`), bit for bit over a run with a
  parameter reload, a costmap installed and replaced by one of the same
  shape, blobs appearing, and a reset (the in-place carry): the packed
  staging, the in-place carry and parameters, and one signature per set of
  optional inputs (a reload or a same-shape costmap adds none);
* the captured cycles against the JAX package's `_cycle_jit` and
  `_single_cycle_jit` in float64, cycle by cycle with the carries chained,
  a reload between cycles, at `tests/test_torch_tracking.py`'s tolerances;
* `solve_jit` against `solve` bit for bit (single and batched, warm
  starts, setpoint profiles, blobs, float and tensor parameters), its
  host reads equal, one signature per shape.

The card's side (the graphs themselves, replays under
`torch.cuda.set_sync_debug_mode("error")`) is in
`tests/test_torch_cuda.py` and `chip_smoke.py` phase 24.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.planner.tracking import _cycle_jit
from mpc_ros_tpu.planner.trajectory import _single_cycle_jit
from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.models.obstacles import (GaussianObstacles,
                                                gaussian_blob_map)
from mpc_ros_tpu_torch.ops.consts import const
from mpc_ros_tpu_torch.planner import (MPCPlanner, TimedTrajectory,
                                       TrajectoryTracker)
from mpc_ros_tpu_torch.planner import tracking, trajectory
from mpc_ros_tpu_torch.sim import get_shape
from mpc_ros_tpu_torch.solver import boxqp, graphed, ilqr
from mpc_ros_tpu_torch.testing import (lockstep_cycles, numpy_blobs,
                                       numpy_refs, numpy_scenarios,
                                       records_equal, torch_threads)

N = 12
LOOP = dict(dt=0.1, ref_vel=0.5, max_angvel=1.5, w_cte=300.0,
            w_angvel_d=10.0, w_accel_d=10.0)
RELOAD = dict(LOOP, w_cte=250.0, ref_vel=0.45)
# tests/test_torch_tracking.py's bars against the JAX controller
TOL_FIRST = 1e-8
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


def test_constants_cost_no_host_tensor():
    """A number becomes a fill of the same value as `torch.as_tensor`; a
    tensor passes through; the box QP's tables are one object per (dtype,
    device)."""
    for x in (0.1, 2.5, 1, True, np.float64(0.3)):
        for dtype in (torch.float32, torch.float64):
            a, b = const(x, dtype), torch.as_tensor(x, dtype=dtype)
            assert a.dtype == dtype and a.shape == () and torch.equal(a, b)
    t = torch.ones(3)
    assert const(t, torch.float32) is t
    assert (boxqp._tables(torch.float32, torch.device("cpu"))
            is boxqp._tables(torch.float32, torch.device("cpu")))


def _planner(graphed_cycle: bool, dtype):
    p = MPCPlanner(MPCParams(**LOOP), SolverConfig(n_steps=N),
                   PlannerConfig(local_plan_length=2.5), dtype=dtype,
                   device="cpu")
    p.initialize()
    p.tracker._graphed = graphed_cycle
    return p


def _costmaps(plan):
    """Two world costmaps of one shape: a blob beside the course's first
    metres, then the same blob moved by 0.1 m."""
    c = plan[25, :2]
    return [gaussian_blob_map((float(c[0]), float(c[1]) + d), sigma=0.3,
                              extent=8.0, weight=50.0) for d in (0.6, 0.5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_planner_captured_cycle_equals_eager(dtype):
    plan = get_shape("infinity")
    maps = _costmaps(plan)
    ours, eager = _planner(True, dtype), _planner(False, dtype)
    entries = {}

    def note(k):
        def f(pl):
            if pl is ours:
                entries[k] = len(pl.tracker._captured)
        return f

    events = {
        3: note(3),
        4: lambda pl: pl.reconfigure(MPCParams(**RELOAD)),
        6: note(6),
        7: lambda pl: pl.set_costmap(maps[0]),
        9: lambda pl: pl.set_costmap(maps[1]),
    }
    leaf = ours.tracker.params.w_cte
    a, b = lockstep_cycles([ours, eager], 11, plan=plan, events=events)
    rec = records_equal(a, b)
    assert rec["equal"], rec
    # the reload wrote the leaves in place: one signature before and after
    # it; the blobs of a costmap are a second, and a costmap of the same
    # shape no third
    assert ours.tracker.params.w_cte is leaf and float(leaf) == 250.0
    assert entries == {3: 1, 6: 1} and len(ours.tracker._captured) == 2
    assert all(r["solve"] is not None for r in a)
    # reset zeroes the carry in place; the next cycle is the cold one
    carry = ours.tracker._warm_dev
    for pl in (ours, eager):
        pl.tracker.reset()
    assert ours.tracker._warm_dev is carry and not bool(carry.any())
    a2, b2 = lockstep_cycles([ours, eager], 2, plan=plan[40:])
    assert records_equal(a2, b2)["equal"]


def test_reload_changes_the_captured_cycle_as_eager():
    """The reload reaches the captured solve: its cycles part from a
    planner without the reload exactly as the eager cycles do."""
    plan = get_shape("infinity")
    runs = []
    for g in (True, False):
        pls = [_planner(g, torch.float64) for _ in range(2)]
        runs.append(lockstep_cycles(pls, 4, plan=plan, events={
            2: lambda pl, first=pls[0]: (
                pl.reconfigure(MPCParams(**RELOAD)) if pl is first
                else None)}))
    (ga, gb), (ea, eb) = runs
    assert records_equal(ga, ea)["equal"] and records_equal(gb, eb)["equal"]
    assert not records_equal(ga, gb)["equal"]
    assert records_equal(ga[:2], gb[:2])["equal"]


def test_tracker_captured_cycle_equals_eager():
    traj = TimedTrajectory.from_path(get_shape("infinity"), 0.4)
    leaves = {k: v for k, v in LOOP.items() if k != "ref_vel"}
    trs = [TrajectoryTracker(MPCParams(**leaves), SolverConfig(n_steps=N),
                             PlannerConfig(local_plan_length=2.5),
                             dtype=torch.float64, device="cpu")
           for _ in range(2)]
    trs[1]._graphed = False
    xy = traj.xy[40]
    blobs = GaussianObstacles.from_sigmas([xy[0]], [xy[1] + 0.5], [0.3],
                                          [40.0])
    a, b = lockstep_cycles(trs, 8, traj=traj, events={
        4: lambda tr: tr.set_obstacles(blobs)})
    rec = records_equal(a, b)
    assert rec["equal"], rec
    # one signature without blobs, one with them
    assert len(trs[0]._captured) == 2


def _chain(ours_step, jax_step, inps, cycles, reload_at=None):
    """Run both cycles over the inputs with their carries chained; returns
    the worst relative difference of the packed results per cycle."""
    worst = []
    for k in range(cycles):
        if k == reload_at:
            ours_step.reload()
            jax_step.reload()
        a = ours_step(inps[k])
        b = jax_step(inps[k])
        worst.append(float(np.max(np.abs(a - b) / (1.0 + np.abs(b)))))
    return worst


class _Ours:
    """A cycle through `tracking.run_captured` on the CPU in float64."""

    def __init__(self, cfg, unpack, blobs=None):
        self.cfg, self.unpack, self.blobs = cfg, unpack, blobs
        self.entries = {}
        self.carry = torch.zeros((cfg.n_controls, 2), dtype=torch.float64)
        self.p = MPCParams(**LOOP).astype(torch.float64)

    def reload(self):
        new = MPCParams(**RELOAD).astype(torch.float64)
        for f in dataclasses.fields(new):
            getattr(self.p, f.name).copy_(getattr(new, f.name))

    def __call__(self, inp):
        return tracking.run_captured(self.entries, self.cfg, self.carry, inp,
                                     self.p, self.blobs, None, self.unpack)


class _Jax:
    def __init__(self, fn, cfg, blob_leaves=()):
        self.fn, self.blob_leaves = fn, blob_leaves
        self.carry = jnp.zeros((cfg.n_controls, 2), jnp.float64)
        self.p = JMPCParams(**LOOP).astype(jnp.float64)

    def reload(self):
        self.p = JMPCParams(**RELOAD).astype(jnp.float64)

    def __call__(self, inp):
        flat, self.carry = self.fn(jnp.asarray(inp), self.carry, self.p,
                                   *self.blob_leaves)
        return np.asarray(flat)


def _inputs(n_tail: int, cycles: int, seed: int):
    z0s, cs = numpy_scenarios(seed, cycles)
    tail = (np.full((cycles, 1), 0.5) if n_tail == 1
            else numpy_refs(seed, cycles, n_tail)[..., 2])
    return [np.concatenate([z0s[k], cs[k], tail[k]]) for k in range(cycles)]


def test_tracking_cycle_equals_jax_cycle_jit():
    cfg = SolverConfig(n_steps=N)
    ours = _Ours(cfg, tracking._unpack_tracking(cfg))
    ref = _Jax(_cycle_jit(JSolverConfig(n_steps=N), False, False), cfg)
    worst = _chain(ours, ref, _inputs(1, 4, 3), 4, reload_at=2)
    assert worst[0] <= TOL_FIRST and max(worst) <= TOL, worst
    assert len(ours.entries) == 1


def test_trajectory_cycle_equals_jax_single_cycle_jit():
    cfg = SolverConfig(n_steps=N)
    leaves = _blob_leaves(numpy_blobs(4, 1, 2))
    blobs = GaussianObstacles(*(torch.tensor(a[0]) for a in leaves))
    ours = _Ours(cfg, trajectory._unpack_trajectory(cfg), blobs)
    ref = _Jax(_single_cycle_jit(JSolverConfig(n_steps=N), True), cfg,
               tuple(jnp.asarray(a[0]) for a in leaves))
    worst = _chain(ours, ref, _inputs(N, 3, 5), 3, reload_at=1)
    assert worst[0] <= TOL_FIRST and max(worst) <= TOL, worst


def _blob_leaves(b):
    """`numpy_blobs`' (cx, cy, sigma, w) as the (cx, cy, gamma, w) leaves
    of `GaussianObstacles`."""
    cx, cy, sigma, w = b
    return cx, cy, 1.0 / (2.0 * sigma * sigma), w


def _results_equal(a, b):
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


@pytest.mark.parametrize("case", ["single", "batched"])
def test_solve_jit_equals_solve(case):
    z0s, cs = numpy_scenarios(7, 4)
    f32 = torch.float32
    cfg = SolverConfig(n_steps=N)
    if case == "single":
        args = (torch.tensor(z0s[0], dtype=f32), torch.tensor(cs[0],
                                                              dtype=f32))
        kw = dict(u_init=torch.full((N - 1, 2), 0.1, dtype=f32))
        params = [MPCParams(**LOOP), MPCParams(**RELOAD)]
    else:
        leaves = _blob_leaves(numpy_blobs(2, 4, 2))
        args = (torch.tensor(z0s, dtype=f32), torch.tensor(cs, dtype=f32))
        kw = dict(refs=torch.tensor(numpy_refs(2, 4, N), dtype=f32),
                  blobs=GaussianObstacles(*(torch.tensor(a, dtype=f32)
                                            for a in leaves)))
        params = [MPCParams(**LOOP).astype(f32),
                  MPCParams(**RELOAD).astype(f32)]
    before = len(graphed._JIT)
    for p in params:
        r0 = ilqr.host_reads
        ref = ilqr.solve(*args, p, cfg, **kw)
        reads = ilqr.host_reads - r0
        r0 = ilqr.host_reads
        res = ilqr.solve_jit(*args, p, cfg, **kw)
        assert ilqr.host_reads - r0 == reads
        assert _results_equal(res, ref)
    # one signature for both parameter sets; a new horizon is another
    assert len(graphed._JIT) == before + 1
    short = dataclasses.replace(cfg, n_steps=N - 2)
    kw = {k: (v[..., : N - 3, :] if k == "u_init" else
              v[..., : N - 2, :] if k == "refs" else v)
          for k, v in kw.items()}
    assert _results_equal(ilqr.solve_jit(*args, params[0], short, **kw),
                          ilqr.solve(*args, params[0], short, **kw))
    assert len(graphed._JIT) == before + 2


def test_update_params_writes_the_leaves_in_place():
    tr = tracking.TrackingController(MPCParams(**LOOP),
                                     SolverConfig(n_steps=N),
                                     PlannerConfig(), dtype=torch.float32,
                                     device="cpu")
    leaves = {f.name: getattr(tr.params, f.name)
              for f in dataclasses.fields(tr.params)}
    tr.update_params(MPCParams(**RELOAD))
    for f in dataclasses.fields(tr.params):
        assert getattr(tr.params, f.name) is leaves[f.name]
    assert float(tr.params.w_cte) == 250.0
    assert tr.ref_vel == float(torch.tensor(0.45, dtype=torch.float32))
    # a leaf whose shape changes is replaced (a new signature)
    tr.update_params(MPCParams(**dict(RELOAD, w_cte=torch.ones(3))))
    assert tr.params.w_cte is not leaves["w_cte"]
    assert tr.params.w_vel is leaves["w_vel"]
