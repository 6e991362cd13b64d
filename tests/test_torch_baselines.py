"""The baseline planners (`planner/baselines.py`: Pure Pursuit, DWA) and
the three-controller A/B harness (`sim/compare.py`) against the JAX
package, on the CPU.

Each baseline runs beside the JAX package's in lockstep on
`tests/test_baselines.py`'s cases: the same pose and feedback every cycle
(the JAX command drives the plant), the commands held to 1e-9 and the FSM
states equal. Pure Pursuit is float64 numpy on both sides; DWA evaluates
its window in float32 on both sides (the JAX evaluator's own dtype), so
equal commands mean the same candidate won. `sim.compare.run_one` is held
against the JAX `run_one` on a 60-cycle course for all three controllers
(the MPC planner in float64, the JAX tracker without its native C++ fit,
ROADMAP Queue 3 item 6).
"""

import numpy as np
import pytest
import torch

import mpc_ros_tpu.planner.tracking as jax_tracking
from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import PlannerConfig as JPlannerConfig
from mpc_ros_tpu.planner import DWAConfig as JDWAConfig
from mpc_ros_tpu.planner import DWAPlanner as JDWAPlanner
from mpc_ros_tpu.planner import PurePursuitPlanner as JPurePursuitPlanner
from mpc_ros_tpu.planner.baselines import _dwa_eval_jit
from mpc_ros_tpu.sim import get_shape
from mpc_ros_tpu.sim.compare import run_one as jax_run_one
from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.planner import (DWAConfig, DWAPlanner,
                                       PurePursuitPlanner)
from mpc_ros_tpu_torch.planner.baselines import _dwa_eval
from mpc_ros_tpu_torch.sim import make_plant
from mpc_ros_tpu_torch.sim.compare import run_one
from mpc_ros_tpu_torch.testing import torch_threads

LEAVES = dict(dt=0.1, ref_vel=0.5, max_angvel=1.5, w_cte=300.0,
              w_angvel_d=10.0, w_accel_d=10.0)
CMD_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once
    (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


def _pair(kind):
    """(port planner on the CPU, JAX planner) of one kind, tests/
    test_baselines.py's parameters."""
    ours_cls = PurePursuitPlanner if kind == "pure_pursuit" else DWAPlanner
    ref_cls = (JPurePursuitPlanner if kind == "pure_pursuit"
               else JDWAPlanner)
    ours = ours_cls(params=MPCParams(**LEAVES),
                    planner_cfg=PlannerConfig(local_plan_length=2.5),
                    device="cpu")
    ref = ref_cls(params=JMPCParams(**LEAVES),
                  planner_cfg=JPlannerConfig(local_plan_length=2.5))
    return ours, ref


def _lockstep(ours, ref, plan, max_cycles, start=None, fb=(0.0, 0.0),
              drive=None):
    """Both planners through the same cycles; returns (largest command
    difference, cycles, goal reached). `drive(pose, cmd)` moves the pose
    (default: the unicycle plant of `sim.run_closed_loop`)."""
    pose0 = np.asarray(plan[0] if start is None else start, float).copy()
    plant = make_plant("diff_drive", pose0, 0.1, ours.params)
    for pl in (ours, ref):
        pl.initialize()
        assert pl.set_plan(plan, plant.pose, plant.feedback_vel)
    worst, reached, n = 0.0, False, 0
    for n in range(1, max_cycles + 1):
        pose = plant.pose.copy()
        fbv = plant.feedback_vel if drive is None else fb
        g = [pl.is_goal_reached(pose, fbv) for pl in (ours, ref)]
        assert g[0] == g[1], n
        if g[1]:
            reached = True
            break
        ok_o, cmd_o, info_o = ours.compute_velocity_commands(pose, fbv)
        ok_r, cmd_r, info_r = ref.compute_velocity_commands(pose, fbv)
        assert ok_o == ok_r, n
        assert info_o.state.name == info_r.state.name, n
        worst = max(worst, float(np.max(np.abs(np.subtract(cmd_o, cmd_r)))))
        if drive is None:
            plant.step(*cmd_r)
        else:
            fb = drive(plant, cmd_r)
    return worst, n, reached


@pytest.mark.parametrize("kind", ["pure_pursuit", "dwa"])
@pytest.mark.parametrize("shape", ["infinity", "square"])
def test_baseline_matches_jax_over_the_course(kind, shape):
    """tests/test_baselines.py::test_baseline_tracks_course, cycle by
    cycle: the same commands to 1e-9 and FSM states to the goal."""
    ours, ref = _pair(kind)
    worst, n, reached = _lockstep(ours, ref, get_shape(shape), 1500)
    assert reached, (kind, shape, n)
    assert worst <= CMD_TOL, worst


def test_pure_pursuit_on_a_circle_matches_jax():
    """tests/test_baselines.py::test_pure_pursuit_curvature_geometry: the
    pose held, the speed ramp warming over 12 cycles."""
    R = 2.0
    th = np.linspace(0, np.pi, 200)
    plan = np.stack([R * np.sin(th), R * (1 - np.cos(th)), th], -1)
    ours, ref = _pair("pure_pursuit")
    for pl in (ours, ref):
        pl.initialize()
        assert pl.set_plan(plan, plan[0].copy(), (0.5, 0.0))
    vw = (0.0, 0.0)
    for _ in range(12):
        _, c_o, _ = ours.compute_velocity_commands(plan[0], vw)
        _, c_r, _ = ref.compute_velocity_commands(plan[0], vw)
        assert np.max(np.abs(np.subtract(c_o, c_r))) <= CMD_TOL
        vw = c_r
    assert abs(vw[1] / vw[0] - 1.0 / R) < 0.25 / R


def test_dwa_window_matches_jax():
    """tests/test_baselines.py::test_dwa_window_respects_limits: 40 cycles
    with the feedback the last command, the pose moved by it."""

    def drive(plant, cmd):
        v, w = cmd
        plant.pose[:] = [plant.pose[0] + v * np.cos(plant.pose[2]) * 0.1,
                         plant.pose[1] + v * np.sin(plant.pose[2]) * 0.1,
                         plant.pose[2] + w * 0.1]
        return (v, w)

    ours, ref = _pair("dwa")
    worst, n, _ = _lockstep(ours, ref, get_shape("infinity"), 40,
                            drive=drive)
    assert n == 40 and worst <= CMD_TOL, worst


@pytest.mark.parametrize("seed", range(6))
def test_dwa_window_evaluation_matches_jax(seed):
    """The window evaluator alone on random windows, plans and blob fields
    (tests/test_baselines.py::test_dwa_obstacle_clearance_steers_away's
    form): the same winner with and without blobs."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    cfg = DWAConfig()
    P = cfg.plan_points
    s = np.linspace(0, 2.5, P)
    pts = np.stack([s, rng.normal() * 0.3 * s ** 2], -1).astype(np.float32)
    lim = np.array([1.0, 3.0, 1.5, 0.5, 0.0], np.float32)
    v0, w0 = np.float32(rng.uniform(0, 0.5)), np.float32(rng.normal() * 0.5)
    K = 3
    bl = [rng.uniform(0.3, 1.5, K), rng.normal(size=K) * 0.3,
          rng.uniform(0.2, 0.4, K), rng.uniform(10.0, 60.0, K)]
    ours_b = GaussianObstacles.from_sigmas(*(
        torch.tensor(a, dtype=torch.float32) for a in bl))
    from mpc_ros_tpu.models.obstacles import GaussianObstacles as JBlobs

    ref_b = JBlobs.from_sigmas(*(jnp.asarray(a, jnp.float32) for a in bl))
    args_o = (torch.tensor(v0), torch.tensor(w0), torch.tensor(lim),
              torch.tensor(pts), torch.tensor(pts[-1]))
    args_r = (jnp.float32(v0), jnp.float32(w0), jnp.asarray(lim),
              jnp.asarray(pts), jnp.asarray(pts[-1]))
    jcfg = JDWAConfig()
    for blobs_o, blobs_r in ((None, None), (ours_b, ref_b)):
        vo, wo = _dwa_eval(cfg, *args_o, blobs=blobs_o)
        f = _dwa_eval_jit(jcfg, False, blobs_r is not None)
        kw = {} if blobs_r is None else {"blobs": blobs_r}
        vr, wr = f(*args_r, **kw)
        assert abs(float(vo) - float(vr)) <= CMD_TOL
        assert abs(float(wo) - float(wr)) <= CMD_TOL


@pytest.mark.parametrize("seed", range(3))
def test_dwa_grid_costmap_matches_jax(seed):
    """The window evaluator with a robot-frame grid costmap (float32,
    bilinear, as the JAX evaluator samples it), alone and beside blobs:
    the same winner as JAX's, and the map moves the winner away from the
    map-free one on at least one seed's window."""
    import jax.numpy as jnp

    from mpc_ros_tpu.models.obstacles import ObstacleMap as JMap
    from mpc_ros_tpu_torch.models.obstacles import ObstacleMap

    rng = np.random.default_rng(10 + seed)
    cfg = DWAConfig()
    P = cfg.plan_points
    s = np.linspace(0, 2.5, P)
    pts = np.stack([s, rng.normal() * 0.2 * s ** 2], -1).astype(np.float32)
    lim = np.array([1.0, 3.0, 1.5, 0.5, 0.0], np.float32)
    v0, w0 = np.float32(rng.uniform(0.1, 0.5)), np.float32(rng.normal() * 0.3)
    xs = np.linspace(-2.0, 2.0, 48)
    X, Y = np.meshgrid(xs, xs)
    c = (rng.uniform(0.3, 0.8), rng.normal() * 0.1)
    g = np.exp(-((X - c[0]) ** 2 + (Y - c[1]) ** 2) / 0.18).astype(
        np.float32)
    leaves = (g, np.float32([-2.0, -2.0]), np.float32(4.0 / 47),
              np.float32(50.0))
    ours_m = ObstacleMap(*(torch.tensor(a) for a in leaves))
    ref_m = JMap(*(jnp.asarray(a) for a in leaves))
    bl = [np.array([1.2]), np.array([0.4]), np.array([0.3]),
          np.array([40.0])]
    ours_b = GaussianObstacles.from_sigmas(*(
        torch.tensor(a, dtype=torch.float32) for a in bl))
    from mpc_ros_tpu.models.obstacles import GaussianObstacles as JBlobs

    ref_b = JBlobs.from_sigmas(*(jnp.asarray(a, jnp.float32) for a in bl))
    args_o = (torch.tensor(v0), torch.tensor(w0), torch.tensor(lim),
              torch.tensor(pts), torch.tensor(pts[-1]))
    args_r = (jnp.float32(v0), jnp.float32(w0), jnp.asarray(lim),
              jnp.asarray(pts), jnp.asarray(pts[-1]))
    jcfg = JDWAConfig()
    for blobs_o, blobs_r in ((None, None), (ours_b, ref_b)):
        vo, wo = _dwa_eval(cfg, *args_o, omap=ours_m, blobs=blobs_o)
        f = _dwa_eval_jit(jcfg, True, blobs_r is not None)
        kw = {"omap": ref_m}
        if blobs_r is not None:
            kw["blobs"] = blobs_r
        vr, wr = f(*args_r, **kw)
        assert abs(float(vo) - float(vr)) <= CMD_TOL
        assert abs(float(wo) - float(wr)) <= CMD_TOL


@pytest.fixture
def jax_numpy_fit(monkeypatch):
    """The JAX tracker and the port's with their numpy path fits (ROADMAP
    Queue 3 item 6)."""
    import mpc_ros_tpu_torch.planner.tracking as port_tracking

    for mod in (jax_tracking, port_tracking):
        init = mod.TrackingController.__init__

        def numpy_fit(self, *a, _init=init, **kw):
            _init(self, *a, **kw)
            self._native_prep = False

        monkeypatch.setattr(mod.TrackingController, "__init__", numpy_fit)


@pytest.mark.parametrize("kind", ["mpc", "pure_pursuit", "dwa"])
def test_compare_run_one_matches_jax(kind, jax_numpy_fit, tmp_path):
    """The summary row of a 60-cycle infinity course: equal cycles, the
    course time and every error and speed column within 1e-6; the CSV in
    the reference schema."""
    kw = dict(n_steps=20, dt=0.1, ref_vel=0.5, max_cycles=60)
    log = str(tmp_path / f"{kind}.csv")
    ours = run_one(kind, "infinity", log_path=log, device="cpu",
                   dtype=torch.float64, **kw)
    ref = jax_run_one(kind, "infinity", **kw)
    assert ours["controller"] == ref["controller"] == kind
    assert ours["reached"] == ref["reached"]
    assert ours["cycles"] == ref["cycles"] == 60
    for k in ("course_time_s", "mean_abs_cte", "max_abs_cte",
              "geo_err_mean_m", "geo_err_max_m", "mean_speed", "max_speed"):
        assert abs(ours[k] - ref[k]) <= 1e-6, (k, ours[k], ref[k])
    with open(log) as f:
        assert f.readline().strip() == \
            "idx,cte,etheta,cmd_vel.linear.x,cmd_vel.angular.z"


def test_sim_run_drives_the_baselines(capsys):
    """`python -m mpc_ros_tpu_torch.sim.run --controller pure_pursuit|dwa
    --cpu` runs (the raise that stood there is lifted)."""
    import json

    from mpc_ros_tpu_torch.sim.run import main

    for kind in ("pure_pursuit", "dwa"):
        main(["--controller", kind, "--cpu", "--max-cycles", "5"])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["controller"] == kind and out["cycles"] == 5
        assert out["device"] == "cpu"
