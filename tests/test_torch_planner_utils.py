"""The port's planner-side helpers against the JAX package on the same
numpy inputs, in float64: `PlannerConfig` / `PlannerLimits` (field names
and defaults), `per_lane_leaf_names`, `ops.poly.vandermonde` / `polyfit`,
`ops.frames`, `planner.plan_utils`, `planner.fsm`, the built-in courses
(`sim.shapes`) and `obs.metrics` — to 1e-12, or exactly for integer, state
and host-numpy results — on seeded inputs and on the cases of
tests/test_planner.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu import config as jconfig
from mpc_ros_tpu.obs import metrics as jmetrics
from mpc_ros_tpu.ops import frames as jframes
from mpc_ros_tpu.ops import poly as jpoly
from mpc_ros_tpu.planner import fsm as jfsm
from mpc_ros_tpu.planner import plan_utils as jplan
from mpc_ros_tpu.sim import shapes as jshapes
from mpc_ros_tpu_torch import config
from mpc_ros_tpu_torch.obs import metrics
from mpc_ros_tpu_torch.ops import frames, poly
from mpc_ros_tpu_torch.planner import fsm, plan_utils
from mpc_ros_tpu_torch.sim import shapes
from mpc_ros_tpu_torch.testing import torch_threads

TOL = 1e-12
F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


# -- config -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["PlannerConfig", "PlannerLimits"])
def test_planner_config_fields_and_defaults_equal_jax(name):
    ours, ref = getattr(config, name)(), getattr(jconfig, name)()
    names = [f.name for f in dataclasses.fields(ours)]
    assert names == [f.name for f in dataclasses.fields(ref)]
    for f in names:
        a, b = getattr(ours, f), getattr(ref, f)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b and type(a) is type(b), f


def test_per_lane_leaf_names_equal_jax():
    rng = np.random.default_rng(0)
    leaves = {"w_cte": rng.uniform(50, 300, 8), "dt": 0.1,
              "ref_vel": rng.uniform(0.2, 0.8, 8), "lf": np.float64(0.4)}
    ours = config.MPCParams.from_numpy(leaves)
    ref = jconfig.MPCParams(**{k: jnp.asarray(v) for k, v in leaves.items()})
    assert config.per_lane_leaf_names(ours) == jconfig.per_lane_leaf_names(
        ref) == ("ref_vel", "w_cte")
    assert config.per_lane_leaf_names(config.MPCParams()) == ()


# -- ops ----------------------------------------------------------------------

@pytest.mark.parametrize("order", [0, 1, 3, 5])
def test_vandermonde_equals_jax(order):
    x = np.random.default_rng(order).normal(size=(4, 9))
    _close(poly.vandermonde(torch.tensor(x), order),
           jpoly.vandermonde(jnp.asarray(x), order))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["plain", "weighted"])
def test_polyfit_equals_jax(order, weighted):
    rng = np.random.default_rng(10 + order)
    x = np.sort(rng.uniform(0.0, 3.0, size=(6, 12)), axis=-1)
    y = rng.normal(size=(6, 12))
    w = ((rng.uniform(size=(6, 12)) > 0.2).astype(float) if weighted
         else None)
    ours = poly.polyfit(torch.tensor(x), torch.tensor(y), order,
                        None if w is None else torch.tensor(w))
    ref = jpoly.polyfit(jnp.asarray(x), jnp.asarray(y), order,
                        None if w is None else jnp.asarray(w))
    _close(ours, ref, 1e-10)


def test_frames_equal_jax():
    rng = np.random.default_rng(4)
    xs, ys = rng.normal(size=(2, 50)) * 3.0
    px, py, th = 0.7, -1.2, 2.9
    a = frames.world_to_robot(torch.tensor(xs), torch.tensor(ys), px, py, th)
    b = jframes.world_to_robot(jnp.asarray(xs), jnp.asarray(ys), px, py, th)
    for u, v in zip(a, b):
        _close(u, v)
    back = frames.robot_to_world(*a, px, py, th)
    jback = jframes.robot_to_world(*b, px, py, th)
    for u, v, w in zip(back, jback, (xs, ys)):
        _close(u, v)
        _close(u, w, 1e-12)


@pytest.mark.parametrize("span", [(-np.pi, np.pi), (0.0, 2.0 * np.pi)],
                         ids=["pm_pi", "zero_2pi"])
def test_angle_wraps_equal_jax(span):
    ang = np.concatenate([np.random.default_rng(5).uniform(-20, 20, 200),
                          [-np.pi, np.pi, 0.0, 3 * np.pi, -7 * np.pi]])
    _close(frames.normalize_angle(torch.tensor(ang), *span),
           jframes.normalize_angle(jnp.asarray(ang), *span))
    b = ang[::-1].copy()
    _close(frames.angle_diff(torch.tensor(ang), torch.tensor(b)),
           jframes.angle_diff(jnp.asarray(ang), jnp.asarray(b)))
    # a Python float is wrapped in float64, as JAX's x64 does
    assert float(frames.normalize_angle(4.0)) == float(
        jframes.normalize_angle(4.0))


# -- plan utils ---------------------------------------------------------------

def _plans():
    """The cases of tests/test_planner.py and seeded noisy plans."""
    rng = np.random.default_rng(7)
    line = np.stack([np.arange(10.0), np.zeros(10)], axis=1)
    diag = np.stack([np.arange(20.0), np.arange(20.0)], axis=1)
    dense = np.stack([np.linspace(0, 9.9, 100), np.zeros(100)], axis=1)
    walk = np.cumsum(rng.normal(size=(60, 2)) * 0.1 + [0.1, 0.02], axis=0)
    course = shapes.infinity()[100:260]
    return {"line": line, "diag": diag, "dense": dense, "walk": walk,
            "course": course, "two": line[:2], "one": line[:1]}


PLANS = _plans()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_utils_equal_jax(name):
    plan = PLANS[name]
    for robot in (np.array([2.3, 0.0]), np.array([-1.0, 0.0]),
                  plan[len(plan) // 2, :2] + 0.05):
        np.testing.assert_array_equal(plan_utils.cutoff_plan(plan, robot),
                                      jplan.cutoff_plan(plan, robot))
    for seg in (3, 10):
        np.testing.assert_array_equal(plan_utils.downsample_plan(plan, seg),
                                      jplan.downsample_plan(plan, seg))
    for length in (0.5, 2.0, 50.0):
        np.testing.assert_array_equal(
            plan_utils.truncate_by_length(plan, length),
            jplan.truncate_by_length(plan, length))
    assert plan_utils.path_heading(plan) == jplan.path_heading(plan)
    for frac in (0.3, 0.8):
        assert (plan_utils.lookahead_heading(plan, frac)
                == jplan.lookahead_heading(plan, frac))


def test_plan_utils_cases_of_the_jax_tests():
    """tests/test_planner.py:13-52, through the port."""
    plan = PLANS["line"]
    out = plan_utils.cutoff_plan(plan, np.array([2.3, 0.0]))
    assert out[0, 0] == 2.0 and len(out) == 8
    assert len(plan_utils.cutoff_plan(plan[:5], np.array([-1.0, 0.0]))) == 5
    out = plan_utils.downsample_plan(PLANS["dense"], segments=10)
    assert np.allclose(out[[0, -1]], PLANS["dense"][[0, -1]])
    assert 10 <= len(out) <= 12
    ang, valid = plan_utils.lookahead_heading(PLANS["diag"])
    assert valid and abs(ang - np.pi / 4) <= 1e-12
    assert not plan_utils.lookahead_heading(
        np.stack([np.arange(20.0), np.zeros(20)], axis=1))[1]


# -- FSM ----------------------------------------------------------------------

STATES = list(fsm.DrivingState)


@pytest.mark.parametrize("state", STATES, ids=[s.value for s in STATES])
def test_fsm_transitions_equal_jax(state):
    jstate = jfsm.DrivingState(state.value)
    for pos in (False, True):
        for goal in (False, True):
            for below in (False, True):
                kw = dict(position_reached=pos, goal_reached=goal,
                          below_heading_error=below)
                assert (fsm.check_transition(state, **kw).value
                        == jfsm.check_transition(jstate, **kw).value)
                kw.pop("goal_reached")
                assert (fsm.seed_state(**kw).value
                        == jfsm.seed_state(**kw).value)


def test_rotate_command_and_wrap_equal_jax():
    rng = np.random.default_rng(8)
    for cur, tgt, gain in zip(rng.uniform(-7, 7, 40), rng.uniform(-7, 7, 40),
                              rng.uniform(0.1, 2.0, 40)):
        assert fsm.rotate_command(cur, tgt, gain) == jfsm.rotate_command(
            cur, tgt, gain)
        assert fsm.normalize_angle(cur - tgt) == jfsm.normalize_angle(
            cur - tgt)
    # tests/test_planner.py:87-92
    assert fsm.rotate_command(3.0, -3.0)[1] == pytest.approx(
        0.5 * ((-3.0 - 3.0 + np.pi) % (2 * np.pi) - np.pi))


# -- courses and metrics ------------------------------------------------------

@pytest.mark.parametrize("name", sorted(shapes.SHAPES))
def test_courses_equal_jax(name):
    np.testing.assert_array_equal(shapes.get_shape(name),
                                  jshapes.get_shape(name))


def test_cost_breakdown_equals_jax():
    rng = np.random.default_rng(9)
    zs, us = rng.normal(size=(20, 6)), rng.normal(size=(19, 2))
    leaves = {"w_cte": 300.0, "ref_vel": 0.4, "w_angvel_d": 7.0}
    ours = metrics.cost_breakdown(torch.tensor(zs), us,
                                  config.MPCParams(**leaves))
    ref = jmetrics.cost_breakdown(zs, us, jconfig.MPCParams(**leaves))
    for f in dataclasses.fields(ours):
        _close(getattr(ours, f.name), getattr(ref, f.name))
    _close(ours.total, ref.total)


def test_run_stats_summary_equals_jax():
    from types import SimpleNamespace as NS

    rng = np.random.default_rng(10)
    ours, ref = metrics.RunStats(), jmetrics.RunStats()
    for i in range(25):
        solve = (None if i % 5 == 0 else
                 NS(converged=i % 7 != 0, n_iters=int(rng.integers(1, 9)),
                    cost=float(rng.uniform(1, 100))))
        info = NS(solve_time_s=float(rng.uniform(0.01, 0.2)),
                  tracking=None if i % 6 == 0 else NS(solve=solve))
        ours.record_cycle(info)
        ref.record_cycle(info)
    assert ours.summary() == ref.summary()
