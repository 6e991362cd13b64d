"""The supervisors (`planner/safety.py`, `planner/recovery.py`), the config
files (`config_io.py`), the checkpoints (`obs/checkpoint.py`) and the
scipy oracle (`solver/oracle.py`) of the port against the JAX package's,
on the inputs of tests/test_safety_checkpoint.py, test_recovery.py and
test_config_io.py:

* each scripted safety and recovery case runs on both packages and the
  traces (commands, status, ladder state and statistics) are equal;
* the lost-plan recovery around a real `MPCPlanner` (the port's on the
  CPU in float64, the JAX planner with its numpy path fit): the same
  ladder, commands within 1e-6;
* every config case loads to the same dataclasses on both sides, and the
  refusals raise the same messages; the CLI's `--config` runs the course
  with the file's values;
* the checkpoint round trip, atomic replacement and `.old` fallback, and
  the states restored equal to those of the JAX package's orbax files;
* the oracle against the JAX oracle on tests/test_solver.py's cases.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpc_ros_tpu.config as jconfig
import mpc_ros_tpu.config_io as jconfig_io
import mpc_ros_tpu.obs.checkpoint as jckpt
import mpc_ros_tpu.planner as jplanner
import mpc_ros_tpu.planner.tracking as jax_tracking
from mpc_ros_tpu.solver.oracle import solve_oracle as jsolve_oracle
from mpc_ros_tpu_torch import config as tconfig
from mpc_ros_tpu_torch import config_io as tconfig_io
from mpc_ros_tpu_torch import planner as tplanner
from mpc_ros_tpu_torch.obs import checkpoint as tckpt
from mpc_ros_tpu_torch.solver.oracle import solve_oracle
from mpc_ros_tpu_torch.testing import torch_threads

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {
    "jax": types.SimpleNamespace(config=jconfig, config_io=jconfig_io,
                                 planner=jplanner),
    "torch": types.SimpleNamespace(config=tconfig, config_io=tconfig_io,
                                   planner=tplanner),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once
    (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


def both(fn):
    """fn(package) on both packages; the two results, asserted equal."""
    ref, ours = fn(PACKAGES["jax"]), fn(PACKAGES["torch"])
    assert ours == ref, (ours, ref)
    return ours


# ------------------------------------------------------------------ safety


def _info(converged=True, solve_time_s=0.01):
    return types.SimpleNamespace(
        solve_time_s=solve_time_s,
        tracking=types.SimpleNamespace(
            solve=types.SimpleNamespace(converged=converged)))


NAN = float("nan")
# (name, SafetyConfig kwargs, [(ok, cmd, info) per cycle], clear after)
SAFETY_CASES = [
    ("healthy", {}, [(True, (0.4, 0.1), None)] * 5, None),
    ("latch_and_decelerate",
     dict(max_consecutive_failures=3, decel_limit=1.0),
     [(True, (0.5, 0.0), None)] + [(False, (0.5, 0.2), None)] * 4
     + [(True, (0.5, 0.1), None)] * 2, 5),
    ("nonfinite", {}, [(True, (NAN, 0.0), None), (True, (0.2, NAN), None),
                       (True, (0.3, 0.1), None)], None),
    ("not_converged_and_overrun", {},
     [(True, (0.3, 0.1), _info(converged=False)),
      (True, (0.3, 0.1), _info(solve_time_s=0.15)),
      (True, (0.3, 0.1), _info(solve_time_s=0.35)),
      (True, (0.3, 0.1), _info())], None),
    ("reverse_ramp", dict(decel_limit=1.0),
     [(True, (-0.5, 0.0), None), (False, (0.0, 0.0), None),
      (False, (0.0, 0.0), None), (True, (-0.2, 0.0), None)], None),
]


@pytest.mark.parametrize("case", SAFETY_CASES, ids=lambda c: c[0])
def test_safety_monitor_matches_jax(case):
    """tests/test_safety_checkpoint.py's monitor cases on both packages:
    the same commands and status after every cycle."""
    _, kw, cycles, clear_after = case

    def run(pkg):
        from importlib import import_module

        safety = import_module(pkg.planner.__name__ + ".safety")
        m = safety.SafetyMonitor(0.1, safety.SafetyConfig(**kw))
        trace = []
        for i, (ok, cmd, info) in enumerate(cycles):
            if clear_after is not None and i == clear_after + 1:
                m.clear_fault()
            v, w = m.check(ok, cmd, info)
            trace.append((repr(v), repr(w),
                          tuple(dataclasses.asdict(m.status).items())))
        return trace

    trace = both(run)
    assert all(np.isfinite(float(v)) for v, _, _ in trace)


# ---------------------------------------------------------------- recovery


class FakePlanner:
    """tests/test_recovery.py's scripted planner: fails until `fail_for`
    calls have elapsed."""

    def __init__(self, fail_for=10**9, model=None, config=None):
        self.fail_for = fail_for
        self.calls = 0
        self.set_plans = []
        self.global_plan = None
        if model is not None:
            self.solver_cfg = config.SolverConfig(n_steps=10, model=model)

    def set_plan(self, plan, pose, feedback_vel=(0.0, 0.0)):
        self.set_plans.append(np.asarray(plan, float))
        self.global_plan = np.asarray(plan, float)
        return True

    def compute_velocity_commands(self, pose, feedback):
        self.calls += 1
        if self.calls > self.fail_for:
            return True, (0.3, 0.1), None
        return False, (0.0, 0.0), None


PLAN = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
POSE = np.array([0.0, 0.1, 0.0])
UP = np.array([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 2.0, 0.0]])
# (name, FakePlanner kwargs, cycles: True/False = the caller's planner
# result, "call" = the caller runs the fake planner itself, "reset")
RECOVERY_CASES = [
    ("passthrough_threshold", {},
     [True, False, False, True, False, False]),
    ("replan_clears", dict(fail_for=0), [False] * 3),
    ("rotate_then_recover", dict(fail_for=1), [False] * 3 + ["call"]),
    ("rotating_no_extra_solve", {}, [False] * 4),
    ("nonrotating_family", dict(fail_for=5, model="bicycle"),
     [False] * 3 + ["call"] * 4),
    ("exhaustion_abort_reset", {}, [False] * 16 + ["reset", True]),
    ("rotate_direction", {}, [False] * 3),
]


@pytest.mark.parametrize("case", RECOVERY_CASES, ids=lambda c: c[0])
def test_recovery_ladder_matches_jax(case):
    """tests/test_recovery.py's scripted ladders on both packages: the
    same (ok, command), ladder state, statistics and planner calls every
    cycle."""
    name, kw, cycles = case
    cfg_kw = dict(failures_to_recover=3, rotate_speed=0.4,
                  rotate_cycles_max=5, max_rounds=2)

    def run(pkg):
        fp = FakePlanner(config=pkg.config, **kw)
        sup = pkg.planner.RecoverySupervisor(
            fp, pkg.planner.RecoveryConfig(**cfg_kw))
        plan, pose = ((UP, np.array([0.0, 0.0, 3.0]))
                      if name == "rotate_direction" else (PLAN, POSE))
        sup.set_plan(plan, pose)
        trace = [sup._can_rotate]
        for c in cycles:
            if c == "reset":
                sup.reset()
                continue
            if c == "call":
                ok, cmd, _ = fp.compute_velocity_commands(pose, (0.0, 0.0))
            else:
                ok, cmd = c, ((0.5, -0.2) if c else (0.0, 0.0))
            ok, cmd = sup.on_cycle(ok, cmd, pose, (0.0, 0.0))
            trace.append((ok, cmd, sup.state.value,
                          tuple(dataclasses.asdict(sup.stats).items()),
                          fp.calls, len(fp.set_plans)))
        return trace

    both(run)


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


def test_real_planner_lost_plan_recovers(jax_numpy_fit):
    """tests/test_recovery.py::test_real_planner_lost_plan_recovers on
    both packages (float64): the plan vanishes mid-course, the supervisor
    re-issues it and tracking resumes; every command finite and within
    1e-6 of the JAX planner's, the ladder's states and statistics
    equal."""
    traces = {}
    for name, pkg in PACKAGES.items():
        kw = dict(device="cpu", dtype=torch.float64) if name == "torch" \
            else {}
        planner = pkg.planner.MPCPlanner(
            params=pkg.config.MPCParams(),
            solver_cfg=pkg.config.SolverConfig(n_steps=10, max_sqp_iters=8,
                                               backward="xla"),
            planner_cfg=pkg.config.PlannerConfig(), **kw)
        planner.initialize()
        plan = np.stack([np.linspace(0, 3, 30), np.zeros(30),
                         np.zeros(30)], 1)
        pose = np.array([0.0, 0.05, 0.0])
        sup = pkg.planner.RecoverySupervisor(planner,
                                             pkg.planner.RecoveryConfig())
        assert sup.set_plan(plan, pose)
        trace = []
        for k in range(6):
            if k == 1:
                planner.global_plan = None        # a host-side fault
            ok, cmd, _ = planner.compute_velocity_commands(pose, (0.2, 0.0))
            ok, cmd = sup.on_cycle(ok, cmd, pose, (0.2, 0.0))
            trace.append((ok, cmd, sup.state.value,
                          dataclasses.asdict(sup.stats)))
        assert planner.global_plan is not None
        traces[name] = trace
    for (ok_o, c_o, s_o, st_o), (ok_r, c_r, s_r, st_r) in zip(
            traces["torch"], traces["jax"]):
        assert (ok_o, s_o, st_o) == (ok_r, s_r, st_r)
        assert np.isfinite(c_o).all()
        assert np.abs(np.subtract(c_o, c_r)).max() <= 1e-6
    assert traces["torch"][-1][3]["replans"] == 1


# ------------------------------------------------------------------ config

REFERENCE_YAML = """
pub_twist_cmd: true
debug_info: false
delay_mode: true
max_speed: 0.5
waypoints_dist: -1.0
path_length: 5.0
goal_radius: 0.5
controller_freq: 10

mpc_steps: 20.0
mpc_ref_cte: 0.0
mpc_ref_vel: 0.5
mpc_ref_etheta: 0.0
mpc_w_cte: 100.0
mpc_w_etheta: 0000.0
mpc_w_vel: 1000.0
mpc_w_angvel: 100.0
mpc_w_angvel_d: 0.0
mpc_w_accel: 50.0
mpc_w_accel_d: 0.0
mpc_max_angvel: 1.5
mpc_max_throttle: 1.0
mpc_bound_value: 1.0e3
"""
STRINGS_YAML = (
    "mpc: {w_cte: 300.0}\n"
    "solver: {mu_max: 1e8, n_steps: '12'}\n"
    "planner: {max_speed: 1e0, delay_mode: 'true',\n"
    "          limits: {xy_goal_tolerance: 1e-1}}\n")


def _flat(triple):
    """A loaded (params, solver, planner) as comparable plain values."""
    params, solver, planner = triple
    mpc = {f.name: float(getattr(params, f.name))
           for f in dataclasses.fields(params)}
    return (mpc, dataclasses.asdict(solver), dataclasses.asdict(planner))


CONFIG_CASES = {
    "reference_yaml": ("file", REFERENCE_YAML),
    "string_numerics": ("file", STRINGS_YAML),
    "cfg_spelling": ("dict", {"steps": 30, "w_cte": 250.0,
                              "max_angvel": 2.0}),
    "throttle_clamp": ("dict", {"mpc_max_throttle": 0.01}),
    "nested_wins": ("dict", {"mpc_w_cte": 10.0, "mpc": {"w_cte": 99.0}}),
    "ddp_spellings": ("dict", {"solver": {"ddp": "auto"}}),
    "round_trip": ("round_trip", None),
}


@pytest.mark.parametrize("case", list(CONFIG_CASES))
def test_config_loads_match_jax(case, tmp_path):
    """tests/test_config_io.py's loads on both packages: the same
    parameters, solver and planner configurations (the round trip through
    `save_config` too)."""
    kind, data = CONFIG_CASES[case]

    def run(pkg):
        io = pkg.config_io
        if kind == "file":
            f = tmp_path / f"{id(pkg)}.yaml"
            f.write_text(data)
            return _flat(io.load_config(f))
        if kind == "dict":
            return _flat(io.config_from_dict(data))
        c = pkg.config
        f = tmp_path / f"{id(pkg)}_rt.yaml"
        io.save_config(f, c.MPCParams(w_cte=321.0, dt=0.05),
                       c.SolverConfig(n_steps=25, max_sqp_iters=17,
                                      schedule="sorted"),
                       c.PlannerConfig(delay_mode=False, max_speed=1.2))
        return _flat(io.load_config(f)), f.read_text()

    out = both(run)
    if case == "reference_yaml":
        mpc, solver, planner = out
        assert solver["n_steps"] == 20 and mpc["dt"] == pytest.approx(0.1)
        assert planner["limits"]["xy_goal_tolerance"] == 0.5


REFUSALS = {
    "unknown_flat": {"mpc_w_vell": 100.0},
    "unknown_nested": {"solver": {"n_stepz": 10}},
    "n_steps": {"solver": {"n_steps": 1}},
    "negative_weight": {"mpc": {"w_cte": -5.0}},
    "controller_freq": {"controller_freq": 0.0},
    "int_ddp": {"solver": {"ddp": 1}},
    "mu_init": {"solver": {"mu_init": "fast"}},
    "model": {"solver": {"model": "hovercraft"}},
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_config_refusals_match_jax(case):
    """The refusals of tests/test_config_io.py (unknown keys, bad values,
    the truthy int `ddp`) raise the same ValueError on both sides."""
    def run(pkg):
        with pytest.raises(ValueError) as e:
            pkg.config_io.config_from_dict(REFUSALS[case])
        return str(e.value)

    both(run)


def test_reference_defaults_match_jax():
    """`MPCParams.reference_defaults()` (the reference's live
    dynamic_reconfigure defaults) equal on both sides."""
    def run(pkg):
        r = pkg.config.MPCParams.reference_defaults()
        return {f.name: float(getattr(r, f.name))
                for f in dataclasses.fields(r)}

    both(run)


def test_cli_config_runs_the_file(tmp_path):
    """`sim.run --config` (the CLI's case this slice ports): the reference
    rosparam file's horizon and speed reach the planner; the flags still
    override the file."""
    f = tmp_path / "mpc_params.yaml"
    f.write_text(REFERENCE_YAML)
    out = subprocess.run(
        [sys.executable, "-m", "mpc_ros_tpu_torch.sim.run", "--cpu",
         "--config", str(f), "--max-cycles", "3", "--n-steps", "8"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
        env=dict(os.environ, OMP_NUM_THREADS="1")).stdout.strip()
    rec = json.loads(out.splitlines()[-1])
    assert rec["cycles"] == 3 and rec["n_solves"] == 3
    assert rec["device"] == "cpu"


# ------------------------------------------------------------- checkpoint


def test_checkpoint_roundtrip_matches_jax(tmp_path):
    """tests/test_safety_checkpoint.py's serving and sweep states saved by
    each package and restored: the port's leaves (CPU tensors) equal the
    JAX package's (orbax) bit for bit; an absent path is None."""
    rng = np.random.default_rng(0)
    zs = rng.normal(size=(8, 6))
    warm = rng.normal(size=(8, 9, 2))
    cands = {f.name: np.exp(rng.normal(size=4)) for f in
             dataclasses.fields(tconfig.MPCParams)}
    stats = (np.arange(4.0), np.arange(4.0) * 0.1, np.ones(4))
    out = {}
    for name, mod, cfg, arr in (
            ("jax", jckpt, jconfig, jnp.asarray),
            ("torch", tckpt, tconfig, torch.tensor)):
        cand = cfg.MPCParams(**{k: arr(v) for k, v in cands.items()})
        for kind, st in (
                ("serving", mod.serving_state(arr(zs), arr(warm), cycle=42)),
                ("sweep", mod.sweep_state(cand, *(arr(s) for s in stats),
                                          n_done=2))):
            path = str(tmp_path / f"{name}_{kind}")
            mod.save_checkpoint(path, st)
            out[name, kind] = mod.restore_checkpoint(path)
        assert mod.restore_checkpoint(str(tmp_path / "nope")) is None
    for kind in ("serving", "sweep"):
        ours, ref = out["torch", kind], out["jax", kind]
        flat_o = _leaves(ours)
        flat_r = _leaves(ref)
        assert flat_o.keys() == flat_r.keys()
        for k in flat_r:
            assert isinstance(flat_o[k], torch.Tensor), k
            np.testing.assert_array_equal(flat_o[k].numpy(),
                                          np.asarray(flat_r[k]))
    assert int(out["torch", "serving"]["cycle"]) == 42
    assert int(out["torch", "sweep"]["n_done"]) == 2


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_checkpoint_atomic_replacement(tmp_path):
    """tests/test_safety_checkpoint.py::test_checkpoint_atomic_replacement
    on the port: a second save replaces the first whole, and the `.old`
    fallback covers the window between the two renames."""
    path = str(tmp_path / "ck")
    tckpt.save_checkpoint(path, {"x": np.arange(3.0)})
    tckpt.save_checkpoint(path, {"x": np.arange(3.0) + 10.0})
    got = tckpt.restore_checkpoint(path)
    np.testing.assert_array_equal(got["x"].numpy(), np.arange(3.0) + 10.0)
    assert not os.path.exists(path + ".tmp")
    assert not os.path.exists(path + ".old")
    # the crash window: the live directory gone, only `.old` present
    shutil.move(path, path + ".old")
    got = tckpt.restore_checkpoint(path)
    np.testing.assert_array_equal(got["x"].numpy(), np.arange(3.0) + 10.0)


# ------------------------------------------------------------------ oracle


def _oracle_case(case):
    """tests/test_solver.py's oracle scenarios (the cases of
    tests/test_torch_ilqr.py::test_matches_oracle)."""
    x = np.linspace(0.0, 2.0, 20)
    curve = 0.6 if case == "saturated" else 0.2
    c = np.polyfit(x, curve * x ** 2 - 0.1 * x ** 3 + 0.05, 3)[::-1]
    z0 = np.array([0.0, 0.0, 0.0, 0.3, c[0], -np.arctan(c[1])])
    leaves = dict(dt=0.1, ref_vel=0.5, w_cte=100.0, w_etheta=100.0,
                  w_vel=100.0, w_angvel=100.0, w_accel=50.0,
                  w_angvel_d=10.0, w_accel_d=10.0, max_angvel=1.0,
                  max_throttle=1.0)
    n = 10
    if case == "saturated":
        z0[4] = 0.5
        leaves.update(ref_vel=0.8, w_cte=500.0, w_angvel=10.0, w_accel=10.0,
                      w_angvel_d=1.0, w_accel_d=1.0, max_angvel=0.3,
                      max_throttle=0.5)
        n = 12
    return z0, c, leaves, n


@pytest.mark.parametrize("case", ["n10", "saturated", "bicycle"])
def test_oracle_matches_jax_oracle(case):
    """The port's oracle (gradients from torch.autograd) against the JAX
    oracle (gradients from jax) on the same NLP: both succeed, the same
    optimum (controls within 1e-6, cost to rtol 1e-9), the dynamics
    defects below 1e-8."""
    z0, c, leaves, n = _oracle_case(case)
    kw = dict(n_steps=n, model="bicycle" if case == "bicycle" else
              "diff_drive")
    ours = solve_oracle(z0, c, tconfig.MPCParams(**leaves),
                        tconfig.SolverConfig(**kw))
    ref = jsolve_oracle(z0, c, jconfig.MPCParams(**leaves).astype(
        jnp.float64), jconfig.SolverConfig(**kw))
    assert ours.success and ref.success, (ours.status, ref.status)
    assert np.abs(ours.us - ref.us).max() <= 1e-6
    np.testing.assert_allclose(ours.cost, ref.cost, rtol=1e-9)
    assert ours.kkt_violation <= 1e-8
