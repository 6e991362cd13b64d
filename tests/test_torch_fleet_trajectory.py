"""The port's `FleetTrajectoryTracker` against the JAX package's, on the
CPU: B robots chasing B timed references with one batched solve per
cycle through `batch_solve_lane(refs=...)` (K1 stage (f) on the card).

The host pipeline (float64 numpy sampling and fit) agrees with the JAX
host pipeline in float64 within 1e-8 on the commands, the lags and the
observability tile, with and without world-frame blobs and with a
per-robot dt (the horizon's step is the fleet's largest). The device
pipeline samples and fits in float32 by the JAX design, so its ulp-level
differences from the JAX device pipeline (transcendentals and reduction
order) pass through an ill-conditioned fit: it is held to 1e-5 on the
commands and lags against the JAX device pipeline (measured ~5e-7), and
to the JAX package's bars against the host pipeline
(tests/test_trajectory_tracking.py: commands 2e-3, lags 1e-3; the tile's
cte, etheta and ref_v[0] 2e-3, convergence equal, iterations within one,
cost 1e-3 relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.config import MPCParams as JMPCParams
from mpc_ros_tpu.config import PlannerConfig as JPlannerConfig
from mpc_ros_tpu.config import SolverConfig as JSolverConfig
from mpc_ros_tpu.models.obstacles import GaussianObstacles as JBlobs
from mpc_ros_tpu.planner.trajectory import FleetTrajectoryTracker as JFleet
from mpc_ros_tpu.planner.trajectory import TimedTrajectory as JTimed
from mpc_ros_tpu_torch.config import MPCParams, PlannerConfig, SolverConfig
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.planner import FleetTrajectoryTracker, TimedTrajectory
from mpc_ros_tpu_torch.testing import fleet_courses, step_poses, torch_threads

# tests/test_trajectory_tracking.py's fleet tracker
LEAVES = dict(dt=0.1, max_angvel=1.5, w_cte=300.0, w_angvel_d=10.0,
              w_accel_d=10.0)
N = 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


def _plans(B):
    return [p[:240] for p in fleet_courses(B, offset=3.0)]


def _speeds(B):
    return [0.35 + 0.02 * i for i in range(B)]


def _port(pipeline, B, dtype="float64", leaves=None, **kw):
    tr = FleetTrajectoryTracker(
        MPCParams(**(leaves or LEAVES)), SolverConfig(n_steps=N),
        PlannerConfig(local_plan_length=2.5), dtype=getattr(torch, dtype),
        pipeline=pipeline, device="cpu", **kw)
    tr.set_trajectories([TimedTrajectory.from_path(p, v)
                         for p, v in zip(_plans(B), _speeds(B))])
    return tr


def _jax(pipeline, B, dtype="float64", leaves=None, **kw):
    leaves = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for k, v in (leaves or LEAVES).items()}
    tr = JFleet(JMPCParams(**leaves), JSolverConfig(n_steps=N),
                JPlannerConfig(local_plan_length=2.5),
                dtype=getattr(jnp, dtype), pipeline=pipeline, **kw)
    tr.set_trajectories([JTimed.from_path(p, v)
                         for p, v in zip(_plans(B), _speeds(B))])
    return tr


def _blob_arrays(tracker, B):
    """A blob at each robot's reference point one second ahead."""
    ahead, _, _ = tracker._sample(np.full((B, 1), 1.0))
    return (ahead[:, 0, 0:1], ahead[:, 0, 1:2], np.full((B, 1), 0.3),
            np.full((B, 1), 40.0))


def _run(trackers, B, cycles):
    """Every tracker on the first tracker's pose stream; yields (cycle,
    [(cmds, lags, last_obs), ...])."""
    trajs = [TimedTrajectory.from_path(p, 0.35) for p in _plans(B)]
    poses = np.stack([np.r_[t.xy[0], t.yaw[0]] for t in trajs])
    vs = np.zeros(B)
    for cyc in range(cycles):
        outs = []
        for tr in trackers:
            cmds, lags = tr.compute(cyc * 0.1, poses.copy(), vs.copy())
            outs.append((cmds, np.asarray(lags, float), tr.last_obs))
        yield cyc, outs
        vs = step_poses(poses, outs[0][0], 0.1)[:, 0]


@pytest.mark.parametrize("case", ["plain", "blobs", "per_robot_dt"])
def test_host_pipeline_matches_jax(case):
    B = 4 if case == "blobs" else 8
    leaves = dict(LEAVES)
    if case == "per_robot_dt":
        leaves["dt"] = np.linspace(0.08, 0.12, B)
    ours = _port("host", B, leaves=leaves, obs_every=1)
    ref = _jax("host", B, leaves=leaves, obs_every=1)
    assert ours._dt_max == pytest.approx(float(np.max(leaves["dt"])),
                                         abs=0.0)
    if case == "blobs":
        arrays = _blob_arrays(ours, B)
        ours.set_obstacles(GaussianObstacles.from_sigmas(
            *(torch.tensor(a) for a in arrays)))
        ref.set_obstacles(JBlobs.from_sigmas(*(jnp.asarray(a)
                                               for a in arrays)))
        plain = _port("host", B, leaves=leaves)
        trackers = [ref, ours, plain]
    else:
        trackers = [ref, ours]
    for cyc, outs in _run(trackers, B, 5):
        (c_j, l_j, o_j), (c_t, l_t, o_t) = outs[:2]
        assert np.abs(c_t - c_j).max() <= 1e-8, cyc
        assert np.abs(l_t - l_j).max() <= 1e-8, cyc
        assert o_t.shape == (6, B)
        assert np.abs(o_t[:3] - o_j[:3]).max() <= 1e-8
        np.testing.assert_array_equal(o_t[4:], o_j[4:])
        np.testing.assert_allclose(o_t[3], o_j[3], rtol=1e-10)
    if case == "blobs":
        # the blobs change the commands by the time the robots near them
        assert np.abs(outs[1][0] - outs[2][0]).max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_device_pipeline_matches_jax_and_host(dtype):
    B = 8
    dev = _port("device", B, dtype, obs_every=1)
    ref = _jax("device", B, dtype, obs_every=1)
    host = _port("host", B, dtype, obs_every=1)
    assert dev._dev_consts["t"].dtype == torch.float32
    for cyc, ((c_j, l_j, o_j), (c_d, l_d, o_d),
              (c_h, l_h, o_h)) in _run([ref, dev, host], B, 5):
        assert np.abs(c_d - c_j).max() <= 1e-5, cyc
        assert np.abs(l_d - l_j).max() <= 1e-5, cyc
        np.testing.assert_array_equal(o_d[4:], o_j[4:])
        # the device pipeline against the host pipeline, the JAX bars
        assert np.abs(c_d - c_h).max() < 2e-3, cyc
        assert np.abs(l_d - l_h).max() < 1e-3, cyc
        np.testing.assert_allclose(o_d[:3], o_h[:3], atol=2e-3)
        np.testing.assert_array_equal(o_d[4], o_h[4])
        assert np.abs(o_d[5] - o_h[5]).max() <= 1
        np.testing.assert_allclose(o_d[3], o_h[3], rtol=1e-3)
    assert dev._warm_us.dtype == getattr(torch, dtype)


def test_device_pipeline_with_blobs_matches_host():
    """Per-robot world-frame blobs through the device cycle as through the
    host pipeline (tests/test_trajectory_tracking.py's bar, 2e-3)."""
    B = 4
    dev = _port("device", B, "float32")
    host = _port("host", B, "float32")
    arrays = _blob_arrays(host, B)
    for tr in (dev, host):
        tr.set_obstacles(GaussianObstacles.from_sigmas(
            *(torch.tensor(a, dtype=torch.float32) for a in arrays)))
    for cyc, ((c_h, _, _), (c_d, _, _)) in _run([host, dev], B, 4):
        assert np.abs(c_h - c_d).max() < 2e-3, cyc


def test_lean_cycles_and_sampling():
    """obs_every=2 fills last_obs every other cycle on both pipelines;
    `_sample` and `finished` equal the JAX tracker's."""
    B = 4
    dev = _port("device", B, "float32", obs_every=2)
    host = _port("host", B, "float32", obs_every=2)
    for cyc, outs in _run([host, dev], B, 3):
        for _, _, obs in outs:
            assert (obs is None) == (cyc % 2 == 1)
    ref = _jax("host", B)
    times = np.array([[-1.0, 0.0, 3.3, 50.0, 1e3]] * B)
    for a, b in zip(host._sample(times), ref._sample(times)):
        np.testing.assert_array_equal(a, b)
    poses = np.stack([p[-1] for p in _plans(B)])
    for t in (0.0, 1e3):
        np.testing.assert_array_equal(host.finished(t, poses),
                                      ref.finished(t, poses))
    assert host.finished(1e3, poses).all()


def test_mesh_is_not_ported():
    """A device mesh is ported (tests/test_torch_parallel.py holds the
    sharded device cycle to the unsharded one); as in the JAX package it
    needs the device pipeline."""
    from mpc_ros_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_data=2, devices=["cpu"] * 2)
    tr = FleetTrajectoryTracker(MPCParams(), SolverConfig(), device="cpu",
                                pipeline="device", mesh=mesh)
    assert tr.mesh is mesh
    with pytest.raises(AssertionError):
        FleetTrajectoryTracker(MPCParams(), SolverConfig(), device="cpu",
                               mesh=mesh)
