"""The port's native runtime (`native/runtime.py`, `runtime.cc`): the cases
of tests/test_native.py on the port —

* seqlock topics: round trip, capacity, tear-free reads under a writer
  thread, and `ShmTopic` across two OS processes (the other process is
  `testing.shm_publish`), an attach to a missing topic timing out;
* the rate executor's pacing and overrun accounting, the CSV logger's
  schema (read back by the port's `sim.logger`);
* `plan_fit` bit for bit against the JAX package's `plan_fit` on the same
  inputs (the same C++ source, each package's own build), against the
  numpy pipeline at tests/test_native.py's bars, and None on degenerate
  plans;
* the tracker's native and numpy fits (`_native_prep`) within 1e-13 on
  the error state and the coefficients;
* the library built under `build/native/`, keyed by the source's hash,
  nothing written beside the source.
"""

import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mpc_ros_tpu_torch.native import (NativeCsvLogger, RateLoop, ShmTopic,
                                      Topic, plan_fit, runtime)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_topic_roundtrip():
    with Topic(64) as t:
        assert t.read() is None
        t.publish(struct.pack("<2d", 0.5, -0.2))
        v, w = struct.unpack("<2d", t.read())
        assert (v, w) == (0.5, -0.2)
        assert t.publish_count == 1


def test_topic_capacity_enforced():
    with Topic(8) as t:
        with pytest.raises(ValueError):
            t.publish(b"x" * 9)


def test_topic_tear_free_under_contention():
    """A writer thread publishes (k, k, ..., k) payloads; the reader never
    sees a mixed payload."""
    n_words = 8
    stop = threading.Event()
    torn = []
    with Topic(n_words * 8) as t:
        def writer():
            k = 0
            while not stop.is_set():
                t.publish(struct.pack(f"<{n_words}q", *([k] * n_words)))
                k += 1

        th = threading.Thread(target=writer)
        th.start()
        t_end = time.time() + 0.5
        reads = 0
        while time.time() < t_end:
            raw = t.read()
            if raw is None:
                continue
            vals = struct.unpack(f"<{n_words}q", raw)
            if len(set(vals)) != 1:
                torn.append(vals)
            reads += 1
        stop.set()
        th.join()
    assert reads > 1000
    assert not torn, f"torn reads observed: {torn[:3]}"


def test_rate_loop_paces_and_counts():
    period = 0.005
    with RateLoop(period) as r:
        t0 = time.perf_counter()
        for _ in range(20):
            r.sleep()
        elapsed = time.perf_counter() - t0
        assert r.stats["cycles"] == 20
    assert elapsed >= 0.095


def test_rate_loop_detects_overrun():
    with RateLoop(0.005) as r:
        r.sleep()
        time.sleep(0.02)          # blow the deadline
        late = r.sleep()
        assert late > 0.0
        assert r.stats["overruns"] >= 1
        assert r.stats["worst_late_ms"] > 1.0


def test_native_csv_matches_reference_schema(tmp_path):
    from mpc_ros_tpu_torch.sim.logger import read_tracking_csv

    path = str(tmp_path / "native.csv")
    log = NativeCsvLogger(path)
    log.row(1, 0.03, 0.01, 0.0, 0.0)
    log.row(2, 0.01, -0.05, 0.5, -0.18)
    assert log.close(12.5) == 2
    with open(path) as f:
        assert f.readline().strip() == \
            "idx,cte,etheta,cmd_vel.linear.x,cmd_vel.angular.z"
    rec, course = read_tracking_csv(path)
    assert rec.shape == (2, 5)
    np.testing.assert_allclose(course, 12.5, atol=1e-9)


def test_shm_topic_cross_process():
    """A second OS process attaches to a POSIX shared-memory topic and
    publishes counter payloads while this one reads: every read tear-free
    and never older than the last, and the final count arrives."""
    name = f"/mpcrt_torch_xproc_{os.getpid()}"
    n = 20000
    topic = ShmTopic(name, 64, create=True)
    try:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys; from mpc_ros_tpu_torch.testing import shm_publish;"
             " shm_publish(sys.argv[1], int(sys.argv[2]))", name, str(n)],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))
        last, reads = 0, 0
        deadline = time.time() + 60.0
        while time.time() < deadline:
            raw = topic.read()
            if raw is not None:
                words = struct.unpack("<8Q", raw)
                assert len(set(words)) == 1, f"torn read: {words}"
                assert words[0] >= last, "stale value after a fresher one"
                last = words[0]
                reads += 1
                if last == n:
                    break
        assert proc.wait(timeout=60) == 0
        assert last == n and reads > 100
        assert topic.publish_count == n
    finally:
        topic.close()
        topic.unlink()


def test_shm_topic_attach_missing_times_out():
    with pytest.raises(OSError):
        ShmTopic("/mpcrt_torch_definitely_missing", attach_timeout_ms=50)


# ---------------------------------------------------------------- plan fit


def _plans(seed=7, trials=10):
    rng = np.random.default_rng(seed)
    for _ in range(trials):
        n = int(rng.integers(4, 40))
        t = np.linspace(0, 2.0, n)
        plan = np.stack([t + 0.05 * rng.normal(size=n),
                         0.3 * np.sin(t) + 0.05 * rng.normal(size=n)], 1)
        yield plan, rng.normal(0, 0.5, 3), min(3, n - 1)


def test_plan_fit_bit_for_bit_with_the_jax_package():
    from mpc_ros_tpu.native.runtime import plan_fit as jplan_fit

    for plan, pose, order in _plans():
        ours, ref = plan_fit(plan, pose, order), jplan_fit(plan, pose, order)
        np.testing.assert_array_equal(ours[0], ref[0])
        assert ours[1:] == ref[1:]


def test_plan_fit_matches_numpy():
    from mpc_ros_tpu_torch.planner.plan_utils import lookahead_heading

    for plan, pose, order in _plans():
        c_nat, cte_nat, head_nat, valid_nat = plan_fit(plan, pose, order)
        ct, st = np.cos(pose[2]), np.sin(pose[2])
        dx, dy = plan[:, 0] - pose[0], plan[:, 1] - pose[1]
        c_np = np.polyfit(dx * ct + dy * st, dy * ct - dx * st, order)[::-1]
        head_np, valid_np = lookahead_heading(plan)
        np.testing.assert_allclose(c_nat, c_np, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(cte_nat, c_np[0], rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(head_nat, head_np, rtol=1e-12)
        assert valid_nat == valid_np


def test_plan_fit_degenerate_returns_none():
    assert plan_fit(np.zeros((1, 2)), (0.0, 0.0, 0.0), 1) is None
    assert plan_fit(np.zeros((5, 2)), (0.0, 0.0, 0.0), 3) is None


def test_tracker_native_and_numpy_fits_agree():
    """One Tracking cycle each way on the same inputs: the coefficients
    and the error state within 1e-13 (Householder QR against numpy's
    least squares)."""
    from mpc_ros_tpu_torch.config import (MPCParams, PlannerConfig,
                                          SolverConfig)
    from mpc_ros_tpu_torch.planner.tracking import TrackingController

    out = []
    for native in (True, False):
        tc = TrackingController(MPCParams(w_cte=300.0),
                                SolverConfig(n_steps=8, max_sqp_iters=2),
                                PlannerConfig(), dtype=torch.float64,
                                device="cpu")
        assert tc._native_prep
        tc._native_prep = native
        worst = []
        for plan, pose, _ in _plans(seed=3, trials=4):
            _, dbg = tc.compute(pose, plan[-1], 0.3, plan)
            worst.append((dbg.coeffs, dbg.state))
        out.append(worst)
    for (c1, s1), (c2, s2) in zip(*out):
        np.testing.assert_allclose(c1, c2, rtol=0, atol=1e-13)
        np.testing.assert_allclose(s1, s2, rtol=0, atol=1e-13)


def test_library_builds_under_build_native():
    runtime.get_lib()
    so = runtime.library_path()
    assert so.exists() and so.parent == runtime.BUILD_DIR
    assert so.parent.parts[-2:] == ("build", "native")
    src_dir = os.path.dirname(runtime.__file__)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]
