"""The port's bench (`bench_cuda.py`), its roofline accounting
(`mpc_ros_tpu_torch/kernels/roofline.py`) and its phase timers
(`mpc_ros_tpu_torch/obs/timers.py`), on the CPU.

The roofline's operation and byte counts equal the JAX package's term for
term; only the device constants differ (the H100's, and the whole-solve
kernel's compute peak taken from the DeviceSpec). `kernel_verify` holds
K1's plain version against the XLA lane path under the caller's CPU, and
reads the compact schedule's engagement from its counters. `bench_cuda.py
--quick` prints one JSON line per mode with `bench.py`'s keys (less the
TPU's `vs_baseline`; the tunnel keys renamed for the fetch floor), fails
on the grid-obstacle flags naming their ROADMAP item, and refuses to run
without a card unless asked for the CPU. Neither the bench nor any port
module imports JAX.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mpc_ros_tpu.kernels import roofline as jax_roofline
from mpc_ros_tpu.obs.timers import PhaseTimers as JaxPhaseTimers
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.kernels import roofline
from mpc_ros_tpu_torch.obs import PhaseTimers, device_trace
from mpc_ros_tpu_torch.testing import torch_threads

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench_cuda  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once
    (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


H100 = dict(peak_flops_f32=67e12, hbm_bytes_per_s=3.35e12)
GRID = [(B, T, n_alpha, n_iters, ddp)
        for B in (1024, 524288) for T in (19, 29, 99)
        for n_alpha, n_iters, ddp in ((4, 3.57, True), (8, 6.0, False))]


@pytest.mark.parametrize("B,T,n_alpha,n_iters,ddp", GRID)
def test_roofline_counts_equal_the_jax_package(B, T, n_alpha, n_iters, ddp):
    """Operation and byte counts, stage by stage, exactly the JAX
    package's; with the same device constants the bounds and the
    efficiency too."""
    jdev = jax_roofline.DeviceSpec(name="NVIDIA H100 80GB HBM3", **H100)
    a = roofline.solve_accounting(B, T, n_alpha, n_iters)
    b = jax_roofline.solve_accounting(B, T, n_alpha, n_iters, dev=jdev)
    assert a == b
    for fn in ("account_linearize", "account_backward", "account_rollout"):
        sa, sb = getattr(roofline, fn)(B, T), getattr(jax_roofline, fn)(B, T)
        assert (sa.flops, sa.bytes) == (sb.flops, sb.bytes)
    fa = roofline.account_forward(B, T, n_alpha)
    fb = jax_roofline.account_forward(B, T, n_alpha)
    assert (fa.flops, fa.bytes) == (fb.flops, fb.bytes)
    ma = roofline.megakernel_accounting(B, T, n_alpha, n_iters, ddp)
    mb = jax_roofline.megakernel_accounting(B, T, n_alpha, n_iters, ddp)
    for k in ("solve_gflops", "solve_mbytes", "intensity_flop_per_byte",
              "B", "T", "n_iters"):
        assert ma[k] == mb[k], k
    # the compute peak is the DeviceSpec's, not the TPU vector unit's
    t_c = ma["solve_gflops"] * 1e9 / H100["peak_flops_f32"]
    t_m = ma["solve_mbytes"] * 1e6 / H100["hbm_bytes_per_s"]
    assert ma["solve_roofline_ms"] == max(t_c, t_m) * 1e3
    assert ma["peak_tflops_f32"] == 67.0
    for s in (1e-3, 0.0123, 1.0):
        assert roofline.efficiency(s, a) == jax_roofline.efficiency(s, b)


def test_device_spec_is_the_h100():
    dev = roofline.DeviceSpec()
    assert dev.name == "NVIDIA H100 80GB HBM3"
    assert (dev.peak_flops_f32, dev.hbm_bytes_per_s) == (67e12, 3.35e12)
    acct = roofline.solve_accounting(4096, 29, n_iters=5.0)
    assert roofline.efficiency(acct["solve_roofline_ms"] / 1e3, acct) == 1.0


def test_phase_timers_have_the_jax_summary():
    """`PhaseTimers.summary()` has the JAX package's structure: per phase
    total_s, count and mean_ms."""
    ours, theirs = PhaseTimers(), JaxPhaseTimers()
    for t in (ours, theirs):
        for name in ("fit", "solve", "fit"):
            with t.phase(name):
                pass
    a, b = ours.summary(), theirs.summary()
    assert list(a) == list(b) == ["fit", "solve"]
    for name in a:
        assert set(a[name]) == set(b[name]) == {"total_s", "count",
                                                "mean_ms"}
        assert a[name]["count"] == b[name]["count"]
        assert a[name]["mean_ms"] == pytest.approx(
            a[name]["total_s"] / a[name]["count"] * 1e3)


def test_device_trace_writes_a_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir)) as prof:
        torch.ones(64).cumsum(0).sum()
    path = log_dir / "trace.json"
    assert path.is_file()
    assert "traceEvents" in json.loads(path.read_text())
    assert len(prof.key_averages()) > 0


# bench.py::kernel_verify's keys (bench.py:155-176)
VERIFY_KEYS = {"batch", "max_du", "max_rel_dcost", "conv_match_frac",
               "iters_match_frac", "flip_or_oneside_frac",
               "mean_iters_mega_xla", "ok"}
CFG = SolverConfig(n_steps=30, max_sqp_iters=12, ls_iters=4, ddp=True,
                   tol_grad=1e-4)


def test_kernel_verify_on_the_cpu():
    """K1's plain version against the XLA lane path, N=30, B=256, at the
    gates; a single pass reports no compaction."""
    p = MPCParams().astype(torch.float32)
    out = bench_cuda.kernel_verify(p, CFG, torch.float32, batch=256,
                                   device="cpu")
    assert VERIFY_KEYS <= set(out)
    assert "compact_engaged" not in out
    assert out["ok"], out
    assert out["batch"] == 256 and out["conv_match_frac"] == 1.0


def test_kernel_verify_reads_compaction_from_the_counters():
    """At N=48 (auto -> compact) B=256 is the smallest batch whose tail (one
    128-lane tile) is smaller than the batch: the counters show two passes
    and the check holds the compact rule (~5 s on one thread)."""
    from mpc_ros_tpu_torch.kernels import solve_mega

    p = MPCParams().astype(torch.float32)
    cfg = SolverConfig(n_steps=48, max_sqp_iters=22, ls_iters=4, ddp=True,
                       tol_grad=1e-4)
    assert solve_mega.compact_n_tail(128, cfg) == 128
    out = bench_cuda.kernel_verify(p, cfg, torch.float32, batch=256,
                                   expect_compact=True, device="cpu")
    assert out["compact_engaged"] is True and out["tail_lanes"] == 128
    assert out["ok"], out


# bench.py's JSON keys per mode, less `vs_baseline`, with the tunnel keys
# renamed for the fetch floor
MAIN_KEYS = {"metric", "value", "unit", "batch", "device", "compile_s",
             "best_batch_s", "pipeline", "steady_ms_per_batch",
             "converged_frac", "mean_sqp_iters", "p50_single_solve_ms",
             "p99_single_solve_ms", "p50_planner_cycle_ms",
             "p99_planner_cycle_ms", "fetch_floor_ms_p50",
             "fetch_floor_ms_p99", "solve_net_of_floor_ms", "latency_stalls",
             "p99_net_of_stalls_ms", "iters_pcts", "iters_max",
             "unconverged_ppm"}
MODES = {
    "": (MAIN_KEYS, "nmpc_solves_per_s_n30"),
    "--serving": ({"metric", "value", "unit", "batch", "n_cycles", "device",
                   "compile_s", "mean_sqp_iters_warm"},
                  "mpc_serving_cycles_per_s_n30"),
    "--sweep": ({"metric", "value", "unit", "total_solves",
                 "n_weight_candidates", "device", "compile_s", "sweep_s",
                 "best_candidate", "best_mean_terminal_cte",
                 "mean_iters_min_max"}, "mc_tuning_sweep_solves_per_s_n30"),
    "--fleet": ({"metric", "value", "unit", "batch", "device", "compile_s",
                 "cycle_ms_p50", "cycle_ms_p99", "converged_frac"},
                "fleet_serving_robot_cycles_per_s_n20_device"),
    "--fleet-trajectory": ({"metric", "value", "unit", "batch", "device",
                            "compile_s", "cycle_ms_p50", "cycle_ms_p99"},
                           "fleet_trajectory_robot_cycles_per_s_n20"),
}


def _run(*args, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(ROOT / "bench_cuda.py"),
                           *args], capture_output=True, text=True,
                          timeout=timeout, cwd=str(ROOT), env=env)


@pytest.mark.parametrize("mode", list(MODES), ids=lambda m: m or "default")
def test_quick_mode_prints_one_json_line(mode):
    r = _run("--quick", "--repeats", "1", "--pipeline", "1",
             *([mode] if mode else []))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, r.stdout
    out = json.loads(lines[0])
    keys, metric = MODES[mode]
    assert keys <= set(out), keys - set(out)
    assert "vs_baseline" not in out
    assert out["metric"] == metric and out["device"] == "cpu"
    assert out["value"] > 0


def test_grid_obstacles_name_their_item():
    """The grid flags parse as bench.py's (bench.py:226-236): spline_coeff
    by default, the three samplings, an unknown one refused; the runs
    themselves are tests/test_torch_costmap_planners.py's."""
    args = bench_cuda.parse_args(["--obstacles-grid"])
    assert args.obstacles_grid and args.grid_sampling == "spline_coeff"
    for s in ("spline", "spline_coeff", "bilinear"):
        assert bench_cuda.parse_args(["--grid-sampling", s]).grid_sampling \
            == s
    r = _run("--quick", "--obstacles-grid", "--grid-sampling", "bicubic",
             timeout=120)
    assert r.returncode != 0 and "invalid choice" in r.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_no_card_without_quick_exits_non_zero():
    r = _run("--repeats", "1", timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not r.stdout.strip()


def test_bench_and_port_import_no_jax():
    """In a fresh interpreter whose import of jax or of the JAX package
    fails, bench_cuda.py, chip_smoke.py and every port module import, and
    no jax module is loaded."""
    code = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "mpc_ros_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)
import mpc_ros_tpu_torch
for m in pkgutil.walk_packages(mpc_ros_tpu_torch.__path__,
                               "mpc_ros_tpu_torch."):
    importlib.import_module(m.name)
import bench_cuda, chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "mpc_ros_tpu")]
print("ok")
""".replace("ROOT", repr(str(ROOT)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "ok"
