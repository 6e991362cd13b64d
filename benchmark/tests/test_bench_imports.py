"""Nothing a run imports is JAX or the JAX package, compared by whole
top-level names (the port's own name, `mpc_ros_tpu_torch`, begins with
the JAX package's); and run.py refuses to run where it cannot."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import _bench_env as env
from harness import core

REHEARSE_ALL = """
import json, sys
sys.path.insert(0, {tests!r})
import _bench_env as env
for w in env.workloads():
    env.rehearse(w, traced=True)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def test_a_rehearsal_loads_neither_jax_nor_the_jax_package():
    p = subprocess.run(
        [sys.executable, "-c",
         REHEARSE_ALL.format(tests=str(env.BENCH / "tests"))],
        cwd=env.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "mpc_ros_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "mpc_ros_tpu"}


def test_the_check_compares_whole_top_level_names(monkeypatch):
    for name in ("jax.numpy", "mpc_ros_tpu.solver", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name.split(".")[0] in core.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "mpc_ros_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert not set(core.forbidden_modules()) & {"mpc_ros_tpu_torch_extra",
                                                 "jaxtyping"}


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         env.workloads()[0], "--seed", "3", "--seconds", "1", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    p = _run(env.ROOT)
    assert p.returncode != 0
    assert not p.stdout.strip()


def test_no_result_beside_nothing_but_the_benchmark(tmp_path):
    shutil.copy(env.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(env.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert not p.stdout.strip()
