"""BENCHMARK.json against the benchmark's contract: its keys, names and
units, and every file a cell, a traffic mix or a metric is found by."""

from __future__ import annotations

import re

import _bench_env as env
from harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = env.SPEC


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_entries():
    spec = SPEC
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert (env.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


def test_cells_find_their_files():
    spec = SPEC
    configs = {c["name"]: c for c in spec["configs"]}
    used = set()
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        cfg, traffic = core.cell_files(spec, w)
        used.add(w["config"])
        assert cfg["name"] == w["config"]
        assert (env.BENCH / "drivers" / f"{traffic['entry']}.py").is_file()
        assert set(traffic["limits"]) and all(
            v > 0 for v in traffic["limits"].values())
        e2e = core.cell_metrics(spec, w, False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert core.cell_metrics(spec, w, True)
    assert used == set(configs)
    for c in spec["configs"]:
        assert c["file"].startswith("benchmark/configs/")
        cfg = core.load_json(env.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"]


def test_subseeds_are_stable_for_large_seeds():
    s = 2 ** 31 + 12345
    assert core.subseed(s, "pool", 0) == core.subseed(s, "pool", 0)
    assert core.subseed(s, "pool", 0) != core.subseed(s, "pool", 1)
    assert 0 <= core.subseed(2 ** 33, "x") < 2 ** 63
