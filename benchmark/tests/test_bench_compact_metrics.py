"""The per-layer metrics of the compact cell (`k1_batch_n48_b131k_compact`)
on hand-made traces and records: K1's launches split by their TILE_EXIT
template flag, K3's ops by the program's `k1.schedule` span, the tail by
`k1.tail`, the schedule's counters read from the program's module, K3's
frozen byte count by hand, and None untraced or where the program has no
such span or counter (a parent tree, or a CPU rehearsal)."""

from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

import _bench_env as env
from frozen import k3_bytes, roofline
from harness import compact, core
from harness.trace import Trace

CELL = "k1_batch_n48_b131k_compact"
NEW = ("k1.pass1_ms_per_call.compact", "k1.tail_ms_per_call.compact",
       "k3.device_ms_per_call.compact", "k3_roofline.compact",
       "compact.tail_need_frac.compact",
       "dispatch.k1_host_ms_per_call.compact")
# the batch cell's metrics that read the compact cell as they are
SHARED = ("k1_roofline.batch", "solver.iters_per_solve.batch",
          "device_idle_frac.batch", "dispatch.host_ms_per_call.batch")
PROGRAM = "mpc_ros_tpu_torch.kernels.solve_mega"


def _k1(tile_exit):
    flag = "true" if tile_exit else "false"
    return (f"void mega::solve_mega_kernel<4, true, true, true, {flag}, "
            "false, false, false, false>(mega::Args)")


def _reader(name):
    return core.load_module(env.BENCH / "metrics" / f"{name}.py",
                            "bench_metric_" + name.replace(".", "_"))


def _record(ops, spans, calls=2, window=(0.0, 1.0)):
    """A traced record of the cell: ops as (name, start, end, launched)
    device intervals, spans as (name, start, end) host ranges, seconds."""
    cfg, traffic = core.cell_files(env.SPEC, core.find_cell(env.SPEC, CELL))
    trace = Trace([(n, a, b - a, t) for n, a, b, t in ops], spans, window)
    return core.Record(window_s=window[1] - window[0], attempted=calls,
                       failed=0, trace=trace, cfg=cfg, traffic=traffic,
                       counts={"calls": calls, "solves": calls * 131072,
                               "lane_iterations": calls * 131072 * 7})


# two calls: pass 1 (TILE_EXIT set, 0.2 s), K3's gather (0.01 s), the tail
# (0.05 s) and K3's scatter (0.02 s) each, and one op outside every span
SPANS = [("k1.schedule", 0.10, 0.11), ("k1.tail", 0.11, 0.12),
         ("k1.schedule", 0.12, 0.13), ("k1.schedule", 0.50, 0.51),
         ("k1.tail", 0.51, 0.52), ("k1.schedule", 0.52, 0.53)]
OPS = [(_k1(True), 0.10, 0.30, 0.095),
       ("argsort_and_gather", 0.30, 0.31, 0.105),
       (_k1(False), 0.31, 0.36, 0.115),
       ("index_copy", 0.36, 0.38, 0.125),
       (_k1(True), 0.50, 0.70, 0.495),
       ("argsort_and_gather", 0.70, 0.71, 0.505),
       (_k1(False), 0.71, 0.76, 0.515),
       ("index_copy", 0.76, 0.78, 0.525),
       ("lane_inputs", 0.80, 0.81, 0.49)]


def test_the_new_cell_and_metrics_are_in_the_spec():
    spec = env.SPEC
    cell = core.find_cell(spec, CELL)
    assert cell["config"] == "ref_nlp_n48_compact" and cell["chips"] == 1
    assert env.entry_of(CELL) == "batch_solve"
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        assert per_layer[name]["workloads"] == [CELL]
        assert per_layer[name]["moves"] == "solves_per_s"
    for name in SHARED:
        assert per_layer[name]["workloads"] == ["k1_batch_n30_b524k", CELL]
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["solves_per_s"]["workloads"] == ["k1_batch_n30_b524k", CELL]
    cfg, _ = core.cell_files(spec, cell)
    s = cfg["solver"]
    assert (s["n_steps"], s["max_sqp_iters"], s["schedule"]) == (48, 22,
                                                                "auto")


@pytest.mark.parametrize("name,flag", [(_k1(True), True),
                                       (_k1(False), False),
                                       ("solve_mega_kernel<4, 1, 1, 1, 1>",
                                        True),
                                       ("solve_mega_kernel", None),
                                       ("solve_mega_retile<4, true, true, "
                                        "true, false, false, false>", None),
                                       ("index_copy", None)])
def test_tile_exit_is_the_fifth_template_argument(name, flag):
    assert compact.tile_exit(name) is flag


def test_pass1_and_tail_split_by_tile_exit():
    """Pass 1 is every TILE_EXIT launch, the tail every other K1 launch
    inside `k1.tail`: 0.2 s and 0.05 s per call."""
    rec = _record(OPS, SPANS)
    assert _reader(NEW[0]).read(rec) == pytest.approx(200.0)
    assert _reader(NEW[1]).read(rec) == pytest.approx(50.0)


def test_k3_is_what_k1_schedule_launched():
    """The gather and the scatter launched inside `k1.schedule` (0.03 s per
    call); K1 and the op launched outside every span are not K3's."""
    rec = _record(OPS, SPANS)
    assert _reader(NEW[2]).read(rec) == pytest.approx(30.0)
    need = k3_bytes.k3_bytes(48, 131072, 0.06)["total"]
    want = 100.0 * need / roofline.PEAK_BYTES_PER_S / 0.03
    assert _reader(NEW[3]).read(rec) == pytest.approx(want)


def test_k1_roofline_counts_both_passes():
    rec = _record(OPS, SPANS)
    bound, _ = roofline.roofline_s(2 * 131072 * 7, 2 * 131072, 47, 4, True)
    assert _reader(SHARED[0]).read(rec) == pytest.approx(
        100.0 * bound / 0.5)


def test_k3_bytes_by_hand_at_the_cells_shape():
    """N=48 (T=47), B=131,072, compact_tail 0.06: a tail of 62 tiles."""
    got = k3_bytes.k3_bytes(48, 131072, 0.06, n_coeffs=4)
    tail = 62 * 128
    assert got["tail_lanes"] == tail == 7936
    # done flags read, the tail's indices written
    assert got["select"] == 131072 * 4 + 7936 * 4 == 556032
    # (6 + 4 + 12 + 2 + 2 + 94 + 4) rows read and written, indices read
    assert got["gather"] == 2 * 7936 * 124 * 4 + 7936 * 4 == 7904256
    # (384 + 94 + 6) rows read and written, pass 1's iterations read,
    # indices read
    assert got["scatter"] == (2 * 7936 * 484 * 4 + 7936 * 4
                              + 7936 * 4) == 30791680
    assert got["total"] == 556032 + 7904256 + 30791680
    assert k3_bytes.tail_lanes(256, 0.06) == 128
    assert k3_bytes.tail_lanes(64, 0.06) == 128


def test_tail_need_frac_reads_the_programs_counters(monkeypatch):
    rec = _record(OPS, SPANS)
    monkeypatch.setitem(sys.modules, PROGRAM, SimpleNamespace(
        need_total=lambda: 1488, tail_lanes=7936 * 3))
    assert _reader(NEW[4]).read(rec) == pytest.approx(1488 / 23808)


@pytest.mark.parametrize("program", [
    None, SimpleNamespace(tail_lanes=7936),
    SimpleNamespace(need_total=lambda: 0, tail_lanes=0)],
    ids=["not_loaded", "no_counter", "no_compact_call"])
def test_tail_need_frac_is_none_without_the_counter(program, monkeypatch):
    if program is None:
        monkeypatch.delitem(sys.modules, PROGRAM, raising=False)
    else:
        monkeypatch.setitem(sys.modules, PROGRAM, program)
    assert _reader(NEW[4]).read(_record(OPS, SPANS)) is None


def test_iterations_and_idle():
    rec = _record(OPS, SPANS)
    assert _reader(SHARED[1]).read(rec) == pytest.approx(7.0)
    busy = 0.2 + 0.01 + 0.05 + 0.02
    assert _reader(SHARED[2]).read(rec) == pytest.approx(
        1.0 - 2 * busy - 0.01)


@pytest.mark.parametrize("name", NEW + SHARED[:1] + SHARED[2:])
def test_none_untraced(name):
    untraced = core.Record(window_s=1.0, attempted=1, failed=0,
                           counts={"calls": 1, "solves": 131072})
    assert _reader(name).read(untraced) is None


@pytest.mark.parametrize("name", NEW[1:4])
def test_none_without_the_programs_spans(name):
    """A program without `k1.tail` (the parent of this cell) has no tail
    to read, and one without `k1.schedule` no K3."""
    keep = "k1.tail" if name in NEW[2:4] else "k1.schedule"
    rec = _record(OPS, [s for s in SPANS if s[0] == keep])
    assert _reader(name).read(rec) is None


def test_none_where_no_k1_launch_names_its_pass():
    """A CPU rehearsal's trace holds the plain version's operators, and no
    kernel names its template arguments."""
    ops = [("aten::mul", 0.1, 0.2, 0.1), ("solve_mega_kernel", 0.3, 0.4,
                                          0.3)]
    rec = _record(ops, SPANS)
    for name in NEW[:2]:
        assert _reader(name).read(rec) is None


def test_k1_host_ms_per_call_sums_both_launches():
    """Two calls, each a pass-1 `k1.dispatch` of 1 ms and a tail one of
    0.5 ms inside `k1.tail`; a third launch straddles the window's end and
    counts up to it: (2 x 1.5 ms + 0.25 ms) over 2 calls."""
    spans = SPANS + [("k1.dispatch", 0.090, 0.091),
                     ("k1.dispatch", 0.1100, 0.1105),
                     ("k1.dispatch", 0.490, 0.491),
                     ("k1.dispatch", 0.5100, 0.5105),
                     ("k1.dispatch", 0.99975, 1.001)]
    rec = _record(OPS, spans)
    assert _reader(NEW[5]).read(rec) == pytest.approx(3.25 / 2)
    assert _reader(NEW[5]).read(_record(OPS, SPANS)) is None
