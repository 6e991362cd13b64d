"""The compact cell (`k1_batch_n48_b131k_compact`) with its tail broken
underneath has to come out as not correct: pass 2 skipped, so the lanes
pass 1 left undone keep their pass-1 iterate, or pass 2's answers
scattered into the wrong lanes.

The lanes that need pass 2 are a few percent of a batch (6 of 256 on the
CPU test's seed, 1.9% of the cell on the card), so the rehearsal judges
every lane of its batch here: a sample of 64 may hold none of them."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

import _bench_env as env
from harness import core

from mpc_ros_tpu_torch.kernels import solve_mega  # noqa: E402

CELL = "k1_batch_n48_b131k_compact"
REAL_TAIL = solve_mega.compact_tail


def _rehearse(seed):
    tiny = dict(env.TINY["batch_solve"])
    tiny["sample_lanes"] = tiny["batch"]
    over = {"config": {"solver": {"backward": "mega"}}, "traffic": tiny}
    return core.run_cell(CELL, seed, 0.3, False, torch.device("cpu"),
                         time.perf_counter(), overrides=over, spec=env.SPEC,
                         log=lambda msg: None)


def _skipped(zT, cT, pp, lb, ub, u0, cfg, plain, blobs=None, refs=None):
    # pass 1 alone: the tail never runs and nothing is scattered back
    return solve_mega._pass(zT, cT, pp, lb, ub, u0,
                            solve_mega.compact_pass1_cfg(cfg), plain,
                            blobs=blobs, refs=refs)


def _misplaced(ins, out1, cfg, blobs=None, refs=None):
    # the tail runs on the right lanes; its answers land one lane over
    tail = REAL_TAIL(ins, out1, cfg, blobs, refs)
    return dataclasses.replace(tail, sel=tail.sel.roll(1))


def test_the_whole_batch_judged_is_correct():
    out = _rehearse(seed=79)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("attr,fault", [("_solve_compact", _skipped),
                                        ("compact_tail", _misplaced)],
                         ids=["pass2_skipped", "scatter_misplaced"])
def test_a_broken_tail_is_not_correct(attr, fault, monkeypatch):
    monkeypatch.setattr(solve_mega, attr, fault)
    out = _rehearse(seed=79)
    assert out["correct"] is False, out["checks"]
    if attr == "_solve_compact":
        # the undone lanes report unconverged: the cell's own limit on the
        # converged flags sees them, whatever the gaps' percentiles do
        c = out["checks"]["conv_mismatch"]
        assert c["value"] > c["limit"], c
