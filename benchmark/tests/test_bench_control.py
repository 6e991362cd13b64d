"""The comparison's control: the plain reference in bfloat16, put in the
program's place (`harness.controls`), has to come out as not correct,
on the CPU at the rehearsal's size and, on the card, at the cell's own
size on three seeds."""

from __future__ import annotations

import time

import pytest

import _bench_env as env
from harness import core
from harness.controls import control_for


def _under_control(workload, run):
    cell = core.find_cell(env.SPEC, workload)
    cfg, traffic = core.cell_files(env.SPEC, cell)
    with control_for(traffic["entry"], cfg):
        return run()


@pytest.mark.parametrize("workload", env.workloads())
def test_the_bfloat16_reference_is_not_correct(workload):
    out = _under_control(workload, lambda: env.rehearse(workload, seed=41))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", env.workloads())
def test_the_bfloat16_reference_is_not_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size")
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        out = _under_control(workload, lambda: core.run_cell(
            workload, seed, 4.0, False, torch.device("cuda", 0),
            time.perf_counter(), spec=env.SPEC))
        assert out["correct"] is False, out["checks"]
