"""Puts a cell's control (`reference.control`: the plain reference in
bfloat16) in the program's place for one run, for the limit readings
(`tools/readings.py`) and the benchmark's tests. The benchmark's own runs
never do."""

from __future__ import annotations

import contextlib
import importlib

import torch

from reference import control


@contextlib.contextmanager
def control_for(entry: str, cfg: dict, dtype=torch.bfloat16):
    """Within the block the cell's control stands in for the program's
    entry that the cell's driver (`entry`) calls."""
    mod_name, attr, make = control.STAND_INS[entry]
    mod = importlib.import_module(mod_name)
    real = getattr(mod, attr)
    setattr(mod, attr, make(cfg, dtype))
    try:
        yield
    finally:
        setattr(mod, attr, real)
