"""Checkpoint and resume of long sweeps and serving state (counterpart of
`mpc_ros_tpu/obs/checkpoint.py`), on `torch.save` / `torch.load`:

* sweep checkpoints: the weight candidates and the statistics of a tuning
  run so far, so a long sweep resumes at its last completed chunk;
* serving state: a receding-horizon fleet's warm-start bank and plant
  states, so a restarted server resumes warm.

The JAX package stores through orbax, which is JAX-only, so the files
differ; the states restored do not. A checkpoint is a directory holding
`state.pt`, replaced atomically. Every array leaf (tensor or numpy) is
stored as a CPU tensor and restored as one; dicts, lists, tuples and
Python numbers keep their structure.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

_FILE = "state.pt"


def _to_tensors(x):
    """The state with every array leaf a CPU tensor."""
    if isinstance(x, dict):
        return {k: _to_tensors(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_tensors(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(x))
    return x


def save_checkpoint(path: str, state: Any) -> None:
    """Persist a tree of arrays at `path` (a directory), atomically
    replacing any checkpoint there: the new state is written whole into a
    sibling `.tmp` directory first and then swapped in, so a preemption
    mid-save leaves the old checkpoint (or its `.old` copy) intact."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    old = path + ".old"
    for d in (tmp, old):
        if os.path.exists(d):
            shutil.rmtree(d)
    os.makedirs(tmp)
    torch.save(_to_tensors(state), os.path.join(tmp, _FILE))
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)       # the new checkpoint goes live
    if os.path.exists(old):
        shutil.rmtree(old)


def restore_checkpoint(path: str) -> Optional[Any]:
    """The tree saved at `path` (its array leaves CPU tensors); the `.old`
    sibling if a crash fell between the two renames of save_checkpoint;
    None if neither exists."""
    path = os.path.abspath(path)
    for d in (path, path + ".old"):
        if os.path.exists(d):
            return torch.load(os.path.join(d, _FILE), weights_only=True)
    return None


def serving_state(zs, warm_us, cycle: int) -> dict:
    """A receding-horizon fleet's resumable state."""
    return {"zs": zs, "warm_us": warm_us, "cycle": np.asarray(cycle)}


def sweep_state(candidates, mean_cost, mean_terminal_cte, converged_frac,
                n_done: int) -> dict:
    """A tuning sweep's resumable state (the candidates, an MPCParams,
    stored as the dict of its leaves)."""
    cand_dict = {f.name: getattr(candidates, f.name)
                 for f in dataclasses.fields(candidates)}
    return {
        "candidates": cand_dict,
        "mean_cost": mean_cost,
        "mean_terminal_cte": mean_terminal_cte,
        "converged_frac": converged_frac,
        "n_done": np.asarray(n_done),
    }
