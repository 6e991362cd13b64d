"""The single-scenario solve captured as CUDA graphs: the counterpart of the
JAX package's jitted solves (`solver/ilqr.py::solve_jit`,
`planner/tracking.py::_cycle_jit`, `planner/trajectory.py::
_single_cycle_jit`).

Eagerly, one SQP iteration of `ilqr.solve` is ~3,400 small launches from
Python, so a 20-knot single-robot cycle is bound by the host. JAX compiles
the cycle into one program per signature; here a `CapturedSolve` records
it once as three CUDA graphs in one memory pool and replays them:

- the prologue (`ilqr.prepare` after the caller's unpacking: the shifted
  warm start, the clip, the rollout, the first cost);
- one SQP iteration (`ilqr.iterate`, its carry written back in place),
  replayed once per iteration; after each replay the host reads the
  "all done" flag once through a pinned buffer, so `ilqr.host_reads`
  counts what the eager loop counts;
- the epilogue (the caller's packing into static outputs, the new warm
  carry written in place).

Inputs live in static buffers (`inputs`) that `load` fills: a host array
through a pinned staging buffer and one non-blocking copy, a device
tensor by a device copy, skipped while the source is the tensor loaded
last and unwritten since (`Tensor._version`), so a parameter reload or a
new costmap of the same shape is a copy into the captured leaves and no
recapture. A new signature (the config, which optional inputs are
present, their shapes and dtypes, the device) is a new `CapturedSolve`,
as a new signature is a new trace under jit.

The first `run` of a signature on the card is the capture: the cycle runs
eagerly on a side stream (its real result; it also creates the library
handles and fills the solver's constant caches on that stream), then the
three graphs are recorded with `capture_error_mode="thread_local"`, so a
planner node calling from its own thread captures too. A capture or a
replay that fails raises: nothing drops back to the eager loop. On the
CPU there are no graphs and `run` calls the same three bodies directly,
which is how the CPU tests check the buffer protocol.

The horizon-parallel backward (`SolverConfig.horizon_parallel`) reads the
host once per active-set sweep inside an iteration, so a solve with it is
not one graph: `capturable` says so, and its callers run it eagerly.

Spans (`obs.span`): a capture is `graphed.capture`; each run's phases are
`graphed.prologue`, `graphed.body` (once per iteration) and
`graphed.epilogue`, the flag's read `sync.graphed_flag` and an output's
fetch `sync.graphed_fetch`, on the card's replays and the CPU's direct
calls alike. They cost nothing unless a profiler runs or a collector is
installed, and a collector times them without the profiler, which would
record each of an iteration's graph nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..config import MPCParams, SolverConfig
from ..obs.timers import span
from . import ilqr
from .types import SolveResult

# signatures captured in this process (three graphs each)
captures = 0


def capturable(cfg: SolverConfig) -> bool:
    """Whether a solve under `cfg` can be captured: everything but the
    horizon-parallel backward, whose sweeps read the host."""
    return not cfg.horizon_parallel


class CapturedSolve:
    """One signature's solve: static input buffers, and on the card the
    three graphs that read them (see the module docstring).

    `inputs` maps names to the static buffers on `device`;
    `prologue(inputs) -> (ilqr.Problem, ilqr.State)` unpacks them and runs
    `ilqr.prepare`; `epilogue(inputs, prob, st) -> dict` returns the
    outputs (and may write the caller's carry in place)."""

    def __init__(self, cfg: SolverConfig, device, inputs: dict,
                 prologue: Callable, epilogue: Callable):
        self.cfg = cfg
        self.device = torch.device(device)
        self.inputs = inputs
        self._prologue = prologue
        self._epilogue = epilogue
        self._loaded: dict = {}
        self._pinned: dict = {}
        self._graphs = None
        self.outputs: Optional[dict] = None

    # -- the static inputs ---------------------------------------------------

    def load(self, name: str, src) -> None:
        """Copy `src` (a Python number, a numpy array or a tensor) into the
        static input `name`, unless it is the source loaded last and has
        not been written since."""
        buf = self.inputs[name]
        if isinstance(src, (bool, int, float)):
            # a number: a fill kernel, no copy
            last = self._loaded.get(name)
            if not (last is not None and last[0] is type(src)
                    and last[1] == src):
                buf.fill_(src)
                self._loaded[name] = (type(src), src)
            return
        if isinstance(src, np.ndarray):
            src = torch.from_numpy(src)
        last = self._loaded.get(name)
        if last is not None and last[0] is src and last[1] == src._version:
            return
        if buf.is_cuda and not src.is_cuda:
            # a pinned staging buffer and one non-blocking copy (a copy
            # from pageable memory would sync the stream); the event
            # guards the staging buffer until that copy has run
            pin, ev = self._pinned.get(name, (None, None))
            if pin is None:
                pin = torch.empty(buf.shape, dtype=buf.dtype,
                                  pin_memory=True)
                ev = torch.cuda.Event()
                self._pinned[name] = (pin, ev)
            ev.synchronize()
            pin.copy_(src)
            buf.copy_(pin, non_blocking=True)
            ev.record()
        else:
            buf.copy_(src)
        self._loaded[name] = (src, src._version)

    def load_leaves(self, prefix: str, obj) -> None:
        """`load` every leaf of a dataclass of leaves (MPCParams,
        GaussianObstacles, ObstacleMap) into its `prefix.name` buffer."""
        for f in dataclasses.fields(obj):
            key = f"{prefix}.{f.name}"
            if key in self.inputs:
                self.load(key, getattr(obj, f.name))

    # -- running -------------------------------------------------------------

    @staticmethod
    def _body(prob, st):
        """One SQP iteration with its carry written back in place; returns
        the "all done" flag (a device tensor)."""
        st.copy_(ilqr.iterate(prob, st))
        return st.done.all()

    def _eager(self) -> dict:
        """The three bodies called directly, the loop reading the flag
        after each iteration (the first read is known: no lane starts
        done)."""
        with span("graphed.prologue"):
            prob, st = self._prologue(self.inputs)
        flag = None
        for i in range(self.cfg.max_sqp_iters):
            ilqr.host_reads += 1
            if i:
                with span("sync.graphed_flag"):
                    done = bool(flag)
                if done:
                    break
            with span("graphed.body"):
                flag = self._body(prob, st)
        with span("graphed.epilogue"):
            return self._epilogue(self.inputs, prob, st)

    def run(self) -> dict:
        """One solve on the current inputs: the outputs' dict (on the card
        the static outputs, overwritten by the next run)."""
        if self.device.type != "cuda":
            return self._eager()
        if self._graphs is None:
            with span("graphed.capture"):
                return self._capture()
        pro, body, epi = self._graphs
        with span("graphed.prologue"):
            pro.replay()
        for i in range(self.cfg.max_sqp_iters):
            ilqr.host_reads += 1
            if i and self._read_flag():
                break
            with span("graphed.body"):
                body.replay()
        with span("graphed.epilogue"):
            epi.replay()
        return self.outputs

    def _read_flag(self) -> bool:
        with span("sync.graphed_flag"):
            self._flag_host.copy_(self._flag, non_blocking=True)
            self._event.record()
            self._event.synchronize()
            return bool(self._flag_host)

    def _capture(self) -> dict:
        global captures
        dev = self.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = self._eager()
        torch.cuda.current_stream(dev).wait_stream(side)
        pool = torch.cuda.graph_pool_handle()
        graphs = [torch.cuda.CUDAGraph() for _ in range(3)]
        kw = dict(pool=pool, stream=side, capture_error_mode="thread_local")
        with torch.cuda.graph(graphs[0], **kw):
            prob, st = self._prologue(self.inputs)
        with torch.cuda.graph(graphs[1], **kw):
            flag = self._body(prob, st)
        with torch.cuda.graph(graphs[2], **kw):
            outputs = self._epilogue(self.inputs, prob, st)
        # the graphs read and write these addresses: keep them alive
        self._held = (prob, st)
        self._flag = flag
        self._flag_host = torch.empty((), dtype=torch.bool, pin_memory=True)
        self._event = torch.cuda.Event()
        self.outputs = outputs
        self._graphs = graphs
        captures += 1
        return out

    def fetch(self, name: str, t: torch.Tensor) -> np.ndarray:
        """An output on the host as a numpy copy: on the card through a
        pinned buffer and one event sync (the cycle's one fetch)."""
        if not t.is_cuda:
            return t.detach().numpy().copy()
        key = ("out", name)
        pin, ev = self._pinned.get(key, (None, None))
        if pin is None or pin.shape != t.shape or pin.dtype != t.dtype:
            pin = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            ev = torch.cuda.Event()
            self._pinned[key] = (pin, ev)
        pin.copy_(t, non_blocking=True)
        ev.record()
        with span("sync.graphed_fetch"):
            ev.synchronize()
        return pin.numpy().copy()


# -- static buffers of the solver's inputs ------------------------------------

def leaf_signature(obj) -> Optional[tuple]:
    """A dataclass of leaves as a signature: per leaf its name with its
    shape and dtype (a tensor) or its type (anything else); a non-tensor
    field that is not a number (ObstacleMap.sampling) by its value."""
    if obj is None:
        return None
    sig = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            sig.append((f.name, tuple(v.shape), v.dtype))
        elif isinstance(v, (bool, int, float)) or v is None:
            sig.append((f.name, type(v).__name__))
        else:
            sig.append((f.name, v))
    return (type(obj).__name__, tuple(sig))


def leaf_buffers(prefix: str, obj, dtype, device) -> dict:
    """Static buffers for the leaves of a dataclass: a tensor leaf's shape
    and dtype, a number as a 0-d buffer of `dtype`; other fields (None,
    strings) have none and keep their value (`rebuild`)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f"{prefix}.{f.name}"] = torch.empty(v.shape, dtype=v.dtype,
                                                    device=device)
        elif isinstance(v, (bool, int, float)):
            out[f"{prefix}.{f.name}"] = torch.empty((), dtype=dtype,
                                                    device=device)
    return out


def rebuild(prefix: str, template, inputs: dict):
    """The dataclass `template` with its buffered leaves read from
    `inputs`."""
    if template is None:
        return None
    return dataclasses.replace(template, **{
        f.name: inputs[f"{prefix}.{f.name}"]
        for f in dataclasses.fields(template)
        if f"{prefix}.{f.name}" in inputs})


# -- solve_jit ----------------------------------------------------------------

_JIT: dict = {}


def solve_jit(z0, coeffs, p: MPCParams, cfg: SolverConfig, u_init=None,
              omap=None, blobs=None, refs=None):
    """`ilqr.solve` through a `CapturedSolve` per signature (see
    `ilqr.solve_jit`). The inputs are loaded into the signature's static
    buffers (z0's dtype and device); the result's tensors are copies of
    the static outputs. A horizon-parallel config runs `ilqr.solve`
    (`capturable`)."""
    if not capturable(cfg):
        return ilqr.solve(z0, coeffs, p, cfg, u_init, omap, blobs, refs)
    args = {k: None if v is None else torch.as_tensor(v) for k, v in
            dict(z0=z0, coeffs=coeffs, u_init=u_init, refs=refs).items()}
    dtype, dev = args["z0"].dtype, args["z0"].device
    key = (cfg, dtype, str(dev),
           tuple((k, None if v is None else tuple(v.shape))
                 for k, v in args.items()),
           leaf_signature(p), leaf_signature(omap), leaf_signature(blobs))
    entry = _JIT.get(key)
    if entry is None:
        inputs = {k: torch.empty(v.shape, dtype=dtype, device=dev)
                  for k, v in args.items() if v is not None}
        for prefix, obj in (("p", p), ("omap", omap), ("blobs", blobs)):
            if obj is not None:
                inputs.update(leaf_buffers(prefix, obj, dtype, dev))

        def prologue(b):
            return ilqr.prepare(b["z0"], b["coeffs"], rebuild("p", p, b),
                                cfg, b.get("u_init"),
                                rebuild("omap", omap, b),
                                rebuild("blobs", blobs, b), b.get("refs"))

        def epilogue(b, prob, st):
            # copies of the carry (a graph of views alone would be empty)
            r = ilqr.result(prob, st)
            return {f.name: getattr(r, f.name).clone()
                    for f in dataclasses.fields(r)}

        entry = _JIT[key] = CapturedSolve(cfg, dev, inputs, prologue,
                                          epilogue)
    for k, v in args.items():
        if v is not None:
            entry.load(k, v)
    for prefix, obj in (("p", p), ("omap", omap), ("blobs", blobs)):
        if obj is not None:
            entry.load_leaves(prefix, obj)
    out = entry.run()
    return SolveResult(**{k: v.clone() for k, v in out.items()})
