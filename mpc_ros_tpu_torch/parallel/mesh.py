"""Device meshes (counterpart of `mpc_ros_tpu/parallel/mesh.py`).

A JAX `Mesh` is a single-controller grid over the process's devices. Here
a `Mesh` is an (n_data, n_time) grid of this process's `torch.device`s:

* `data` — the scenario batch is split into n_data contiguous row blocks,
  one per grid row;
* `time` — the horizon of the associative-scan Riccati is split into
  n_time contiguous blocks over a row's devices (`sharded.py`).

A grid may name one device more than once: `[cpu] * 8` is the counterpart
of the JAX tests' 8 virtual CPU devices, and `[cuda:0] * 2` exercises a
sharded path on one card. Each shard on a CUDA device runs on a CUDA
stream of its own (`Mesh.on`). Across processes the data axis spans the
`torch.distributed` group that `multihost.init_multihost` made; the time
axis stays inside one process, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

DATA_AXIS = "data"
TIME_AXIS = "time"


@dataclasses.dataclass(frozen=True)
class Partition:
    """How a tensor lies on a mesh: split along its leading axis over the
    data axis (`axis=DATA_AXIS`), or replicated (`axis=None`); the names
    of `jax.sharding.NamedSharding` for a reader to find."""

    mesh: "Mesh"
    axis: Optional[str] = DATA_AXIS


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """An (n_data, n_time) grid of devices of this process, the axis names
    and the process group of a multi-process run (None in one process)."""

    devices: tuple                       # n_data tuples of n_time devices
    axis_names: tuple = (DATA_AXIS, TIME_AXIS)
    group: object = None
    _streams: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices),
                TIME_AXIS: len(self.devices[0])}

    @property
    def n_data(self) -> int:
        return len(self.devices)

    @property
    def n_time(self) -> int:
        return len(self.devices[0])

    def data_devices(self) -> list:
        """The device of each data shard (the first of its grid row)."""
        return [row[0] for row in self.devices]

    def stream(self, i: int, j: int = 0):
        """The CUDA stream of grid entry (i, j), made at first use (None on
        other devices)."""
        dev = self.devices[i][j]
        if dev.type != "cuda":
            return None
        if (i, j) not in self._streams:
            self._streams[(i, j)] = torch.cuda.Stream(dev)
        return self._streams[(i, j)]

    @contextlib.contextmanager
    def on(self, i: int, j: int = 0):
        """Run the block as grid entry (i, j): on its own stream for a CUDA
        device, ordered after the work already queued on the device's
        current stream; leaving the block orders that stream after the
        block's work."""
        s = self.stream(i, j)
        if s is None:
            yield
            return
        cur = torch.cuda.current_stream(s.device)
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            yield
        cur.wait_stream(s)


def _visible_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a mesh defaults to the visible cards; pass "
            "devices=[torch.device('cpu')] * n to build one on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_time: int = 1,
              devices=None) -> Mesh:
    """Build a (data, time) mesh. Defaults to every visible CUDA device on
    the data axis (pure scenario parallelism); raises without a card
    unless `devices` are given. Devices may repeat."""
    devices = _visible_devices() if devices is None else [
        torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_time
    if n_data < 1 or n_data * n_time > len(devices):
        raise ValueError(f"a {n_data} x {n_time} mesh needs "
                         f"{n_data * n_time} devices, got {len(devices)}")
    grid = tuple(tuple(devices[i * n_time:(i + 1) * n_time])
                 for i in range(n_data))
    group = None
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        group = torch.distributed.group.WORLD
    return Mesh(grid, group=group)


def batch_sharding(mesh: Mesh) -> Partition:
    """Leading-axis split of a scenario batch over the data axis."""
    return Partition(mesh, DATA_AXIS)


def replicated(mesh: Mesh) -> Partition:
    return Partition(mesh, None)
