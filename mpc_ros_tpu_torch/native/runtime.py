"""ctypes bindings for the native runtime (counterpart of
`mpc_ros_tpu/native/runtime.py`; `runtime.cc` is the same source).

`get_lib` builds `libmpcrt.so` with `g++ -O2 -std=c++17 -shared -fPIC` at
first use into `build/native/` at the repository root, named by a hash of
the source and the flags (as `kernels/_build.py` names its kernels), so an
unchanged source is compiled once and nothing is written beside the
source. All classes are also usable as context managers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "runtime.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the build of the current source goes."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libmpcrt_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    so.parent.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                   capture_output=True)
    os.replace(tmp, so)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        # topics
        lib.topic_create.restype = ctypes.c_void_p
        lib.topic_create.argtypes = [ctypes.c_uint32]
        lib.topic_destroy.argtypes = [ctypes.c_void_p]
        lib.topic_publish.restype = ctypes.c_int
        lib.topic_publish.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_uint32]
        lib.topic_read.restype = ctypes.c_int
        lib.topic_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint32]
        lib.topic_publish_count.restype = ctypes.c_uint64
        lib.topic_publish_count.argtypes = [ctypes.c_void_p]
        lib.topic_shm_create.restype = ctypes.c_void_p
        lib.topic_shm_create.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
        lib.topic_shm_attach.restype = ctypes.c_void_p
        lib.topic_shm_attach.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.topic_shm_close.argtypes = [ctypes.c_void_p]
        lib.topic_shm_unlink.restype = ctypes.c_int
        lib.topic_shm_unlink.argtypes = [ctypes.c_char_p]
        # rate loop
        lib.rate_create.restype = ctypes.c_void_p
        lib.rate_create.argtypes = [ctypes.c_int64]
        lib.rate_destroy.argtypes = [ctypes.c_void_p]
        lib.rate_sleep.restype = ctypes.c_int64
        lib.rate_sleep.argtypes = [ctypes.c_void_p]
        lib.rate_cycles.restype = ctypes.c_uint64
        lib.rate_cycles.argtypes = [ctypes.c_void_p]
        lib.rate_overruns.restype = ctypes.c_uint64
        lib.rate_overruns.argtypes = [ctypes.c_void_p]
        lib.rate_worst_late_ns.restype = ctypes.c_int64
        lib.rate_worst_late_ns.argtypes = [ctypes.c_void_p]
        # csv
        lib.csv_open.restype = ctypes.c_void_p
        lib.csv_open.argtypes = [ctypes.c_char_p]
        lib.csv_row.restype = ctypes.c_int
        lib.csv_row.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_double, ctypes.c_double,
                                ctypes.c_double, ctypes.c_double]
        lib.csv_close.restype = ctypes.c_int
        lib.csv_close.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int64]
        # plan fit
        dp = ctypes.POINTER(ctypes.c_double)
        lib.plan_fit.restype = ctypes.c_int
        lib.plan_fit.argtypes = [dp, dp, ctypes.c_int,
                                 ctypes.c_double, ctypes.c_double,
                                 ctypes.c_double, ctypes.c_int,
                                 ctypes.c_double, dp, dp, dp,
                                 ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return lib


def plan_fit(plan_xy, pose, order: int, lookahead_frac: float = 0.3):
    """Native per-cycle path fit (see runtime.cc plan_fit): world->robot
    transform + Householder-QR polyfit + cte + 30%-lookahead heading.

    plan_xy: (M, >=2) world waypoints; pose: (x, y, theta).
    Returns (coeffs (order+1,), cte, heading, heading_valid) or None when
    the fit is degenerate (the caller takes the numpy path).
    """
    import numpy as np

    lib = get_lib()
    plan = np.ascontiguousarray(plan_xy, dtype=np.float64)
    xs = np.ascontiguousarray(plan[:, 0])
    ys = np.ascontiguousarray(plan[:, 1])
    n = len(xs)
    coeffs = np.zeros(order + 1, np.float64)
    cte = ctypes.c_double()
    heading = ctypes.c_double()
    valid = ctypes.c_int()
    dp = ctypes.POINTER(ctypes.c_double)
    rc = lib.plan_fit(
        xs.ctypes.data_as(dp), ys.ctypes.data_as(dp), n,
        float(pose[0]), float(pose[1]), float(pose[2]), order,
        lookahead_frac, coeffs.ctypes.data_as(dp),
        ctypes.byref(cte), ctypes.byref(heading), ctypes.byref(valid))
    if rc != 0:
        return None
    return coeffs, float(cte.value), float(heading.value), bool(valid.value)


class Topic:
    """Race-free latest-value topic slot (seqlock).

    The in-process successor of a ROS topic for fixed-size payloads; fixes
    the reference's unsynchronized feedback_vel handoff (SURVEY.md §5.2).
    """

    def __init__(self, capacity: int = 256):
        self._lib = get_lib()
        self._h = self._lib.topic_create(capacity)
        if not self._h:
            raise MemoryError("topic_create failed")
        self.capacity = capacity
        # the C seqlock is single-writer (readers are lock-free and
        # unlimited); ctypes releases the GIL during the call, so two
        # Python publisher threads could otherwise interleave word writes
        # under a stable-looking even sequence — serialize them here
        self._wlock = threading.Lock()

    def publish(self, payload: bytes) -> None:
        buf = ctypes.create_string_buffer(payload, len(payload))
        with self._wlock:
            rc = self._lib.topic_publish(self._h, buf, len(payload))
        if rc != 0:
            raise ValueError("payload exceeds topic capacity")

    def read(self) -> bytes | None:
        buf = ctypes.create_string_buffer(self.capacity)
        n = self._lib.topic_read(self._h, buf, self.capacity)
        if n < 0:
            raise RuntimeError("topic_read failed")
        if n == 0:
            return None
        return buf.raw[:n]

    @property
    def publish_count(self) -> int:
        return int(self._lib.topic_publish_count(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.topic_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class ShmTopic:
    """Cross-PROCESS seqlock topic in POSIX shared memory.

    The real process boundary of the planner node — the role the
    reference's TCPROS pub/sub played for feedback_vel/cmd_vel
    (mpc_ros's src/mpc_planner_ros.cpp:78,122-124) — with
    wait-free latest-value semantics: the robot-side process and the
    planner process publish/read fixed-size payloads with zero
    serialization beyond a word copy. Same interface as `Topic`, so a
    `PlannerNode` wired with ShmTopics serves another OS process
    unchanged (tests/test_torch_native.py).

    One process calls `ShmTopic(name, capacity, create=True)` (and should
    `unlink` at teardown); others attach with `ShmTopic(name)`.
    """

    def __init__(self, name: str, capacity: int = 256,
                 create: bool = False, attach_timeout_ms: int = 2000):
        self._lib = get_lib()
        self.name = name
        self._created = create
        if create:
            self._h = self._lib.topic_shm_create(name.encode(), capacity)
            self.capacity = capacity
        else:
            self._h = self._lib.topic_shm_attach(name.encode(),
                                                 attach_timeout_ms)
            if self._h:
                # capacity is the creator-published readiness word at
                # offset sizeof(atomic u64) in the slot header
                cap = ctypes.c_uint32.from_address(self._h + 8)
                self.capacity = int(cap.value)
        if not self._h:
            raise OSError(f"shm topic {name!r}: "
                          + ("create" if create else "attach") + " failed")
        self._wlock = threading.Lock()

    publish = Topic.publish
    read = Topic.read
    publish_count = Topic.publish_count

    def close(self) -> None:
        if self._h:
            self._lib.topic_shm_close(self._h)
            self._h = None

    def unlink(self) -> None:
        """Remove the shared-memory object name (creator-side teardown)."""
        self._lib.topic_shm_unlink(self.name.encode())

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
        if self._created:
            self.unlink()


class RateLoop:
    """Absolute-deadline control-rate pacing with overrun accounting.

    Successor of move_base's controller_frequency loop, with the deadline
    monitoring the reference lacked (its 0.5 s solver cap silently blows
    the 0.05/0.1 s period — SURVEY.md §6)."""

    def __init__(self, period_s: float):
        self._lib = get_lib()
        self._h = self._lib.rate_create(int(period_s * 1e9))
        if not self._h:
            raise MemoryError("rate_create failed")
        self.period_s = period_s

    def sleep(self) -> float:
        """Sleep until next deadline; returns the previous cycle's overrun
        in seconds (0.0 if it met its deadline)."""
        return self._lib.rate_sleep(self._h) / 1e9

    @property
    def stats(self) -> dict:
        return {
            "cycles": int(self._lib.rate_cycles(self._h)),
            "overruns": int(self._lib.rate_overruns(self._h)),
            "worst_late_ms": self._lib.rate_worst_late_ns(self._h) / 1e6,
        }

    def close(self) -> None:
        if self._h:
            self._lib.rate_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class NativeCsvLogger:
    """Buffered tracking-CSV writer (reference assets/*.csv schema)."""

    def __init__(self, path: str):
        self._lib = get_lib()
        self._h = self._lib.csv_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")

    def row(self, idx: int, cte: float, etheta: float, v: float, w: float):
        self._lib.csv_row(self._h, idx, cte, etheta, v, w)

    def close(self, course_time_s: float = 0.0) -> int:
        """Write the tracking-time footer; returns rows written."""
        if self._h:
            sec = int(course_time_s)
            nsec = int(round((course_time_s - sec) * 1e9))
            rows = self._lib.csv_close(self._h, sec, nsec)
            self._h = None
            return rows
        return 0

    def __enter__(self):
        return self

    def __exit__(self, *a):
        # exception-safe: flush the buffered rows + a zero-time footer if
        # the owner never called close(course_time) itself
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
