"""Build and load the hand-written CUDA kernels.

Each kernel source under `csrc/` is compiled with `nvcc` for sm_90a into
a shared library with a plain C interface, loaded with `ctypes`. Builds go
to `build/kernels/` at the repository root, named by the kernel, its
variant and a hash of its own `.cu` file, the shared headers (`COMMON`)
and the flags, so an unchanged source is compiled once. A kernel may be a
template: each build instantiates one variant of it (`Kernel.flags` turns
the variant tuple into `-D` macros), and `build_many` compiles several
(kernel, variant) pairs at once, one `nvcc` process each, all started
together.

Nothing is compiled at import time: the first `load` of a variant builds
it. A `load` that compiles or opens a library is the span `kernels.build`
(`obs.span`); a lookup of one already loaded opens none.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

from ..obs.timers import span

CSRC = Path(__file__).resolve().parent / "csrc"
COMMON = ("tiles.cuh", "async_copy.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@dataclasses.dataclass(frozen=True)
class Kernel:
    """One kernel source: its file, its C launcher's name and ctypes
    signature (every launcher returns the int `cudaGetLastError()`), and
    the nvcc macros of a variant."""

    source: str
    entry: str
    argtypes: tuple
    flags: Callable[[tuple], list]


_MEGA_MACROS = ("TILE_EXIT", "BLOBS", "SETP", "BICYCLE")


def _mega_flags(variant) -> list:
    n_ls, ddp, fast, adaptive, *flags = variant
    # no a*b + c contracted into an FMA: every product and sum rounds as
    # in the plain version (solve_mega_plain), operation for operation
    return ["-fmad=false", f"-DMEGA_NLS={int(n_ls)}", f"-DMEGA_DDP={int(bool(ddp))}",
            f"-DMEGA_FAST={int(bool(fast))}",
            f"-DMEGA_ADAPT={int(bool(adaptive))}"] + [
        f"-DMEGA_{m}={int(bool(f))}"
        for m, f in zip(_MEGA_MACROS, flags, strict=True)]


KERNELS = {
    # variant (n_ls, ddp, fast trig, adaptive weight scale, tile exit,
    # blobs, per-knot setpoints, bicycle)
    "solve_mega": Kernel(
        "solve_mega.cu", "mpc_solve_mega_f32",
        (_P,) * 27 + (_I,) * 8 + (_F,) * 7 + (_I,) * 8 + (_P,),
        _mega_flags),
    # variant () — one instantiation
    "backward_fused": Kernel(
        "backward_fused.cu", "mpc_backward_fused_f32",
        (_P,) * 14 + (_I,) * 3 + (_F,) + (_P,),
        lambda variant: []),
    # variant (n_alpha,)
    "forward": Kernel(
        "forward.cu", "mpc_forward_f32",
        (_P,) * 15 + (_I,) * 3 + (_F,) + (_I,) + (_P,),
        lambda variant: [f"-DFWD_NALPHA={int(variant[0])}"]),
}

_LIBS: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    nvcc on PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc")
    return found


def _flags(kernel: str, variant) -> list:
    return list(NVCC_FLAGS) + KERNELS[kernel].flags(tuple(variant))


def lib_path(kernel: str, variant) -> Path:
    h = hashlib.sha256()
    for name in (KERNELS[kernel].source,) + COMMON:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(_flags(kernel, variant)).encode())
    tag = "_".join(str(int(v)) for v in variant) or "0"
    return BUILD_DIR / f"{kernel}_{tag}_{h.hexdigest()[:16]}.so"


def _start(kernel: str, variant):
    out = lib_path(kernel, variant)
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(kernel, variant),
           str(CSRC / KERNELS[kernel].source), "-o", str(tmp)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp, cmd)


def _finish(out, job) -> str:
    proc, tmp, cmd = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return log


def build_many(pairs) -> dict:
    """Compile the given (kernel, variant) pairs concurrently (one nvcc
    each). Returns {(kernel, variant): (seconds, ptxas summary lines)}; a
    pair already built reports 0 seconds and its saved log."""
    t0 = time.perf_counter()
    jobs = {(k, tuple(v)): _start(k, v) for k, v in pairs}
    res = {}
    for key, (out, job) in jobs.items():
        log = (out.with_suffix(".log").read_text() if job is None
               else _finish(out, job))
        res[key] = (0.0 if job is None else time.perf_counter() - t0,
                    ptxas_summary(log))
    return res


def ptxas_summary(log: str) -> list:
    """The register / spill lines of `-Xptxas -v` output."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def load(kernel: str, variant=()):
    """The ctypes launcher of one kernel variant, built at first use."""
    key = (kernel, tuple(variant))
    fn = _LIBS.get(key)
    if fn is not None:
        return fn
    with span("kernels.build"):
        out, job = _start(*key)
        if job is not None:
            _finish(out, job)
        lib = ctypes.CDLL(str(out))
    spec = KERNELS[kernel]
    fn = getattr(lib, spec.entry)
    fn.argtypes = list(spec.argtypes)
    fn.restype = ctypes.c_int
    lib.mpc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mpc_cuda_error_string.restype = ctypes.c_char_p
    fn.lib = lib
    _LIBS[key] = fn
    return fn


def check(fn, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (or a variant mismatch)."""
    if err != 0:
        msg = fn.lib.mpc_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {err}: {msg}")
