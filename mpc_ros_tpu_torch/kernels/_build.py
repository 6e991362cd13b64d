"""Build and load the hand-written CUDA kernels.

Each kernel source under `csrc/` is compiled with `nvcc` for sm_90a into
a shared library with a plain C interface, loaded with `ctypes`. Builds go
to `build/kernels/` at the repository root, named by a hash of the sources
and flags, so an unchanged source is compiled once. The solve kernel is a
template on (n_ls, ddp, fast trig, adaptive weight scale); each build
instantiates one such variant, and `build_many` compiles several at once,
one `nvcc` process each.

Nothing is compiled at import time: the first `load` of a variant builds
it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("solve_mega.cu", "tiles.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def _variant_flags(variant) -> list:
    n_ls, ddp, fast, adaptive = variant
    return [f"-DMEGA_NLS={int(n_ls)}", f"-DMEGA_DDP={int(bool(ddp))}",
            f"-DMEGA_FAST={int(bool(fast))}",
            f"-DMEGA_ADAPT={int(bool(adaptive))}"]


def lib_path(variant) -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    flags = list(NVCC_FLAGS) + _variant_flags(variant)
    h.update(" ".join(flags).encode())
    tag = "_".join(str(int(v)) for v in variant)
    return BUILD_DIR / f"solve_mega_{tag}_{h.hexdigest()[:16]}.so"


def _start(variant):
    out = lib_path(variant)
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *_variant_flags(variant),
           str(CSRC / "solve_mega.cu"), "-o", str(tmp)]
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


def build_many(variants) -> dict:
    """Compile the given variants concurrently (one nvcc each). Returns
    {variant: (seconds, ptxas summary lines)}; a variant already built
    reports 0 seconds and its saved log."""
    t0 = time.perf_counter()
    jobs = {v: _start(v) for v in variants}
    res = {}
    for v, (out, job) in jobs.items():
        log = (out.with_suffix(".log").read_text() if job is None
               else _finish(out, job))
        res[v] = (0.0 if job is None else time.perf_counter() - t0,
                  ptxas_summary(log))
    return res


def ptxas_summary(log: str) -> list:
    """The register / spill lines of `-Xptxas -v` output."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def load(variant):
    """The ctypes library of one kernel variant, built at first use."""
    variant = tuple(variant)
    lib = _LIBS.get(variant)
    if lib is not None:
        return lib
    out, job = _start(variant)
    if job is not None:
        _finish(out, job)
    lib = ctypes.CDLL(str(out))
    fn = lib.mpc_solve_mega_f32
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.mpc_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mpc_cuda_error_string.restype = ctypes.c_char_p
    _LIBS[variant] = lib
    return lib


def error_string(lib, err: int) -> str:
    return f"{err}: {lib.mpc_cuda_error_string(err).decode()}"
