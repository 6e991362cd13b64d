#!/usr/bin/env python3
"""The whole-solve kernel's (K1) design steps, undone one at a time in
copies of this checkout, for timing against it; and K1's registers under
launch bounds.

    python3 tools/k1_variants.py trees build/steps
    python3 tools/compare_k1_builds.py --timing build/parent \\
        build/steps/direct64 build/steps/direct build/steps/wide \\
        build/steps/fma
    python3 tools/k1_variants.py ptxas 1 3        # on the card

`trees OUT` writes copies of the files git would commit (build/ is
ignored) whose K1 differs from this one: `direct` reads the knot rows
straight from device memory instead of through the shared-memory ring
(`k1_direct_loads.patch`); `direct64` does that and addresses rows by
64-bit offsets (the redesign's step 1 alone); `wide` keeps the ring with
64-bit offsets; `fma` builds K1 with FMA contraction (without
-fmad=false). The changes are exact, against this checkout's K1, so a
later edit of the text they touch retires them: the tool stops and names
what it did not find. `ptxas M ...` compiles the K1 variants chip_smoke.py
builds under __launch_bounds__(128, M) for each M and prints each one's
registers and spills (-Xptxas -v); it needs nvcc.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = "mpc_ros_tpu_torch/kernels/csrc"
BUILD = "mpc_ros_tpu_torch/kernels/_build.py"
PATCH = ROOT / "tools" / "k1_direct_loads.patch"


def _sub(s: str, old: str, new: str, count: int = 1) -> str:
    if s.count(old) != count:
        raise SystemExit(f"K1 source changed: {old!r} found "
                         f"{s.count(old)} times, not {count}")
    return s.replace(old, new)


def wide(s: str) -> str:
    """Rows addressed by 64-bit offsets: the batch stride as a long long
    wherever the kernel multiplies by it."""
    s = _sub(s, "  int B, T;\n", "  long long B;\n  int T;\n")
    s = _sub(s, "const int B = a.B;", "const long long B = a.B;")
    s = _sub(s, "  int B;\n  float invlf;", "  long long B;\n  float invlf;")
    s = s.replace("const int st = ", "const long long st = ")
    return _sub(s, "const int i = k * B;", "const long long i = k * B;", 2)


def copy_tree(d: Path) -> Path:
    files = subprocess.run(["git", "ls-files", "-co", "--exclude-standard"],
                           cwd=ROOT, capture_output=True, text=True,
                           check=True).stdout.split()
    shutil.rmtree(d, ignore_errors=True)
    for f in files:
        if (ROOT / f).is_file():
            (d / f).parent.mkdir(parents=True, exist_ok=True)
            shutil.copy2(ROOT / f, d / f)
    return d / CSRC / "solve_mega.cu"


def trees(out: Path) -> None:
    for name in ("direct", "direct64", "wide", "fma"):
        d = out / name
        cu = copy_tree(d)
        if name.startswith("direct"):
            subprocess.run(["git", "apply", str(PATCH)], cwd=d, check=True)
        if name in ("direct64", "wide"):
            cu.write_text(wide(cu.read_text()))
        if name == "fma":
            b = d / BUILD
            b.write_text(_sub(b.read_text(), '["-fmad=false", ', "["))
        print(d)


def ptxas(min_blocks: list) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from mpc_ros_tpu_torch.kernels import _build

    variants = sorted(v for k, v in chip_smoke.build_pairs()
                      if k == "solve_mega")
    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    src = (ROOT / CSRC / "solve_mega.cu").read_text()
    jobs = []
    for m in min_blocks:
        d = ROOT / "build" / "k1_ptxas" / f"m{m}"
        d.mkdir(parents=True, exist_ok=True)
        for h in _build.COMMON:
            shutil.copy2(ROOT / CSRC / h, d / h)
        (d / "solve_mega.cu").write_text(_sub(
            src, "__launch_bounds__(kTile)",
            f"__launch_bounds__(kTile, {m})"))
        for v in variants:
            cmd = [_build.nvcc_path(), *flags, "-cubin",
                   *_build.KERNELS["solve_mega"].flags(v),
                   str(d / "solve_mega.cu"), "-o",
                   str(d / ("_".join(map(str, map(int, v))) + ".cubin"))]
            jobs.append((m, v, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    for m, v, p in jobs:
        log, _ = p.communicate()
        lines = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"min_blocks={m} {tuple(map(int, v))} rc={p.returncode} "
              + " | ".join(lines), flush=True)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "trees":
        trees(Path(argv[1]).resolve())
    elif argv and argv[0] == "ptxas":
        ptxas([int(m) for m in argv[1:]] or [1])
    else:
        raise SystemExit("usage: k1_variants.py trees OUT | ptxas [M ...]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
