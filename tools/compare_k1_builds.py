#!/usr/bin/env python3
"""Compare the whole-solve kernel (K1) of this checkout with another tree's,
on one GPU: do the variants both trees build compile to the same machine
code, and does `chip_smoke.py`'s phase 9 (N=48, seed 6, B=131,072: the
per-block exit cold, then the resumed pass) give the same outputs bit for
bit on both sides?

    git archive <commit> | tar -x -C build/other     # build/ is ignored
    python3 tools/compare_k1_builds.py build/other

Each tree runs in its own process (both import the package by the same
name) and leaves its outputs under $TMPDIR; the SASS of each variant is
read with the CUDA toolkit's cuobjdump, without its addresses and
encodings. A change that adds template options to K1 must leave the
variants without them identical: NVPTX's choice of which a*b + c to fuse
depends on the instruction order around it, so moving shared code changes
the rounding. Prints one line per comparison and exits 1 on a difference.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

# the variants phase 9 launches: (n_ls, ddp, fast, adaptive, tile_exit)
VARIANTS = [(4, True, True, True, True), (4, True, True, True, False)]
FIELDS = {1: "us", 2: "cost", 3: "conv", 4: "iters", 6: "mu", 7: "done"}


def run_tree(root: str, out: str) -> None:
    """In a child process: phase 9's comparisons on `root`'s package, the
    kernel and plain outputs saved to `out`, and each variant's library."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from mpc_ros_tpu_torch.kernels import _build, solve_mega

    assert Path(cs.__file__).resolve().parent == Path(root).resolve()
    cs.CARD = cs.card_line()
    dev = torch.device("cuda", 0)
    saved = {}
    for variant, rec, (_, _, _, o_k, o_p) in cs.long_variants(
            dev, cs.B_LONG, cs.LONG_SEED, gate=False):
        print(f"{root}: {variant} gates ok {rec['ok']} max du "
              f"{rec['max_du']}", flush=True)
        for side, o in (("kernel", o_k), ("plain", o_p)):
            for i, f in FIELDS.items():
                saved[f"{variant}.{side}.{f}"] = o[i].cpu()
    # the tree's own variant tuple: the leading flags, and the later
    # options off
    width = len(solve_mega.resolve_knobs(cs.LONG, torch.float32).variant)
    saved["libs"] = {
        str(v): str(_build.lib_path("solve_mega",
                                    v + (False,) * (width - len(v))))
        for v in VARIANTS}
    torch.save(saved, out)


def sass(lib: str) -> list:
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    # instruction lines: "/*0040*/  FFMA R3, R2, R5, R4 ;  /* 0x... */"
    return [ln.split("*/", 1)[1].split(";")[0].strip()
            for ln in text.splitlines() if ln.strip().startswith("/*")]


def main(argv) -> int:
    if len(argv) == 3 and argv[0] == "--tree":
        run_tree(argv[1], argv[2])
        return 0
    if len(argv) != 1:
        raise SystemExit("usage: compare_k1_builds.py OTHER_TREE")
    import torch

    here = str(Path(__file__).resolve().parents[1])
    tmp = tempfile.mkdtemp()
    outs = {}
    for name, root in (("other", argv[0]), ("this", here)):
        outs[name] = os.path.join(tmp, f"{name}.pt")
        subprocess.run([sys.executable, __file__, "--tree",
                        os.path.abspath(root), outs[name]], check=True)
    a, b = (torch.load(outs[n]) for n in ("other", "this"))
    differ = False
    for key in a:
        if key == "libs":
            continue
        same = torch.equal(a[key], b[key])
        differ |= not same
        off = (a[key] != b[key]).reshape(-1, a[key].shape[-1]).any(0)
        print(f"{key}: " + ("equal" if same else
                            f"differs on {int(off.sum())} lanes"))
    for v in a["libs"]:
        same = sass(a["libs"][v]) == sass(b["libs"][v])
        differ |= not same
        print(f"SASS of solve_mega{v}: {'identical' if same else 'differs'}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
