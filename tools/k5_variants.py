#!/usr/bin/env python3
"""The line-search kernel's (K5) design steps, undone in copies of this
checkout, for timing against it on one GPU.

    python3 tools/k5_variants.py build/k5steps
    python3 tools/compare_k1_builds.py --timing --only k5 build/parent \\
        build/k5steps/direct64 build/k5steps/wide build/k5steps/kring \\
        build/k5steps/noskip

Writes copies of the files git would commit (build/ is ignored) whose
`forward.cu` differs from this one: `direct64` is the design's steps 1-2
alone (the rows written during the candidate pass, and a second pass only
where they are not the answer), with each knot's rows loaded straight
from device memory in both passes (`k5_direct_loads.patch`) and addressed
by 64-bit offsets; `wide` adds step 3, the shared-memory knot ring, still
with 64-bit offsets; `kring` is the shipped kernel with the 16 gains of a
knot read from the ring by each candidate instead of held in registers
across the candidates; `noskip` is steps 3-4 alone: the ring and 32-bit
offsets with the parent's structure, no rows written during the
candidate pass but row 0, and every lane re-rolled. The changes are
exact, against this checkout's K5, so a later edit of the text they touch
retires them: the tool stops and names what it did not find.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from k1_variants import CSRC, copy_tree

PATCH = Path(__file__).resolve().parent / "k5_direct_loads.patch"


def _sub(s: str, old: str, new: str, count: int = 1) -> str:
    if s.count(old) != count:
        raise SystemExit(f"K5 source changed: {old!r} found "
                         f"{s.count(old)} times, not {count}")
    return s.replace(old, new)


def wide(s: str, direct: bool) -> str:
    """Rows addressed by 64-bit offsets: the batch stride as a long long
    wherever the kernel multiplies by it (`direct`: the tree with the
    direct-load patch applied, whose second pass has offsets of its
    own)."""
    s = _sub(s, "  const int B = a.B;\n", "  const long long B = a.B;\n")
    s = _sub(s, "  int B;\n  __device__ __forceinline__ float* stage",
             "  long long B;\n  __device__ __forceinline__ float* stage")
    s = _sub(s, "const int st = ", "const long long st = ", 3 if direct else 2)
    s = _sub(s, "const int ut = t * 2 * B, Kt = t * 16 * B;",
             "const long long ut = t * 2 * B, Kt = t * 16 * B;", int(direct))
    return _sub(s, "const int o = ((t + 1) * 8 + r) * B;",
                "const long long o = ((t + 1) * 8 + r) * B;", int(direct))


_RING_GAINS = """      const volatile float* qK = q + 12 * kTile;
      float K0[8], K1[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        K0[j] = qK[j * kTile];
        K1[j] = qK[(8 + j) * kTile];
      }
"""
_KNOT_GAINS = """    float K0[8], K1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      K0[j] = q[(12 + j) * kTile];
      K1[j] = q[(20 + j) * kTile];
    }
"""


def kring(s: str) -> str:
    """Each candidate reads the knot's 16 gains from the ring again
    (volatile loads) instead of holding them in registers across the
    candidates."""
    s = _sub(s, _KNOT_GAINS, "")
    s = _sub(s, "#pragma unroll\n    for (int j = 0; j < 8; ++j)\n"
             "      m_g = maxf(m_g, maxf(fabsf(K0[j]), fabsf(K1[j])));\n", "")
    s = _sub(s, "      if (al == 0) {\n",
             "      if (al == 0) {\n#pragma unroll\n"
             "        for (int j = 0; j < 8; ++j)\n"
             "          m_g = maxf(m_g, maxf(fabsf(K0[j]), fabsf(K1[j])));\n")
    alpha = "      const float alpha = 1.0f / (float)(1 << al);\n"
    return _sub(s, alpha, _RING_GAINS + alpha)


def noskip(s: str) -> str:
    """No rows written during the candidate pass but row 0, and the second
    pass's re-roll on every lane."""
    s = _sub(s, "      ss_out[(t * 8 + r) * B] = new_row ? S[0][r] + 0.0f * "
             "s_b[r] : s_b[r];\n",
             "      if (t == 0) ss_out[r * B] = s_b[r];\n")
    s = _sub(s, "        us_out[(t * 2) * B] = spec_new ? u0 + 0.0f * ub_0 : "
             "ub_0;\n        us_out[(t * 2 + 1) * B] = spec_new ? u1 + 0.0f "
             "* ub_1 : ub_1;\n", "")
    s = _sub(s, "      ss_out[(T * 8 + r) * B] = spec_new ? S[0][r] + 0.0f * "
             "old : old;\n", "")
    return _sub(s, "  if (kind == SP_NONE) return;\n", "  kind = SP_REROLL;\n")


def trees(out: Path) -> None:
    for name in ("direct64", "wide", "kring", "noskip"):
        d = out / name
        copy_tree(d)
        cu = d / CSRC / "forward.cu"
        if name == "direct64":
            subprocess.run(["git", "apply", str(PATCH)], cwd=d, check=True)
        if name in ("direct64", "wide"):
            cu.write_text(wide(cu.read_text(), name == "direct64"))
        if name in ("kring", "noskip"):
            fn = kring if name == "kring" else noskip
            cu.write_text(fn(cu.read_text()))
        print(d)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: k5_variants.py OUT")
    trees(Path(sys.argv[1]))
