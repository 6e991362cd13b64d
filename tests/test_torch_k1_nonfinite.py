"""The whole-solve kernel's re-roll on lanes that hold NaN, inf or an
overflowing coefficient, its design transcribed in PyTorch and held
against the plain version bit for bit.

The kernel (`kernels/csrc/solve_mega.cu`) replays the line search's
recorded controls on an accepted step and skips the re-roll on a rejected
one — exact only while every row the backward read (s, u) or wrote (k, K)
is finite, which its running sum checks (`solve_mega.replay_check`).
Where the check fails it runs the TPU kernel's re-roll, u_b + alpha_sel k
+ K ds recomputed, clipped, stepped and blended with upd. The plain
version always blends. `solve_mega_plain(design=True)` runs the kernel's
paths on the plain version's own operations; on lanes planted by
`testing.plant_nonfinite` (NaN in the initial state, inf in a
coefficient, 1e30 in the leading coefficient) it must give every output
as the plain version does, NaN for NaN and inf for inf, in float32 and
float64, for the diff drive (fast and exact trig), the bicycle, blobs and
setpoint profiles, and at a cap where the planted lanes stall (mu at its
ceiling after 14-15 rejected steps).

A lane that is done while others run: the plain version, like the TPU
kernel within a tile, goes on blending it with act = 0, which changes it
where its re-roll is not finite. The kernel does the same for a done lane
whose trajectory or last backward rows were not finite (or that was
resumed done) while its block runs; at B = 128 the block and the plain
version's batch are the same lanes, so the design must equal the plain
version there with lanes resumed done beside running ones.
"""

import dataclasses

import pytest
import torch

import test_torch_reroll

from mpc_ros_tpu_torch.kernels import solve_mega
from mpc_ros_tpu_torch.testing import (WITNESS_LANE, next_backward_witness,
                                       plant_nonfinite, torch_threads)
from test_torch_reroll import B, _case

LANES = list(range(5, B, 23))



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def _equal(a, b):
    """Bit for bit but for a zero's sign, NaN where the other has NaN."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


@pytest.mark.parametrize("case,cap", [
    ("diff_drive", 12), ("exact", 12), ("bicycle", 12), ("blobs", 12),
    ("refs", 12), ("diff_drive", 30)],
    ids=["diff_drive", "exact", "bicycle", "blobs", "refs", "cap30"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_design_equals_plain_on_nonfinite_lanes(case, cap, dtype):
    ins, cfg, blobs, refs = _case(case, dtype)
    cfg = dataclasses.replace(cfg, max_sqp_iters=cap)
    planted = plant_nonfinite({"z": ins[0], "coeffs": ins[1]}, LANES)
    bad = (planted["z"], planted["coeffs"]) + ins[2:]
    kw = dict(blobs=blobs, refs=refs)
    plain = solve_mega.solve_mega_plain(*bad, cfg, **kw)
    design = solve_mega.solve_mega_plain(*bad, cfg, design=True, **kw)
    for a, b in zip(design, plain):
        assert _equal(a, b)
    # planted lanes turned to NaN through the blend, the others kept
    # finite; on clean inputs the two versions agree everywhere
    ss, us = plain[0], plain[1]
    assert bool(ss[..., LANES].isnan().any())
    if cap == 30:
        assert bool((plain[7][LANES] == 1.0).all())
    clean_p = solve_mega.solve_mega_plain(*ins, cfg, **kw)
    clean_d = solve_mega.solve_mega_plain(*ins, cfg, design=True, **kw)
    for a, b in zip(clean_d, clean_p):
        assert torch.equal(a, b)
    others = [i for i in range(B) if i not in LANES]
    assert bool(ss[..., others].isfinite().all())
    assert bool(us[..., others].isfinite().all())


def test_replay_check_flags_exactly_the_nonfinite_rows():
    """The check's sum is finite on a finite trajectory, and not finite
    once any state, control or gain of a lane is NaN or infinite."""
    g = torch.Generator().manual_seed(0)
    s = torch.randn(6, 8, generator=g)
    u = torch.randn(2, 8, generator=g)
    k = torch.randn(2, 8, generator=g)
    K = torch.randn(2, 8, 8, generator=g)
    assert bool(solve_mega.replay_check(s, u).isfinite().all())
    assert bool(solve_mega.replay_check(gains=(k, K)).isfinite().all())
    s[3, 1] = float("inf")
    u[0, 2] = float("nan")
    K[1, 6, 3] = float("-inf")
    K[0, 4, 5] = float("nan")            # column 4 is not read
    chk = solve_mega.replay_check(s, u) + solve_mega.replay_check(
        gains=(k, K))
    assert chk.isfinite().tolist() == [True, False, False, False, True,
                                       True, True, True]


@pytest.mark.parametrize("done_frac", [1.0, 0.97], ids=["per_lane", "tile"])
@pytest.mark.parametrize("case", ["diff_drive", "bicycle"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_design_equals_plain_on_lanes_done_before_the_others(
        case, dtype, done_frac, monkeypatch):
    """B = 128, one block: lanes planted with NaN, inf and the overflowing
    coefficient are resumed done (and two clean lanes with them) while the
    others run. The plain version blends the planted ones into NaN (the
    overflowing coefficient's lane from a finite trajectory, through its
    backward's gains); the design must give every output as it does."""
    monkeypatch.setattr(test_torch_reroll, "B", solve_mega.TILE)
    Bt = solve_mega.TILE
    ins, cfg, blobs, refs = test_torch_reroll._case(case, dtype)
    cfg = dataclasses.replace(cfg, done_frac=done_frac)
    lanes = [5, 40, 77, 100]
    planted = plant_nonfinite({"z": ins[0], "coeffs": ins[1]}, lanes)
    bad = (planted["z"], planted["coeffs"]) + ins[2:]
    done = torch.zeros(Bt, dtype=dtype)
    done[lanes + [9, 60]] = 1.0
    resume = (done, torch.zeros(Bt, dtype=dtype),
              torch.full((Bt,), 1e-6, dtype=dtype),
              torch.full((Bt,), float("inf"), dtype=dtype))
    plain = solve_mega.solve_mega_plain(*bad, cfg, resume=resume)
    design = solve_mega.solve_mega_plain(*bad, cfg, resume=resume,
                                         design=True)
    for a, b in zip(design, plain):
        assert _equal(a, b)
    # the blend reached the planted lanes; the others ran and stayed finite
    assert bool(plain[0][..., [5, 40, 100]].isnan().any(dim=0).all())
    assert int(plain[4].max()) >= 2
    others = [i for i in range(Bt) if i not in lanes]
    assert bool(plain[0][..., others].isfinite().all())


@pytest.mark.parametrize("done_frac", [1.0, 0.97], ids=["per_lane", "tile"])
def test_design_equals_plain_on_a_lane_whose_next_backward_overflows(
        done_frac):
    """The witness of `testing.next_backward_witness`: a lane done after
    one iteration on a finite trajectory, whose last backward was finite
    but whose next one, on the trajectory its accepted step left, is not.
    The plain version blends it into NaN while the other lanes of its
    block run; so does the design, through the kernel's probe of that
    backward (without it, the lane's `dirt` is finite and it kept its
    state)."""
    ins, cfg = next_backward_witness(torch.float32, done_frac=done_frac)
    lane = WITNESS_LANE
    # after the one iteration it runs, the lane is done on a finite
    # trajectory, and no gain it computed was non-finite
    one = solve_mega.solve_mega_plain(
        *ins, dataclasses.replace(cfg, max_sqp_iters=1), design=True)
    assert float(one[7][lane]) == 1.0 and float(one[3][lane]) == 1.0
    assert bool(one[0][..., lane].isfinite().all())
    assert bool(one[1][..., lane].isfinite().all())
    plain = solve_mega.solve_mega_plain(*ins, cfg)
    design = solve_mega.solve_mega_plain(*ins, cfg, design=True)
    for a, b in zip(design, plain):
        assert _equal(a, b)
    assert float(plain[4][lane]) == 1.0 and int(plain[4].max()) >= 2
    assert bool(plain[0][..., lane].isnan().any())
    others = [i for i in range(solve_mega.TILE) if i != lane]
    assert bool(plain[0][..., others].isfinite().all())
