"""The design of the line-search kernel (K5, `kernels/csrc/forward.cu`)
transcribed in PyTorch and held against its plain version bit for bit.

The kernel writes each lane's likely output during the candidate pass
(candidate 0's rows, new + 0 * old, on an active lane; the pass-through
rows on any other) and runs a second pass only where that is not the
answer: a re-roll of the winner on active lanes that accepted alpha < 1,
on lanes whose bound (`forward.rollouts_finite`) does not show every
rollout finite, and on lanes with act outside {0, 1}; a rewrite of the
pass-through rows on rejected active lanes. The transcription below does
the same on the plain version's candidates and must equal
`forward_plain` (the TPU kernel's recompute-and-blend) in every bit but a
zero's sign, non-finite lanes included; its second-pass codes are the
yardstick `forward.second_pass_plain` hands the kernel's counter on the
card. Inputs: `test_torch_forward.make_inputs` (blown-up steps, rejected
lanes, ~30% done lanes) with lanes planted with NaN, inf and an
overflowing coefficient.
"""

import numpy as np
import pytest
import torch

from mpc_ros_tpu_torch.config import MPCParams
from mpc_ros_tpu_torch.kernels import forward
from mpc_ros_tpu_torch.kernels.pack import P_DT, pack_params
from mpc_ros_tpu_torch.testing import (plant_nonfinite, torch_threads)
from test_torch_forward import B, make_inputs

# planted lanes: NaN / inf / 1e30 in turn, and one with act = 0.5
PLANTED = (40, 47, 55, 62, 70, 77, 85, 93, 101)
HALF_ACT = 110



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def inputs(seed, T, dtype, plant=True):
    inp = make_inputs(seed, T)
    t = lambda k: torch.tensor(inp[k], dtype=dtype)
    named = {"ss": t("ss"), "ks": t("ks"), "Ks": t("Ks"),
             "coeffs": t("coeffs")}
    act = t("act")
    if plant:
        named = plant_nonfinite(named, PLANTED)
        act[HALF_ACT] = 0.5
    return (named["ss"], t("us"), named["ks"], named["Ks"], named["coeffs"],
            pack_params(MPCParams(), B, dtype), 1.0, t("lb"), t("ub"),
            t("cost"), act)


def bound(ss, us, ks, Ks, coeffs, params, sign, lb, ub):
    """The kernel's finiteness bound (the note of forward.cu, case (b)),
    in its operation order."""
    T = us.shape[0]
    amax = lambda x: x.abs().reshape(-1, x.shape[-1]).amax(dim=0)
    m, g, C = amax(ss), amax(Ks), amax(coeffs)
    w = torch.maximum(amax(us), amax(ks))
    U = torch.maximum(torch.maximum(lb[0].abs(), lb[1].abs()),
                      torch.maximum(ub[0].abs(), ub[1].abs()))
    D = params[P_DT].abs()
    V = m + T * U * D
    X = m + T * D * V
    F = C * float(coeffs.shape[0])
    for _ in range(1, coeffs.shape[0]):
        F = F * torch.clamp(X, min=1.0)
    S = torch.maximum(torch.maximum(V, X),
                      torch.maximum(F + X + abs(sign) * V * D, U))
    Q = 2.0 * w + 8.0 * g * (S + m)
    return (S <= 1e30) & (Q <= 1e30)


def design(ss, us, ks, Ks, coeffs, params, sign, lb, ub, cost, act,
           n_alpha):
    """Steps 1-2 of the kernel's design: (ss, us, cost, accepted, codes)."""
    stage_cost, term_cost, feedback, dyn = forward._model(
        coeffs, params, sign, lb, ub)
    T, B = us.shape[0], us.shape[-1]
    # step 1: the candidates advance together over t (as
    # `forward.candidates`), and each stage writes its rows: candidate 0's
    # (+ 0 * old) on active lanes, old on the others
    spec = act == 1.0
    S = [ss[0][i].expand(n_alpha, B) for i in range(8)]
    accs = torch.zeros((n_alpha, B), dtype=ss.dtype)
    ss_out, us_out = [ss[0]], []
    for t in range(T):
        if t > 0:
            ss_out.append(torch.where(
                spec, torch.stack([r[0] for r in S]) + 0.0 * ss[t], ss[t]))
        u0, u1 = feedback(S, ss[t], us[t], forward.alphas(n_alpha, ss),
                          ks[t], Ks[t])
        us_out.append(torch.where(
            spec, torch.stack([u0[0], u1[0]]) + 0.0 * us[t], us[t]))
        accs = accs + stage_cost(S, u0, u1, 1.0 if t >= 1 else 0.0)
        S = dyn(S, u0, u1)
    ss_out.append(torch.where(
        spec, torch.stack([r[0] for r in S]) + 0.0 * ss[T], ss[T]))
    costs = accs + term_cost(S)
    # the acceptance ladder, and which lanes take which second pass
    accepted, alpha_sel, cost_sel, winner = forward.acceptance(costs, cost)
    upd = accepted * act
    finite = bound(ss, us, ks, Ks, coeffs, params, sign, lb, ub)
    reroll = torch.where(spec, (accepted == 1.0) & (alpha_sel != 1.0)
                         | (accepted != 1.0) & ~finite,
                         (act != 0.0) | ~finite)
    rewrite = spec & (accepted != 1.0) & finite
    # step 2: the re-roll through the blend, and the pass-through rows
    s_a = list(ss[0])
    for t in range(T):
        u0, u1 = feedback(s_a, ss[t], us[t], alpha_sel, ks[t], Ks[t])
        s_a = dyn(s_a, u0, u1)
        u_new = (upd[None] * torch.stack([u0, u1])
                 + (1.0 - upd)[None] * us[t])
        s_new = upd[None] * torch.stack(s_a) + (1.0 - upd)[None] * ss[t + 1]
        us_out[t] = torch.where(reroll, u_new,
                                torch.where(rewrite, us[t], us_out[t]))
        ss_out[t + 1] = torch.where(reroll, s_new,
                                    torch.where(rewrite, ss[t + 1],
                                                ss_out[t + 1]))
    kind = torch.where(reroll, forward.SP_REROLL,
                       torch.where(rewrite, forward.SP_REWRITE,
                                   forward.SP_NONE))
    return (torch.stack(ss_out), torch.stack(us_out),
            torch.where(upd > 0.5, cost_sel, cost), accepted,
            (kind + 4 * winner).to(torch.int8))


def same(a, b) -> bool:
    """Equal values (a zero's sign aside) and NaN in the same places."""
    nan = torch.isnan(b)
    return (torch.equal(torch.isnan(a), nan)
            and torch.equal(torch.where(nan, 0.0, a),
                            torch.where(nan, 0.0, b)))


@pytest.mark.parametrize("dtype,n_alpha,T", [
    (torch.float64, 8, 29), (torch.float32, 8, 29), (torch.float32, 3, 7),
    (torch.float64, 3, 7)])
def test_design_equals_plain_bit_for_bit(dtype, n_alpha, T):
    ins = inputs(0, T, dtype)
    got = design(*ins, n_alpha)
    want = forward.forward_plain(*ins, n_alpha=n_alpha)
    for name, a, b in zip(("ss", "us", "cost", "accepted"), got, want):
        assert same(a, b), name
    # the package's yardstick for the kernel's counter is this rule
    assert torch.equal(got[4], forward.second_pass_plain(*ins,
                                                         n_alpha=n_alpha))
    assert torch.equal(bound(*ins[:9]), forward.rollouts_finite(*ins[:9]))
    # the cases the rule has to get right all occur (with 8 candidates:
    # with 3 the blown-up steps of these inputs find no alpha)
    kind, act = got[4] % 4, ins[10]
    acc, winner = got[3] > 0.5, got[4] // 4
    on = act == 1.0
    assert bool((kind[on & acc & (winner == 0)] == forward.SP_NONE).all())
    assert bool((on & acc & (winner > 0)).any()) or n_alpha < 8  # alpha < 1
    assert bool((kind == forward.SP_REWRITE).any())       # rejected
    assert bool(((act == 0.0) & (kind == forward.SP_NONE)).any())
    assert int(kind[HALF_ACT]) == forward.SP_REROLL
    # a planted lane re-rolls unless it is active and accepted alpha = 1
    # (case (a): its rows are candidate 0's, whatever the inputs hold)
    planted = torch.tensor(PLANTED)
    first = on & acc & (winner == 0)
    assert bool(((kind == forward.SP_REROLL) | first)[planted].all())
    assert bool((kind[planted] == forward.SP_REROLL).any())
    # the planted lanes reach the outputs as NaN on both sides
    assert bool(torch.isnan(want[1][..., planted]).any())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_design_equals_plain_on_clean_inputs(dtype):
    """Without planted lanes every finite lane skips or takes the pass the
    acceptance alone decides, and the outputs equal the plain version's."""
    ins = inputs(3, 29, dtype, plant=False)
    got = design(*ins, 8)
    want = forward.forward_plain(*ins, n_alpha=8)
    for a, b in zip(got, want):
        assert same(a, b)
    assert bool(forward.rollouts_finite(*ins[:9]).all())
    on, acc = ins[10] == 1.0, got[3] > 0.5
    assert bool((got[4][~on] % 4 == forward.SP_NONE).all())
    assert bool((got[4][on & ~acc] % 4 == forward.SP_REWRITE).all())


def test_design_bytes():
    """The byte model: with no lane in the second pass it is the bound's
    count (each input read once, each output written once: 1,142 floats
    at T = 29, P = 4); a sector of re-rolling lanes adds 28 T + 8 floats
    read and 10 T written, a rewriting one 10 T + 8 and 10 T."""
    ins = inputs(0, 29, torch.float32, plant=False)
    outs = forward.forward_plain(*ins, n_alpha=8)
    per_lane = sum(a.numel() for a in list(ins[:6]) + list(ins[7:]) +
                   list(outs) if torch.is_tensor(a)) / B
    assert per_lane == 1142
    assert forward.design_bytes(29, 4) == 4 * 1142
    assert forward.design_bytes(29, 4, 1.0, 0.0) == 4 * (1142 + 38 * 29 + 8)
    assert forward.design_bytes(29, 4, 0.0, 1.0) == 4 * (1142 + 20 * 29 + 8)
    assert np.isclose(forward.design_bytes(29, 4, 0.25, 0.5),
                      4 * (1142 + 0.25 * 1110 + 0.5 * 588))


def test_second_pass_counts():
    """Lanes and 32-byte sectors (8 lanes) per pass, from the codes."""
    codes = torch.zeros(64, dtype=torch.int8)
    codes[[0, 1, 9]] = forward.SP_REROLL + 4 * 3
    codes[[40]] = forward.SP_REWRITE + 4 * 8
    got = forward.second_pass_counts(codes)
    assert got == {"reroll_lanes": 3, "reroll_sectors": 2,
                   "reroll_sector_share": 0.25, "rewrite_lanes": 1,
                   "rewrite_sectors": 1, "rewrite_sector_share": 0.125}
