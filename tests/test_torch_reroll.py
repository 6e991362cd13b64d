"""The whole-solve kernel's re-roll from recorded controls, against its
plain version: the plain version recomputes the winner's controls as the
TPU kernel does (u_b + alpha_sel k + K ds), and a replay of those controls
from s0 gives its trajectory and the accepted candidate's cost bit for
bit, in float32 and float64, for the diff drive (fast and exact trig), the
bicycle, blobs and setpoint profiles; the scratch the wrapper allocates
against the kernel's byte model; and the line-search diagnostic output."""

import dataclasses

import numpy as np
import pytest
import torch

from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.kernels import solve_mega
from mpc_ros_tpu_torch.kernels.pack import pack_params
from mpc_ros_tpu_torch.models.obstacles import GaussianObstacles
from mpc_ros_tpu_torch.testing import (numpy_blobs, numpy_refs,
                                       numpy_scenarios, torch_threads)

B = 256
N = 12



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

def _case(case, dtype, seed=3):
    """(inputs, config, blobs, refs) of one case at N=12, B=256."""
    z0, coeffs = numpy_scenarios(seed, B)
    lb = torch.full((2, B), -1.0, dtype=dtype)
    kw = dict(n_steps=N, max_sqp_iters=12, tol_grad=1e-4)
    if case == "bicycle":
        kw["model"] = "bicycle"
    if case == "exact":
        kw["trig"] = "exact"
    ins = (torch.tensor(z0.T, dtype=dtype), torch.tensor(coeffs.T,
                                                         dtype=dtype),
           pack_params(MPCParams(), B, dtype), lb, -lb,
           torch.zeros(N - 1, 2, B, dtype=dtype))
    blobs = refs = None
    if case == "blobs":
        blobs = GaussianObstacles.from_sigmas(*(
            torch.tensor(a, dtype=dtype) for a in numpy_blobs(seed, B, 2))
        ).lane()
    if case == "refs":
        refs = torch.tensor(numpy_refs(seed, B, N), dtype=dtype).permute(
            1, 2, 0).contiguous()
    return ins, SolverConfig(**kw), blobs, refs


@pytest.mark.parametrize("case", ["diff_drive", "exact", "bicycle", "blobs",
                                  "refs"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_replay_equals_recompute_bit_for_bit(case, dtype):
    """After every iteration m, the controls of the plain version (the
    recompute) replayed from s0 — the plain version's initial rollout, with
    every lane resumed done so that no iteration runs — give its
    trajectory and its cost bit for bit. That cost is the accepted
    candidate's, summed along the candidate's own rollout of the controls
    the line search recorded for it, so the recomputed controls are the
    recorded ones, which the kernel's re-roll replays."""
    ins, cfg, blobs, refs = _case(case, dtype)
    zT, cT, pp, lb, ub, _ = ins
    full = solve_mega.solve_mega_plain(*ins, cfg, blobs=blobs, refs=refs)
    n_ls = cfg.ls_for(dtype)
    diag = torch.zeros(n_ls + 2, B, dtype=dtype)
    accepted = 0
    for m in range(1, int(full[4].max()) + 1):
        out = solve_mega.solve_mega_plain(
            *ins, dataclasses.replace(cfg, max_sqp_iters=m), blobs=blobs,
            refs=refs, diag=diag)
        accepted += int(((out[4] == m) & (diag[n_ls + 1] > 0)).sum())
        resume = (torch.ones_like(out[7]), out[3], out[6], out[5])
        replay = solve_mega.solve_mega_plain(zT, cT, pp, lb, ub, out[1], cfg,
                                             resume=resume, blobs=blobs,
                                             refs=refs)
        assert not bool(replay[4].any())
        for i in (0, 1, 2):
            assert torch.equal(replay[i], out[i])
    for a, b in zip(out, full):
        assert torch.equal(a, b)
    # the solves did iterate, most steps were accepted, and most lanes
    # converged
    assert float(full[4].mean()) >= 2.0
    assert accepted >= 0.5 * float(full[4].sum())
    assert float(full[3].mean()) >= 0.95


def test_scratch_allocation_matches_the_byte_model():
    """The wrapper's scratch holds, per lane and knot, what the byte model
    writes to it: the backward's k and K without its zero column (16), the
    line search's 2 n_ls controls, and the rollout trig cache the re-roll
    writes beside s and u (4); the trajectory is the outputs themselves.
    At T=29 the model streams 8.6 KB per lane-iteration (12.3 KB in the
    double-buffered design)."""
    for T, n_ls in ((29, 4), (47, 4), (29, 8), (1, 1)):
        shapes = solve_mega.scratch_shapes(T, n_ls, B)
        per_lane = sum(int(np.prod(s)) for s in shapes) // B
        bwd, ls, reroll = solve_mega.knot_floats("replay", n_ls)
        assert per_lane == T * ((bwd - 12) + (ls - 24) + 4)
        assert (bwd, ls, reroll) == (28, 24 + 2 * n_ls, 14)
        assert all(s[-1] == B for s in shapes)
    assert solve_mega.scratch_bytes(29, 4) == 4 * 29 * 74 == 8584
    assert solve_mega.scratch_bytes(29, 8) == 4 * 29 * 82
    # a rejected step skips the re-roll; the recompute re-rolls every lane
    assert solve_mega.scratch_bytes(29, 4, accepted=False) == 4 * 29 * 60
    assert solve_mega.scratch_bytes(29, 4, "recompute") == 4 * 29 * 106
    assert solve_mega.scratch_bytes(29, 4, "recompute",
                                    accepted=False) == 4 * 29 * 106
    assert solve_mega.scratch_bytes(29, 4, n_blobs=4, setp=True) == (
        4 * 29 * (74 + 2 * (3 + 16)))
    with pytest.raises(ValueError, match="layout"):
        solve_mega.knot_floats("double", 4)


def test_diag_records_the_last_line_search():
    """Per lane, the diagnostic holds its last iteration's candidate costs,
    the cost before the step and the alpha chosen: alpha is 0.5^j for the
    first candidate j that lowers the cost (0 if none does), and the final
    cost is that candidate's (or the cost before)."""
    ins, cfg, _, _ = _case("diff_drive", torch.float64)
    n_ls = cfg.ls_for(torch.float64)
    diag = torch.full((n_ls + 2, B), float("nan"), dtype=torch.float64)
    out = solve_mega.solve_mega_plain(*ins, cfg, diag=diag)
    assert torch.equal(out[1], solve_mega.solve_mega_plain(*ins, cfg)[1])
    ran = out[4] > 0
    assert bool(ran.all())
    cand, before, alpha = diag[:n_ls], diag[n_ls], diag[n_ls + 1]
    lower = cand < before
    first = torch.where(lower.any(0), lower.float().argmax(0),
                        torch.full((B,), -1))
    want = torch.where(first >= 0, 0.5 ** first.clamp(min=0).double(),
                       torch.zeros(B, dtype=torch.float64))
    assert torch.equal(alpha, want)
    picked = cand.gather(0, first.clamp(min=0)[None])[0]
    assert torch.equal(out[2], torch.where(first >= 0, picked, before))


def test_diag_shape_is_checked():
    ins, cfg, _, _ = _case("diff_drive", torch.float32)
    for bad in (torch.zeros(5, B), torch.zeros(6, B, dtype=torch.float64),
                torch.zeros(B, 6).t()):
        with pytest.raises(ValueError, match="diag"):
            solve_mega.solve_mega_plain(*ins, cfg, diag=bad)
