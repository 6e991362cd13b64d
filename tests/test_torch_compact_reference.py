"""K1's compact straggler schedule through the port's normal path
(`solver.batch_lane.batch_solve_lane` -> `kernels.solve_mega.
solve_mega_scheduled` -> `_solve_compact`), held lane by lane against the
benchmark's plain reference (`benchmark/reference/nlp.py`: one pass to the
cap, float64) at the long-horizon cell's configuration
(`benchmark/configs/ref_nlp_n48_compact.json`: N=48, cap 22, float32, the
auto knobs stated) on K1's plain version (`backward="mega"`).

B = 256 is two 128-lane tiles and the tail is one, so pass 1 (each tile
stops once 97% of its lanes are done), K3's gather, pass 2 and the
scatter all run. The schedule departs from one pass in two ways, on the
lanes that needed pass 2 only:

* the resume carries done, converged, mu and the projected gradient, but
  not the count of negligible accepted steps, which pass 2 starts afresh;
* pass 2 runs with its own cap of 22 iterations, so a lane the reference
  stops unconverged at the cap may run on and converge.

On the seed below 6 of the 256 lanes needed pass 2; one of them ran past
the cap (27 iterations, converged, where the reference stops at 22
unconverged), and no lane's iterations differ otherwise. Every other lane
agrees with the reference to float32's rounding.

Also: the schedule's counters (`passes`, `tail_lanes`, `need_lanes`) and
the span of pass 2 (`k1.tail`), which no solve at N <= 36 opens; and
`need_lanes` under a mesh, whose shards solve on their own devices and
streams in one process.
"""

import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

from mpc_ros_tpu_torch import obs
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine.batch import make_random_scenarios
from mpc_ros_tpu_torch.kernels import solve_mega
from mpc_ros_tpu_torch.parallel import make_mesh, sharded_batch_solve
from mpc_ros_tpu_torch.solver import batch_lane
from mpc_ros_tpu_torch.testing import torch_threads

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CONFIG = BENCH / "configs" / "ref_nlp_n48_compact.json"
B = 256
SEED = 0

# Tolerances, on the lanes the departures leave alone. Float32 against
# float64 after up to 22 SQP iterations: on seeds 0-3 each lane's largest
# control gap is at most 5.4e-4 to 7.1e-4 (3.6e-4 to 4.1e-4 at the 99th
# percentile); 5e-3 leaves seven times that for another CPU's rounding and
# lies far below the 0.19 by which the reference computed in bfloat16
# parts at the 99th percentile at this configuration on the card (PERF.md,
# section 2).
DU_MAX = 5e-3
# the cost's gap over (weight scale + cost): at most 5.3e-7 to 6.7e-7 on
# seeds 0-3; 1e-5 leaves fifteen times that, against bfloat16's 0.05
COST_GAP_MAX = 1e-5
# a lane on the edge of the stopping rule may stop one iteration apart in
# float32 (about one lane in 200,000 at N=30, PERF.md section 6):
# one lane of 256 outside the tail
ITERS_APART_MAX = 1


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


nlp = _load(BENCH / "reference" / "nlp.py", "bench_reference_nlp")


def _config(**over):
    cfg = json.loads(CONFIG.read_text())
    params = MPCParams(**cfg["params"]).astype(torch.float32)
    solver = SolverConfig(**dict(cfg["solver"], backward="mega", **over))
    return cfg, params, solver


def _scenarios(seed, n=B):
    g = torch.Generator().manual_seed(seed)
    return make_random_scenarios(g, n, torch.float32, pose_scale=0.3,
                                 curve_scale=0.25)


def _count(name, timers):
    return timers.summary().get(name, {}).get("count", 0)


@pytest.fixture(scope="module")
def solved():
    """The port's compact solve (pass 1's outputs and the tail's lanes
    taken as K3 builds it, the counters and spans around the call) and
    the reference's solve of the same scenarios."""
    cfg, params, solver = _config()
    z0, coeffs = _scenarios(SEED)
    real = solve_mega.compact_tail
    seen = {}

    def spy(ins, out1, cfg_, blobs=None, refs=None):
        tail = real(ins, out1, cfg_, blobs, refs)
        seen["done1"] = out1[7].clone()
        seen["sel"] = tail.sel.clone()
        return tail

    with torch_threads(1), pytest.MonkeyPatch.context() as mp:
        mp.setattr(solve_mega, "compact_tail", spy)
        before = (solve_mega.passes, solve_mega.tail_lanes,
                  solve_mega.need_total())
        with obs.collect(obs.PhaseTimers()) as timers:
            res = batch_lane.batch_solve_lane(z0, coeffs, params, solver)
        after = (solve_mega.passes, solve_mega.tail_lanes,
                 solve_mega.need_total())
        ref = nlp.solve(z0.double(), coeffs.double(), nlp.stated_params(cfg),
                        nlp.Knobs.from_config(cfg))
    wscl = nlp.Params(nlp.stated_params(cfg), torch.float64,
                      torch.device("cpu"), 1).wscl
    touched = seen["done1"] < 0.5
    return dict(res=res, ref=ref, seen=seen, touched=touched,
                delta=tuple(a - b for a, b in zip(after, before)),
                timers=timers, cap=solver.max_sqp_iters, wscl=wscl)


def test_the_schedule_engaged(solved):
    """Two passes, a tail of one tile, pass 2 inside one `k1.tail` span,
    and the tail holds every lane pass 1 left undone."""
    passes, tail, need = solved["delta"]
    assert (passes, tail) == (2, 128)
    assert _count("k1.tail", solved["timers"]) == 1
    touched = solved["touched"]
    assert 0 < int(touched.sum()) <= 128
    in_tail = torch.zeros(B, dtype=torch.bool)
    in_tail[solved["seen"]["sel"]] = True
    assert bool(in_tail[touched].all())


def test_need_lanes_counts_the_lanes_undone_after_pass_1(solved):
    """`need_lanes` grows by the lanes pass 1 left undone (its done flag
    below 0.5; the stated knobs leave the rescue of stalled lanes out)."""
    assert solved["delta"][2] == int(solved["touched"].sum())


def test_converged_flags_differ_only_past_the_cap(solved):
    """Where the converged flags differ, the lane needed pass 2, the
    reference stopped it unconverged at the cap, and pass 2's own cap let
    it run on and converge."""
    res, ref, cap = solved["res"], solved["ref"], solved["cap"]
    apart = res.converged != ref.converged
    assert bool(solved["touched"][apart].all())
    assert bool((ref.iters[apart] == cap).all())
    assert bool((~ref.converged[apart]).all())
    assert bool((res.n_iters[apart] > cap).all())
    assert bool(res.converged[apart].all())
    assert int(apart.sum()) <= int(solved["touched"].sum())


def test_iterations_differ_on_few_lanes(solved):
    """Outside the tail at most one lane stops an iteration apart; in the
    tail only the lanes that ran past the cap may differ (the negligible
    step count restarts at pass 2, which on this seed moves no lane)."""
    res, ref, cap = solved["res"], solved["ref"], solved["cap"]
    apart = res.n_iters.long() != ref.iters.long()
    kept = ~solved["touched"]          # the lanes pass 1 finished
    assert int((apart & kept).sum()) <= ITERS_APART_MAX
    past = res.n_iters > cap
    assert bool((~apart | kept | past).all())
    assert float(apart.double().mean()) <= 2 / B


def test_controls_and_costs_agree(solved):
    """On the lanes that stop at the same iteration with the same flag,
    the controls and the cost agree to float32's rounding over the
    solve."""
    res, ref = solved["res"], solved["ref"]
    same = (res.n_iters.long() == ref.iters.long()) & (
        res.converged == ref.converged)
    assert int(same.sum()) >= B - 2
    du = (res.us.double() - ref.us).abs().amax(dim=(1, 2))[same]
    gap = ((res.cost.double() - ref.cost).abs()
           / (solved["wscl"] + ref.cost.abs()))[same]
    assert float(du.max()) <= DU_MAX
    assert float(gap.max()) <= COST_GAP_MAX


@pytest.mark.parametrize("n_steps", [30, 36])
def test_no_tail_at_n36_and_below(n_steps):
    """Under "auto" a solve at N <= 36 is one pass: no `k1.tail`, and the
    compact counters stand still."""
    _, params, solver = _config(n_steps=n_steps, max_sqp_iters=2)
    z0, coeffs = _scenarios(SEED + 1)
    with torch_threads(1):
        before = (solve_mega.passes, solve_mega.tail_lanes,
                  solve_mega.need_total())
        with obs.collect(obs.PhaseTimers()) as timers:
            batch_lane.batch_solve_lane(z0, coeffs, params, solver)
        after = (solve_mega.passes, solve_mega.tail_lanes,
                 solve_mega.need_total())
    assert tuple(a - b for a, b in zip(after, before)) == (1, 0, 0)
    assert _count("k1.tail", timers) == 0
    assert _count("k1.schedule", timers) == 0


def test_need_lanes_counts_at_most_the_tail(monkeypatch):
    """A call whose undone lanes overflow its tail adds only the tail:
    the rest keep their pass-1 iterate (`last_need` counts them), so the
    share of the tail that did work stays at most 1."""
    monkeypatch.setattr(solve_mega, "need_lanes", {})
    solve_mega._count_need(torch.tensor(300).clamp(max=128))
    solve_mega._count_need(torch.tensor(7))
    assert solve_mega.need_lanes.keys() == {(torch.device("cpu"), None)}
    assert solve_mega.need_total() == 135


def _mesh_devices():
    two = torch.cuda.is_available() and torch.cuda.device_count() >= 2
    return [
        pytest.param(["cpu", "cpu"], id="cpu"),
        pytest.param(["cuda:0", "cuda:0"], id="one_card_two_streams",
                     marks=pytest.mark.cuda),
        pytest.param(["cuda:0", "cuda:1"], id="two_cards",
                     marks=[pytest.mark.cuda, pytest.mark.skipif(
                         not two, reason="needs two CUDA devices")]),
    ]


@pytest.mark.parametrize("devices", _mesh_devices())
def test_need_lanes_under_a_mesh(devices, monkeypatch):
    """Two shards of 256 lanes, each a compact solve on its shard's device
    (and on a card its own stream), add their tails' needs to counts of
    their own: the total is the sum over the shards' calls."""
    if devices[0].startswith("cuda") and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, params, solver = _config()     # K1's plain version; on a card, K1
    z0, coeffs = _scenarios(SEED + 2, 2 * B)
    real = solve_mega.compact_tail
    needs = []

    def spy(ins, out1, cfg_, blobs=None, refs=None):
        tail = real(ins, out1, cfg_, blobs, refs)
        needs.append(tail.need.clamp(max=tail.sel.numel()).clone())
        return tail

    monkeypatch.setattr(solve_mega, "compact_tail", spy)
    mesh = make_mesh(n_data=2, devices=devices)
    with torch_threads(1):
        before = solve_mega.need_total()
        res = sharded_batch_solve(mesh, z0.to(devices[0]),
                                  coeffs.to(devices[0]), params, solver)
        after = solve_mega.need_total()
    assert len(needs) == 2
    assert {n.device for n in needs} == {torch.device(d) for d in devices}
    assert after - before == sum(int(n) for n in needs) > 0
    assert res.us.shape[0] == 2 * B
