"""The port's host-side difficulty presort (`engine/presort.py`) against
the JAX package's numpy functions on the same numpy inputs, and
`solve_presorted` against the direct solve of the same batch."""

import dataclasses

import numpy as np
import pytest
import torch

from mpc_ros_tpu.engine import presort as jpresort
from mpc_ros_tpu_torch.config import MPCParams, SolverConfig
from mpc_ros_tpu_torch.engine import presort
from mpc_ros_tpu_torch.solver.batch_lane import batch_solve_lane
from mpc_ros_tpu_torch.testing import (numpy_scenarios, torch_threads)

CFG = SolverConfig(n_steps=30, max_sqp_iters=12, ls_iters=4, ddp=True,
                   tol_grad=1e-4)



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield

@pytest.mark.parametrize("blobs", [False, True], ids=["plain", "blobs"])
def test_features_fit_predict_match_jax(blobs):
    z0, coeffs = numpy_scenarios(0, 512)
    rng = np.random.default_rng(1)
    iters = rng.integers(2, 13, size=512).astype(np.float64)
    bxy = rng.normal(size=(512, 2)) if blobs else None
    f_j = jpresort.difficulty_features(z0, coeffs, bxy)
    f_t = presort.difficulty_features(torch.tensor(z0), torch.tensor(coeffs),
                                      bxy)
    assert f_t.shape == f_j.shape == (512, 23 if blobs else 16)
    np.testing.assert_allclose(f_t, f_j, rtol=1e-12, atol=1e-12)
    m_j = jpresort.fit_difficulty_model(z0, coeffs, iters, blob_xy=bxy)
    m_t = presort.fit_difficulty_model(z0, coeffs, torch.tensor(iters),
                                       blob_xy=bxy)
    np.testing.assert_allclose(m_t, m_j, rtol=1e-12, atol=1e-12)
    k_j = jpresort.predict_difficulty(m_j, z0, coeffs, bxy)
    k_t = presort.predict_difficulty(m_t, z0, coeffs, bxy)
    np.testing.assert_allclose(k_t, k_j, rtol=1e-12, atol=1e-12)


def _solve(z0, coeffs, cfg):
    f32 = torch.float32
    return batch_solve_lane(torch.tensor(z0, dtype=f32),
                            torch.tensor(coeffs, dtype=f32),
                            MPCParams().astype(f32), cfg)


@pytest.mark.parametrize("backward", ["auto", "mega"])
def test_presorted_solve_matches_direct(backward):
    """Lanes are independent (done lanes never update), so the solve in
    difficulty order, with the caller's order restored on the host, equals
    the direct solve bit for bit — on CPU tensors through the XLA lane path
    ("auto") and through the whole-solve kernel's plain version ("mega").
    The fitted keys also cut the mean per-tile maximum of iterations on a
    held-out draw (what the presort is for)."""
    cfg = dataclasses.replace(CFG, backward=backward)
    B = 512
    z0, coeffs = numpy_scenarios(11, B)
    calib = _solve(z0, coeffs, cfg)
    model = presort.fit_difficulty_model(z0, coeffs, calib.n_iters)

    zc, cc = numpy_scenarios(12, B)
    zc, cc = zc.astype(np.float32), cc.astype(np.float32)
    ref = _solve(zc, cc, cfg)
    pres = presort.solve_presorted(zc, cc, MPCParams().astype(torch.float32),
                                   cfg, model=model, device="cpu")
    assert pres.result.us.device.type == "cpu"
    back = pres.unpermuted_host()
    for name in ("us", "zs", "cost", "n_iters", "converged"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(ref, name).numpy())
    it = ref.n_iters.numpy().astype(np.float64)
    keys = presort.predict_difficulty(model, zc, cc)
    srt = it[np.argsort(keys, kind="stable")]
    tile_max = lambda a: a.reshape(-1, 128).max(axis=1).mean()
    assert tile_max(srt) < tile_max(it) - 0.3, (tile_max(srt), tile_max(it))


def test_solve_presorted_needs_a_ranking():
    z0, coeffs = numpy_scenarios(0, 128)
    with pytest.raises(ValueError, match="model or explicit keys"):
        presort.solve_presorted(z0, coeffs, MPCParams(), CFG, device="cpu")
