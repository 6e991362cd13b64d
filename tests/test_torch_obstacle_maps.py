"""Grid costmaps in the port (`models/obstacles.py`: `ObstacleMap`, its
three samplings, the fits) against the JAX package on the same numpy
inputs:

* the single-map samplers (`bilinear_sample`, `obstacle_cost`,
  `obstacle_grad_xy`, `obstacle_curv_xy`, `_spline_terms_xy`), the lane
  forms (`obstacle_cost_grad_bl`, `obstacle_curv_bl`, `_spline_terms_bl`,
  `_spline_coeff_terms_bl`) and `spline_coeff_planes`, in float64 to
  1e-12, on points inside the map, on its cell lines, in the border strip,
  far outside, at +-inf and at NaN (NaN where JAX gives NaN);
* the single-map forms over a batch of maps against the JAX forms mapped
  with `jax.vmap` (the single-scenario solver's per-lane maps);
* the tiny-grid guard on every spline route, the unknown-mode error,
  `with_grid` re-deriving attached planes;
* the host fit (greedy and refined) and the batched device fit against
  JAX, and the device fit against the host greedy fit at the bar of
  tests/test_obstacle_fit.py;
* `gaussian_blob_map` within one float32 ulp of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_ros_tpu.models import obstacles as jobs
from mpc_ros_tpu_torch.models import obstacles
from mpc_ros_tpu_torch.testing import torch_threads

TOL = 1e-12
H, W = 24, 28
RES = 0.125
ORIGIN = (-1.5, -1.25)
SAMPLINGS = ("bilinear", "spline", "spline_coeff")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, and the suite
    runs in several processes at once (`testing.torch_threads`)."""
    with torch_threads(1):
        yield


def numpy_grids(seed: int, batch: int = 0, h: int = H, w: int = W):
    """Seeded cost grids in [0, 1]: two bumps over noise, the border cells
    nonzero (the masks outside the map are then visible). (h, w), or
    (batch, h, w) with batch > 0."""
    rng = np.random.default_rng(seed)
    n = max(batch, 1)
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    g = 0.2 * rng.uniform(size=(n, h, w))
    for _ in range(2):
        cx = rng.uniform(0, w, (n, 1, 1))
        cy = rng.uniform(0, h, (n, 1, 1))
        s = rng.uniform(1.5, 4.0, (n, 1, 1))
        g += 0.8 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    g = np.clip(g, 0.0, 1.0)
    return g if batch else g[0]


def numpy_points(seed: int, n: int = 64, h: int = H, w: int = W):
    """(n + 18, 2) points: inside the map, on its cell lines, in the
    border strip, far outside, at +-inf and at NaN."""
    rng = np.random.default_rng(seed)
    ox, oy = ORIGIN
    inside = np.stack([ox + rng.uniform(0, w - 1, n) * RES,
                       oy + rng.uniform(0, h - 1, n) * RES], -1)
    lines = np.array([[ox + 3 * RES, oy + 5 * RES],
                      [ox + 7 * RES, oy + 2.5 * RES],
                      [ox, oy], [ox + (w - 1) * RES, oy + (h - 1) * RES]])
    strip = np.array([[ox - 0.3 * RES, oy + 4 * RES],
                      [ox + (w - 0.7) * RES, oy + 4.2 * RES],
                      [ox + 5.5 * RES, oy - 0.4 * RES],
                      [ox + 5.5 * RES, oy + (h - 0.6) * RES]])
    inf, nan = np.inf, np.nan
    far = np.array([[1e6, 0.0], [-1e6, 0.2], [0.1, 1e30], [0.3, -1e30],
                    [inf, 0.1], [-inf, 0.1], [0.1, inf], [0.2, -inf],
                    [nan, 0.0], [0.0, nan]])
    return np.concatenate([inside, lines, strip, far])


def maps(grid, sampling: str, weight=7.5, batch: int = 0):
    """The same map (or batch of maps) on both sides, float64; spline_coeff
    maps carry their planes (each side derives its own)."""
    g = np.asarray(grid)
    shape = (batch,) if batch else ()
    org = np.broadcast_to(np.asarray(ORIGIN), shape + (2,))
    res = np.full(shape, RES)
    wgt = np.full(shape, weight)
    jm = jobs.ObstacleMap(grid=jnp.asarray(g), origin=jnp.asarray(org),
                          resolution=jnp.asarray(res),
                          weight=jnp.asarray(wgt), sampling=sampling)
    tm = obstacles.ObstacleMap(
        grid=torch.tensor(g), origin=torch.tensor(np.array(org)),
        resolution=torch.tensor(res), weight=torch.tensor(wgt),
        sampling=sampling)
    if sampling == "spline_coeff":
        jm, tm = jm.with_spline_coeffs(), tm.with_spline_coeffs()
    return jm, tm


def close(ours, ref, tol=TOL):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol)


# ----------------------------------------------------------- samplers


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_single_map_samplers_match(sampling):
    """The single-map samplers in f64, every kind of point."""
    jm, tm = maps(numpy_grids(0), sampling)
    xy = numpy_points(1)
    jxy, txy = jnp.asarray(xy), torch.tensor(xy)
    close(obstacles.bilinear_sample(tm.grid, tm.origin, tm.resolution, txy),
          jobs.bilinear_sample(jm.grid, jm.origin, jm.resolution, jxy))
    close(obstacles.obstacle_grad_xy(tm, txy),
          jobs.obstacle_grad_xy(jm, jxy))
    for a, b in zip(obstacles.obstacle_curv_xy(tm, txy),
                    jobs.obstacle_curv_xy(jm, jxy)):
        close(a, b)
    finite = np.isfinite(xy).all(axis=1)
    # the total over (..., 2) points: finite ones (a NaN sums to NaN)
    pts = xy[finite].reshape(-1, 2, 2)
    ours = float(obstacles.obstacle_cost(tm, torch.tensor(pts)))
    ref = float(jobs.obstacle_cost(jm, jnp.asarray(pts)))
    assert abs(ours - ref) <= TOL * max(1.0, abs(ref))
    if sampling != "bilinear":
        for a, b in zip(obstacles._spline_terms_xy(tm, txy),
                        jobs._spline_terms_xy(jm, jxy)):
            close(a, b)


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_lane_forms_match(sampling):
    """The lane-major forms over a batch of 6 maps, points (4, B)."""
    B = 6
    jm, tm = maps(numpy_grids(2, B), sampling, batch=B)
    pts = numpy_points(3, n=6)
    rng = np.random.default_rng(4)
    xy = pts[rng.permutation(len(pts))[:4 * B]].reshape(4, B, 2)
    x, y = xy[..., 0], xy[..., 1]
    jx, jy, tx, ty = jnp.asarray(x), jnp.asarray(y), torch.tensor(x), \
        torch.tensor(y)
    for a, b in zip(obstacles.obstacle_cost_grad_bl(tm, tx, ty),
                    jobs.obstacle_cost_grad_bl(jm, jx, jy)):
        close(a, b)
    for a, b in zip(obstacles.obstacle_curv_bl(tm, tx, ty),
                    jobs.obstacle_curv_bl(jm, jx, jy)):
        close(a, b)
    if sampling != "bilinear":
        for a, b in zip(obstacles._spline_terms_bl(tm, tx, ty),
                        jobs._spline_terms_bl(jm, jx, jy)):
            close(a, b)
    if sampling == "spline_coeff":
        for a, b in zip(obstacles._spline_coeff_terms_bl(tm, tx, ty),
                        jobs._spline_coeff_terms_bl(jm, jx, jy)):
            close(a, b)


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_single_map_forms_over_a_batch_are_the_vmap(sampling):
    """The single-map forms given a batch of maps and points (B, ..., 2):
    the JAX forms mapped over the maps with `jax.vmap`."""
    B = 5
    jm, tm = maps(numpy_grids(5, B), sampling, batch=B)
    pts = numpy_points(6, n=10)
    xy = np.stack([np.roll(pts, b, axis=0)[:24] for b in range(B)])
    jxy, txy = jnp.asarray(xy), torch.tensor(xy)
    close(obstacles.obstacle_grad_xy(tm, txy),
          jax.vmap(jobs.obstacle_grad_xy)(jm, jxy))
    for a, b in zip(obstacles.obstacle_curv_xy(tm, txy),
                    jax.vmap(jobs.obstacle_curv_xy)(jm, jxy)):
        close(a, b)


def test_spline_coeff_planes_match():
    """The coefficient planes of one grid and of a batch, f64."""
    close(obstacles.spline_coeff_planes(torch.tensor(numpy_grids(7))),
          jobs.spline_coeff_planes(jnp.asarray(numpy_grids(7))))
    g = numpy_grids(8, 3, h=5, w=3)
    close(obstacles.spline_coeff_planes(torch.tensor(g)),
          jobs.spline_coeff_planes(jnp.asarray(g)))


# ----------------------------------------------------- guards and errors


@pytest.mark.parametrize("route", ["stencil", "coeff_inline", "planes",
                                   "lane"])
def test_tiny_grid_guard(route):
    """A 2x2 grid has no spline centre knot: every spline route refuses it
    on both sides, the coefficient-plane route included."""
    g2 = np.full((2, 2), 0.5)
    for lib, mod in (("jax", jobs), ("torch", obstacles)):
        arr = (jnp.asarray if lib == "jax" else torch.tensor)
        if route == "planes":
            with pytest.raises(AssertionError, match="3x3"):
                mod.spline_coeff_planes(arr(g2))
            continue
        if route == "lane":
            m = mod.ObstacleMap(grid=arr(g2[None]), origin=arr(np.zeros((1, 2))),
                                resolution=arr(np.ones(1)),
                                weight=arr(np.ones(1)), sampling="spline")
            with pytest.raises(AssertionError, match="3x3"):
                mod.obstacle_cost_grad_bl(m, arr(np.zeros((1, 1))),
                                          arr(np.zeros((1, 1))))
            continue
        m = mod.ObstacleMap(
            grid=arr(g2), origin=arr(np.zeros(2)), resolution=arr(1.0),
            weight=arr(1.0),
            sampling="spline" if route == "stencil" else "spline_coeff")
        with pytest.raises(AssertionError, match="3x3"):
            mod.obstacle_grad_xy(m, arr(np.zeros((3, 2))))


def test_unknown_sampling_raises():
    """A misspelled mode raises the same ValueError on both sides."""
    for mod, arr in ((jobs, jnp.asarray), (obstacles, torch.tensor)):
        m = mod.ObstacleMap(grid=arr(numpy_grids(0)), origin=arr(ORIGIN),
                            resolution=arr(RES), weight=arr(1.0),
                            sampling="bicubic")
        with pytest.raises(ValueError, match="unknown ObstacleMap.sampling "
                                             "'bicubic'"):
            mod.obstacle_grad_xy(m, arr(np.zeros((2, 2))))


def test_with_grid_rederives_planes():
    """`with_grid` installs a grid and re-derives attached planes;
    `replace(grid=...)` keeps the stale ones (as in JAX); `empty` and
    `with_spline_coeffs` agree with JAX."""
    _, tm = maps(numpy_grids(0), "spline_coeff")
    new = numpy_grids(9)
    fresh = tm.with_grid(new)
    close(fresh.coeff, jobs.spline_coeff_planes(jnp.asarray(new)))
    stale = tm.replace(grid=torch.tensor(new))
    assert torch.equal(stale.coeff, tm.coeff)
    plain = tm.replace(coeff=None, sampling="bilinear").with_grid(new)
    assert plain.coeff is None
    e, je = obstacles.ObstacleMap.empty(weight=2.0), jobs.ObstacleMap.empty(
        weight=2.0)
    for f in ("grid", "origin", "resolution", "weight"):
        np.testing.assert_array_equal(getattr(e, f).numpy(),
                                      np.asarray(getattr(je, f)))
    with pytest.raises(AssertionError):
        e.with_spline_coeffs()


# ------------------------------------------------------------------ fits


@pytest.mark.parametrize("refine", [False, True])
def test_host_fit_matches(refine):
    """`fit_gaussians_to_map`, greedy and refined, in f64."""
    g = numpy_grids(10, h=16, w=16)
    jm, tm = maps(g, "bilinear", weight=40.0)
    ours = obstacles.fit_gaussians_to_map(tm, 3, refine=refine)
    ref = jobs.fit_gaussians_to_map(jm, 3, refine=refine)
    for f in ("cx", "cy", "gamma", "w"):
        close(getattr(ours, f), getattr(ref, f), tol=1e-9 if refine else TOL)


def test_device_fit_matches_jax():
    """`fit_gaussians_to_maps` in f64 against JAX's, a dead map (all
    zeros, every blob padding) among live ones."""
    g = numpy_grids(11, 4)
    g[2] = 0.0
    jm, tm = maps(g, "bilinear", weight=30.0, batch=4)
    ours = obstacles.fit_gaussians_to_maps(tm, 4)
    ref = jobs.fit_gaussians_to_maps(jm, 4)
    for f in ("cx", "cy", "gamma", "w"):
        close(getattr(ours, f), getattr(ref, f))


def test_device_fit_matches_host_greedy():
    """The bar of tests/test_obstacle_fit.py: the batched device fit in
    f32 reproduces the host greedy fit map for map (centres 1e-5, gamma
    5e-4, w 1e-4 relative)."""
    ms = [obstacles.gaussian_blob_map((0.8, 0.5), sigma=0.3, weight=100.0),
          obstacles.gaussian_blob_map((-0.5, 1.0), sigma=0.5, weight=50.0),
          obstacles.ObstacleMap.empty()]
    omaps = obstacles.ObstacleMap(*(torch.stack([getattr(m, f) for m in ms])
                                    for f in ("grid", "origin", "resolution",
                                              "weight")))
    dev = obstacles.fit_gaussians_to_maps(omaps, 4)
    for i, m in enumerate(ms):
        host = obstacles.fit_gaussians_to_map(m, 4, refine=False)
        for nm, tol in (("cx", 1e-5), ("cy", 1e-5), ("gamma", 5e-4),
                        ("w", 1e-4)):
            h = getattr(host, nm).double().numpy()
            d = getattr(dev, nm)[i].double().numpy()
            err = np.max(np.abs(h - d) / (1.0 + np.abs(h)))
            assert err < tol, (i, nm, h, d)


# ------------------------------------------------------ the synthetic map


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_gaussian_blob_map_within_one_ulp(sampling):
    """`gaussian_blob_map` in f32 within one float32 ulp of JAX's (the cell
    centres are `linspace`, which XLA compiles its own way), one map and
    a batch of 3; the mode and the planes as JAX sets them."""
    cx = np.array([0.8, -0.3, 1.1], np.float32)
    cy = np.array([0.5, 0.2, -0.7], np.float32)
    ref = jax.vmap(lambda a, b: jobs.gaussian_blob_map(
        (a, b), sigma=0.3, weight=100.0, sampling=sampling))(
            jnp.asarray(cx), jnp.asarray(cy))
    ours = obstacles.gaussian_blob_map(
        (torch.tensor(cx), torch.tensor(cy)), sigma=0.3, weight=100.0,
        sampling=sampling)
    one = obstacles.gaussian_blob_map((0.8, 0.5), sampling=sampling)
    jone = jobs.gaussian_blob_map((0.8, 0.5), sampling=sampling)
    for o, r in ((ours, ref), (one, jone)):
        assert o.sampling == r.sampling
        assert (o.coeff is None) == (r.coeff is None)
        for f in ("grid", "origin", "resolution", "weight"):
            a = getattr(o, f).numpy()
            b = np.asarray(getattr(r, f))
            assert a.shape == b.shape and a.dtype == b.dtype
            # XLA on the CPU flushes subnormal results to zero: below the
            # smallest normal float32 the two sides may part by that much
            ulp = np.maximum(np.spacing(np.maximum(np.abs(a), np.abs(b))),
                             np.finfo(np.float32).tiny)
            assert np.all(np.abs(a - b) <= ulp), f
        if o.coeff is not None:
            # the planes on equal grids: each is <= 9 products of a cell
            # by |A_pi A_qj| <= 0.5625 summed in float32, whose partial
            # sums stay below 4x the stencil's largest cell; XLA fuses and
            # orders them its own way, so the two sides part by at most 9
            # roundings of that size
            g = np.asarray(r.grid)
            gp = np.pad(g, [(0, 0)] * (g.ndim - 2) + [(1, 1), (1, 1)],
                        mode="edge")
            hh, ww = g.shape[-2:]
            local = np.max([gp[..., j:j + hh, i:i + ww] for j in range(3)
                            for i in range(3)], axis=0)
            tol = 9.0 * np.maximum(np.spacing(np.float32(4.0) * local),
                                   np.finfo(np.float32).tiny)[..., None]
            assert np.all(np.abs(o.coeff.numpy() - np.asarray(r.coeff))
                          <= tol)
