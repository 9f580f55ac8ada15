"""The port's navigation path against the JAX package on the CPU: the point
cloud, the rotation, the height grid, RANSAC given the reference's indices,
the traversability grid, classification, the engine and free space.

Inputs come from numpy seeds (the reference tests' synthetic floor and
depth maps). Tolerances: the unprojection and the height grid exact (both
divide by the focal length and the cell size); planes 1e-6 max abs, 1e-5
where the points were rotated (the reference rotates by a matmul, the port
by elementwise products); counts, inlier fractions, grids, classes,
hazards and sectors equal.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_navigation import _floor_cloud, _synthetic_depth
from trackiellm_tpu.navigation import free_space as jfs
from trackiellm_tpu.navigation import path_planner as jpp
from trackiellm_tpu.ops import pointcloud as jpc
from trackiellm_tpu_torch.navigation import free_space as tfs
from trackiellm_tpu_torch.navigation import path_planner as tpp
from trackiellm_tpu_torch.ops import pointcloud as tpc

CPU = torch.device("cpu")
PLANE_TOL = 1e-6


def _jax_indices(key, n):
    """The (100, 3) indices the JAX planner draws for ``key``."""
    return torch.from_numpy(np.array(jax.random.randint(
        key, (jpp.RANSAC_ITERS, 3), 0, n)))


def _scene(seed, n=3000, outliers=400):
    """A floor 1.2 m below the camera, a box on it and scattered
    outliers; zero rows stand for invalid depths."""
    rng = np.random.default_rng(seed)
    pts = _floor_cloud(n, cam_height=1.2, seed=seed, noise=0.02)
    box = np.stack([rng.uniform(-0.5, 0.5, 300), rng.uniform(0.9, 1.2, 300),
                    rng.uniform(2.0, 2.6, 300)], -1)
    junk = rng.uniform([-4, -2, 0], [4, 2, 9], (outliers, 3))
    pts = np.concatenate([pts, box, junk]).astype(np.float32)
    pts[rng.random(len(pts)) < 0.05] = 0.0
    return pts


@pytest.mark.parametrize("shape", [(120, 160), (48, 64)])
def test_point_cloud_matches_jax(shape):
    depth = _synthetic_depth(*shape, obstacle={"z": 1.5})
    args = (300.0, 280.0, shape[1] / 2.0, shape[0] / 2.0)
    ref = np.asarray(jpc.depth_to_point_cloud(jnp.asarray(depth), *args))
    got = tpc.depth_to_point_cloud(torch.from_numpy(depth), *args).numpy()
    np.testing.assert_array_equal(got, ref)


def test_rotate_points_matches_jax():
    pts = _scene(1)
    q = np.asarray([math.cos(0.2), 0.1, math.sin(0.2) * 0.8, 0.2],
                   np.float32)
    q /= np.linalg.norm(q)
    ref = np.asarray(jpc.rotate_points(jnp.asarray(pts), jnp.asarray(q)))
    got = tpc.rotate_points(torch.from_numpy(pts), torch.from_numpy(q))
    assert np.abs(got.numpy() - ref).max() <= PLANE_TOL * 10


def test_height_grid_matches_jax():
    pts = _scene(2)
    rh, rc = jpc.points_to_height_grid(jnp.asarray(pts), 24, 28, 0.3, 7.0)
    gh, gc = tpc.points_to_height_grid(torch.from_numpy(pts), 24, 28, 0.3,
                                       7.0)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(rh))
    assert gc.sum() > 1000


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ransac_given_jax_indices_matches_jax(seed):
    pts = _scene(seed)
    key = jax.random.PRNGKey(seed)
    rp, rf = jpp.ransac_ground_plane(jnp.asarray(pts), key)
    gp, gf = tpp.ransac_ground_plane(torch.from_numpy(pts),
                                     _jax_indices(key, len(pts)))
    assert np.abs(gp.numpy() - np.asarray(rp)).max() <= PLANE_TOL
    assert float(gf) == float(rf) > 0.3
    # The plane found is the floor: normal up (-Y), 1.2 m below.
    assert gp[1] < -0.95 and abs(float(gp[3]) - 1.2) < 0.1


def test_ransac_refuses_walls_and_degenerate_triples():
    """All hypotheses on a wall (x = 1) or degenerate score -1: the
    fraction clamps to 0, as the reference's does."""
    rng = np.random.default_rng(4)
    wall = np.stack([np.ones(200), rng.uniform(-1, 1, 200),
                     rng.uniform(1, 3, 200)], -1).astype(np.float32)
    key = jax.random.PRNGKey(9)
    rp, rf = jpp.ransac_ground_plane(jnp.asarray(wall), key)
    gp, gf = tpp.ransac_ground_plane(torch.from_numpy(wall),
                                     _jax_indices(key, len(wall)))
    assert float(gf) == float(rf) == 0.0
    assert np.abs(gp.numpy() - np.asarray(rp)).max() <= PLANE_TOL


@pytest.mark.parametrize("seed", [0, 5])
def test_traversability_grid_and_classes_match_jax(seed):
    pts = _scene(seed)
    key = jax.random.PRNGKey(seed)
    plane, _ = jpp.ransac_ground_plane(jnp.asarray(pts), key)
    rmax, rmin = jpp.traversability_grid(jnp.asarray(pts), plane)
    gmax, gmin = tpp.traversability_grid(torch.from_numpy(pts),
                                         torch.from_numpy(np.array(plane)))
    rmax, rmin = np.asarray(rmax), np.asarray(rmin)
    np.testing.assert_array_equal(np.isnan(gmax.numpy()), np.isnan(rmax))
    np.testing.assert_allclose(gmax.numpy(), rmax, atol=PLANE_TOL)
    np.testing.assert_allclose(gmin.numpy(), rmin, atol=PLANE_TOL)
    cfg = tpp.NavigationConfig()
    got = tpp.classify_grid(gmax.numpy(), gmin.numpy(), cfg)
    ref = jpp.classify_grid(rmax, rmin, jpp.NavigationConfig())
    np.testing.assert_array_equal(got, ref)
    assert len(np.unique(got)) >= 3


@pytest.mark.parametrize("scene", ["clear", "obstacle", "near_obstacle",
                                   "hole", "rotated"])
def test_engine_given_jax_indices_matches_jax(scene):
    """Two updates on each side; the port's engine scores the indices the
    JAX engine draws from its key, and gives its grids, plane, fraction,
    hazards, clear-path answers and free-space sectors."""
    depth = _far_wall({
        "clear": lambda: _synthetic_depth(),
        "obstacle": lambda: _synthetic_depth(obstacle={"z": 1.5}),
        "near_obstacle": lambda: _synthetic_depth(
            obstacle={"z": 0.9, "half_w_px": 40}),
        "hole": lambda: _hole_depth(),
        "rotated": lambda: _synthetic_depth(obstacle={"z": 2.0})}[scene]())
    quat = (np.asarray([0.995, 0.0998, 0.0, 0.0], np.float32)
            if scene == "rotated" else None)
    ref = jpp.NavigationEngine(seed=3)
    got = tpp.NavigationEngine(seed=3, device=CPU)
    for _ in range(2):
        key = jax.random.split(ref._key)[1]
        grid = ref.update(depth, quat)
        idx = _jax_indices(key, depth.size)
        np.testing.assert_array_equal(got.update(depth, quat, indices=idx),
                                      grid)
        assert got.inlier_frac == ref.inlier_frac
        # Rotated points round apart: the reference rotates by a matmul.
        tol = PLANE_TOL * (10 if quat is not None else 1)
        assert np.abs(got.plane - ref.plane).max() <= tol
        for la in (1.0, 2.5, 4.0):
            assert got.current_hazards(la) == ref.current_hazards(la)
            assert got.is_path_clear(la) == ref.is_path_clear(la)
        assert got.describe_clear_path() == ref.describe_clear_path()
    if scene == "obstacle":
        assert any("obstáculo" in h for h in got.current_hazards())
        assert not got.is_path_clear()


def _far_wall(depth):
    """The synthetic map with its empty pixels at 9.5 m (a wall past the
    grid's range), as the pipeline's metric maps have no empty pixel.

    With empty pixels a hypothesis can draw the same point twice: its
    cross product is then zero, and the reference's jitted program, which
    contracts the cross product's products into FMAs, leaves a rounding
    residue that it normalizes into a plane. The port computes the exact
    zero and rejects the triple, so the two pick different planes."""
    depth = depth.copy()
    depth[depth == 0] = 9.5
    return depth


def _hole_depth():
    """The floor with a pit: rows whose floor lies 0.3 m lower."""
    depth = _synthetic_depth()
    h, w = depth.shape
    cy = h / 2.0
    rows = np.arange(h)
    pit = (rows > cy + 20) & (rows < cy + 30)
    depth[pit, w // 2 - 20:w // 2 + 20] = (
        300.0 * 1.3 / np.maximum(rows[pit] - cy, 1e-6))[:, None]
    return depth


def test_engine_draws_from_its_generator():
    """Without indices the engine draws RANSAC's from its own generator:
    seeded engines agree, and the draw covers the points."""
    depth = _synthetic_depth(obstacle={"z": 1.5})
    a = tpp.NavigationEngine(seed=7, device=CPU)
    b = tpp.NavigationEngine(seed=7, device=CPU)
    np.testing.assert_array_equal(a.update(depth), b.update(depth))
    assert a.inlier_frac == b.inlier_frac > 0.5
    idx = tpp.draw_ransac_indices(torch.Generator().manual_seed(0), 50)
    assert idx.shape == (tpp.RANSAC_ITERS, 3)
    assert 0 <= int(idx.min()) and int(idx.max()) < 50
    empty = tpp.NavigationEngine(device=CPU)
    assert empty.current_hazards() == [] and not empty.is_path_clear()
    assert empty.describe_clear_path() == "mapa indisponível"


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sectors,fov", [(7, 90.0), (5, 120.0)])
def test_free_space_matches_jax(seed, sectors, fov):
    rng = np.random.default_rng(seed)
    grid = rng.choice([0, 1, 1, 1, 2, 3, 4], size=(32, 32)).astype(np.int32)
    grid[:6, 12:20] = 1
    ref = jfs.FreeSpaceDetector(sectors, fov).analyze(grid, 0.25)
    got = tfs.FreeSpaceDetector(sectors, fov).analyze(grid, 0.25)
    assert [vars(s) for s in got] == [vars(s) for s in ref]
    assert vars(tfs.FreeSpaceDetector().best_sector(grid)) == vars(
        jfs.FreeSpaceDetector().best_sector(grid))
    assert [int(c) for c in tpp.CellClass] == [int(c) for c in jpp.CellClass]
