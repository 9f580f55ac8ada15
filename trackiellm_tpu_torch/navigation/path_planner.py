"""Navigation engine: depth -> point cloud -> RANSAC ground plane ->
traversability grid -> hazards.

Port of ``trackiellm_tpu/navigation/path_planner.py``. The 100 plane
hypotheses are fitted and scored at once on the device (a (100, N)
distance matrix) and the grid is a scatter into a dump row; only the small
grid crosses to the host, in one fetch, for classification and hazard
naming. RANSAC's (100, 3) point indices are drawn apart from the scoring
(:func:`draw_ransac_indices`, from a ``torch.Generator`` on the engine's
device), so a caller can score given indices: the CPU tests give it the
indices that ``jax.random.randint`` draws for the reference's key.

The plane's products and sums are separate elementwise ops, not matmuls,
so the card and the CPU score every hypothesis alike given the same points
and indices, and pick the same plane.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple

import numpy as np
import torch

from trackiellm_tpu_torch.ops.backend import default_device
from trackiellm_tpu_torch.ops.pointcloud import (
    cell_reduce,
    depth_to_point_cloud,
    grid_cells,
    rotate_points,
)

RANSAC_ITERS = 100          # the reference planner's iteration count
RANSAC_INLIER_M = 0.05      # and its inlier distance


class CellClass(enum.IntEnum):
    """Traversability-grid cell classes."""

    UNKNOWN = 0
    TRAVERSABLE = 1
    OBSTACLE = 2
    HOLE = 3
    STEP_UP = 4
    STEP_DOWN = 5


@dataclasses.dataclass
class NavigationConfig:
    grid_w: int = 32
    grid_d: int = 32
    cell_m: float = 0.25
    max_range_m: float = 8.0
    # Height-above-plane classification thresholds (meters).
    traversable_h: float = 0.05
    step_h: float = 0.15     # fixture: 0.15 m => obstacle boundary
    hole_h: float = -0.10
    # Camera intrinsics (defaults for a 640x480-ish depth map).
    fx: float = 300.0
    fy: float = 300.0


def draw_ransac_indices(gen: torch.Generator, n: int) -> torch.Tensor:
    """(RANSAC_ITERS, 3) point indices in [0, n), on ``gen``'s device."""
    return torch.randint(0, n, (RANSAC_ITERS, 3), generator=gen,
                         device=gen.device)


def _dot3(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Row-wise 3-vector dot products, summed left to right."""
    return (p[..., 0] * n[..., 0] + p[..., 1] * n[..., 1]
            + p[..., 2] * n[..., 2])


def ransac_ground_plane(points: torch.Tensor, idx: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit the dominant roughly horizontal plane from the hypotheses that
    ``idx`` (I, 3) names.

    ``points``: (N, 3) camera/world points (invalid rows may be zero).
    Returns (plane (4,), inlier_frac 0-dim): plane = [nx, ny, nz, d] with
    n . p + d = 0 and n . up >= 0 (up = -Y: camera Y points down)."""
    valid = (points != 0.0).any(dim=1)
    n_valid = valid.sum().clamp_min(1)

    idx = idx.to(points.device).long()
    p0, p1, p2 = points[idx[:, 0]], points[idx[:, 1]], points[idx[:, 2]]
    a, b = p1 - p0, p2 - p0
    normal = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                          a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                          a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)
    norm = torch.sqrt(_dot3(normal, normal))[:, None]
    normal = normal / norm.clamp_min(1e-9)
    up_dot = -normal[:, 1]  # normal . (0, -1, 0)
    sign = torch.sign(up_dot)[:, None]
    sign = torch.where(sign == 0, 1.0, sign)
    normal = normal * sign
    d = -_dot3(normal, p0)  # (I,)

    # Distances of every point to every hypothesis: (I, N).
    dist = torch.abs(_dot3(points[None], normal[:, None]) + d[:, None])
    inliers = ((dist < RANSAC_INLIER_M) & valid[None]).sum(dim=1)

    # Walls (n . up < 0.7) and degenerate triples score -1.
    horizontal = -normal[:, 1] >= 0.7
    degenerate = norm[:, 0] < 1e-9
    score = torch.where(horizontal & ~degenerate, inliers, -1)

    best = torch.argmax(score)
    plane = torch.cat([normal[best], d[best][None]])
    frac = score[best].float() / n_valid.float()
    return plane, frac.clamp_min(0.0)


def traversability_grid(points: torch.Tensor, plane: torch.Tensor,
                        grid_w: int = 32, grid_d: int = 32,
                        cell_m: float = 0.25, max_range_m: float = 8.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point height above the plane, scattered into a (D, W) grid:
    (max_height, min_height) per cell, NaN where a cell is empty."""
    h = _dot3(points, plane[:3]) + plane[3]
    flat, valid = grid_cells(points[:, 0], points[:, 2], grid_w, grid_d,
                             cell_m, max_range_m)
    n_cells = grid_w * grid_d
    hmax = cell_reduce(flat, torch.where(valid, h, -torch.inf), n_cells,
                       "amax")
    hmin = cell_reduce(flat, torch.where(valid, h, torch.inf), n_cells,
                       "amin")
    hmax = torch.where(torch.isfinite(hmax[:n_cells]), hmax[:n_cells],
                       torch.nan)
    hmin = torch.where(torch.isfinite(hmin[:n_cells]), hmin[:n_cells],
                       torch.nan)
    return hmax.reshape(grid_d, grid_w), hmin.reshape(grid_d, grid_w)


def classify_grid(hmax: np.ndarray, hmin: np.ndarray,
                  cfg: NavigationConfig) -> np.ndarray:
    """Host-side cell classification (tiny array, branchy rules)."""
    grid = np.full(hmax.shape, CellClass.UNKNOWN, np.int32)
    known = ~np.isnan(hmax)
    grid[known & (np.abs(hmax) <= cfg.traversable_h)] = CellClass.TRAVERSABLE
    grid[known & (hmax > cfg.traversable_h)
         & (hmax < cfg.step_h)] = CellClass.STEP_UP
    # Fixture contract: a 0.15 m vertical change classifies as Obstacle.
    grid[known & (hmax >= cfg.step_h)] = CellClass.OBSTACLE
    grid[known & (hmin < cfg.hole_h)
         & (hmax <= cfg.traversable_h)] = CellClass.HOLE
    step_down = known & (hmin < -cfg.traversable_h) & (hmin >= cfg.hole_h)
    grid[step_down & (grid != CellClass.OBSTACLE)] = CellClass.STEP_DOWN
    return grid


class NavigationEngine:
    """Update from a depth map, then the hazard and clear-path queries.

    The engine runs on ``device`` (the CUDA card by default; without one
    it raises unless the CPU is asked for) and draws RANSAC's indices from
    a generator there, seeded with ``seed``."""

    def __init__(self, config: Optional[NavigationConfig] = None,
                 seed: int = 0, device=None):
        self.config = config or NavigationConfig()
        self.device = default_device(device, "build a NavigationEngine")
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.grid: Optional[np.ndarray] = None
        self.plane: Optional[np.ndarray] = None
        self.inlier_frac: float = 0.0

    def update(self, depth_map_m, orientation_wxyz=None,
               indices: Optional[torch.Tensor] = None) -> np.ndarray:
        """Depth (H, W) meters (and an optional device orientation) -> the
        new traversability grid. ``indices`` (RANSAC_ITERS, 3) replaces
        the generator's draw."""
        cfg = self.config
        depth = (depth_map_m if isinstance(depth_map_m, torch.Tensor)
                 else torch.from_numpy(np.asarray(depth_map_m, np.float32))
                 ).to(self.device)
        h, w = depth.shape
        with torch.no_grad():
            pts = depth_to_point_cloud(depth, cfg.fx, cfg.fy, w / 2.0,
                                       h / 2.0)
            if orientation_wxyz is not None:
                pts = rotate_points(pts, torch.as_tensor(
                    np.asarray(orientation_wxyz, np.float32)))
            if indices is None:
                indices = draw_ransac_indices(self._gen, pts.shape[0])
            plane, frac = ransac_ground_plane(pts, indices)
            hmax, hmin = traversability_grid(
                pts, plane, cfg.grid_w, cfg.grid_d, cfg.cell_m,
                cfg.max_range_m)
            # One fetch: plane, fraction and both grids.
            host = torch.cat([plane, frac[None], hmax.reshape(-1),
                              hmin.reshape(-1)]).cpu().numpy()
        self.plane = host[:4].copy()
        self.inlier_frac = float(host[4])
        grids = host[5:].reshape(2, cfg.grid_d, cfg.grid_w)
        self.grid = classify_grid(grids[0], grids[1], cfg)
        return self.grid

    # -- queries --------------------------------------------------------

    def current_hazards(self, lookahead_m: float = 2.5) -> List[str]:
        """Hazard strings for cells in the near corridor ahead."""
        if self.grid is None:
            return []
        cfg = self.config
        rows = int(lookahead_m / cfg.cell_m)
        w = cfg.grid_w
        corridor = self.grid[:rows, w // 2 - 2: w // 2 + 3]
        hazards = []
        names = {
            CellClass.OBSTACLE: "obstáculo à frente",
            CellClass.HOLE: "buraco à frente",
            CellClass.STEP_UP: "degrau subindo à frente",
            CellClass.STEP_DOWN: "degrau descendo à frente",
        }
        for cls, name in names.items():
            hit = np.argwhere(corridor == cls)
            if hit.size:
                dist = (hit[:, 0].min() + 1) * cfg.cell_m
                hazards.append(f"{name} a {dist:.1f} m")
        return hazards

    def is_path_clear(self, lookahead_m: float = 2.0) -> bool:
        if self.grid is None:
            return False
        cfg = self.config
        rows = int(lookahead_m / cfg.cell_m)
        w = cfg.grid_w
        corridor = self.grid[:rows, w // 2 - 2: w // 2 + 3]
        bad = np.isin(corridor, (CellClass.OBSTACLE, CellClass.HOLE))
        return not bad.any()

    def describe_clear_path(self) -> str:
        from trackiellm_tpu_torch.navigation.free_space import (
            FreeSpaceDetector)

        if self.grid is None:
            return "mapa indisponível"
        det = FreeSpaceDetector()
        sectors = det.analyze(self.grid, self.config.cell_m)
        best = max(sectors, key=lambda s: s.clear_distance_m)
        if best.clear_distance_m < 0.5:
            return "nenhum caminho livre próximo"
        return (f"caminho livre a {best.center_deg:+.0f} graus por "
                f"{best.clear_distance_m:.1f} m")
