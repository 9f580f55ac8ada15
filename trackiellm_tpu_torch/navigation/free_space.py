"""Sector-based free-space analysis over the traversability grid.

A copy of ``trackiellm_tpu/navigation/free_space.py`` (framework-free;
only its import of ``CellClass`` differs).

Parity target: ``tk_free_space_detector`` — 7 sectors over a 90° FOV by
default (reference: src/navigation/tk_free_space_detector.c, config in
tk_cortex_main.c:808-812) and its Rust twin ``SpaceSector`` /
``FreeSpaceDetector`` (src/navigation/src/free_space.rs:20-121).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np

from trackiellm_tpu_torch.navigation.path_planner import CellClass


@dataclasses.dataclass
class SpaceSector:
    """Parity: SpaceSector (free_space.rs:20)."""

    center_deg: float
    clear_distance_m: float
    is_clear: bool


class FreeSpaceDetector:
    """Ray-march each sector from the observer cell until blocked."""

    def __init__(self, num_sectors: int = 7, fov_deg: float = 90.0,
                 clear_threshold_m: float = 1.5):
        self.num_sectors = num_sectors
        self.fov_deg = fov_deg
        self.clear_threshold_m = clear_threshold_m

    def analyze(self, grid: np.ndarray, cell_m: float = 0.25,
                ) -> List[SpaceSector]:
        """``grid``: (D, W) CellClass array, observer at row 0, center
        column, looking along +rows."""
        d, w = grid.shape
        origin_col = w / 2.0
        sectors: List[SpaceSector] = []
        half = self.fov_deg / 2.0
        step = self.fov_deg / self.num_sectors
        blocked = {int(CellClass.OBSTACLE), int(CellClass.HOLE)}

        for s in range(self.num_sectors):
            ang = -half + step * (s + 0.5)
            rad = math.radians(ang)
            dist = 0.0
            for r in range(d):
                row = r + 0.5
                col = origin_col + math.tan(rad) * row
                ci = int(col)
                if ci < 0 or ci >= w:
                    break
                cell = int(grid[r, ci])
                if cell in blocked:
                    break
                # Unknown cells don't extend confirmed clearance but
                # don't hard-block either; stop extending.
                if cell == int(CellClass.UNKNOWN):
                    break
                dist = (r + 1) * cell_m / max(math.cos(rad), 1e-6)
            sectors.append(SpaceSector(
                center_deg=ang,
                clear_distance_m=dist,
                is_clear=dist >= self.clear_threshold_m,
            ))
        return sectors

    def best_sector(self, grid: np.ndarray,
                    cell_m: float = 0.25) -> SpaceSector:
        return max(self.analyze(grid, cell_m),
                   key=lambda s: s.clear_distance_m)
