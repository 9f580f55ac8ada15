"""Frame-to-frame obstacle tracking in metric ground coordinates.

Parity target: ``tk_obstacle_avoider`` and its Rust twin
``TrackedObstacle`` / ``ObstacleTracker`` (reference:
src/navigation/tk_obstacle_avoider.c, src/navigation/src/
obstacle_tracker.rs:21-74), configured with a max-match distance and an
unseen-frame expiry (tk_cortex_main.c:821-826).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from trackiellm_tpu_torch.navigation.path_planner import CellClass


@dataclasses.dataclass
class TrackedObstacle:
    obstacle_id: int
    position_m: Tuple[float, float]  # (x lateral, z forward)
    size_m: Tuple[float, float]
    unseen_frames: int = 0
    age_frames: int = 1


def obstacles_from_grid(grid: np.ndarray, cell_m: float = 0.25,
                        ) -> List[Tuple[Tuple[float, float],
                                        Tuple[float, float]]]:
    """Extract obstacle blobs as (center_m, size_m) via 4-connected
    flood fill over OBSTACLE cells (host; the grid is tiny)."""
    d, w = grid.shape
    seen = np.zeros_like(grid, bool)
    out = []
    for r in range(d):
        for c in range(w):
            if grid[r, c] != CellClass.OBSTACLE or seen[r, c]:
                continue
            stack = [(r, c)]
            cells = []
            seen[r, c] = True
            while stack:
                rr, cc = stack.pop()
                cells.append((rr, cc))
                for nr, nc in ((rr+1, cc), (rr-1, cc), (rr, cc+1), (rr, cc-1)):
                    if (0 <= nr < d and 0 <= nc < w and not seen[nr, nc]
                            and grid[nr, nc] == CellClass.OBSTACLE):
                        seen[nr, nc] = True
                        stack.append((nr, nc))
            arr = np.array(cells, float)
            rc = arr.mean(0)
            span = arr.max(0) - arr.min(0) + 1
            center = ((rc[1] - w / 2.0 + 0.5) * cell_m,
                      (rc[0] + 0.5) * cell_m)
            out.append((center, (span[1] * cell_m, span[0] * cell_m)))
    return out


class ObstacleTracker:
    """Nearest-neighbour association with expiry."""

    def __init__(self, max_match_distance_m: float = 0.75,
                 max_unseen_frames: int = 10):
        self.max_match_distance_m = max_match_distance_m
        self.max_unseen_frames = max_unseen_frames
        self._tracks: Dict[int, TrackedObstacle] = {}
        self._next_id = 1

    def update(self, observations: Sequence[Tuple[Tuple[float, float],
                                                  Tuple[float, float]]],
               ) -> List[TrackedObstacle]:
        """``observations``: list of (center_m, size_m). Returns live
        tracks after association."""
        unmatched = dict(self._tracks)
        for center, size in observations:
            best_id, best_d = None, self.max_match_distance_m
            for tid, tr in unmatched.items():
                dd = ((tr.position_m[0] - center[0]) ** 2
                      + (tr.position_m[1] - center[1]) ** 2) ** 0.5
                if dd < best_d:
                    best_id, best_d = tid, dd
            if best_id is not None:
                tr = unmatched.pop(best_id)
                tr.position_m = center
                tr.size_m = size
                tr.unseen_frames = 0
                tr.age_frames += 1
            else:
                tr = TrackedObstacle(self._next_id, center, size)
                self._tracks[tr.obstacle_id] = tr
                self._next_id += 1

        # Age the ones we didn't see; expire stale tracks.
        for tid, tr in list(self._tracks.items()):
            if tid in unmatched:
                tr.unseen_frames += 1
                if tr.unseen_frames > self.max_unseen_frames:
                    del self._tracks[tid]
        return list(self._tracks.values())

    @property
    def tracks(self) -> List[TrackedObstacle]:
        return list(self._tracks.values())
