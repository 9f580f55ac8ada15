"""Depth map -> 3-D point cloud and the ground-plane height grid.

Port of ``trackiellm_tpu/ops/pointcloud.py``. Every quotient divides by a
0-dim tensor on the points' device: on CUDA torch computes ``t / 300.0``
(a Python number) as ``t * fl(1 / 300)``, one ulp from the CPU's and the
reference's quotient in many pixels. Products and sums are written as
separate elementwise ops (no matmul), so the card and the CPU round alike.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch


@functools.lru_cache(maxsize=256)
def _scalar(x: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32).to(device)


def scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-dim f32 tensor on ``like``'s device, copied there once
    per value (a tensor ``x`` passes through)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return _scalar(float(x), like.device)


def depth_to_point_cloud(depth_m: torch.Tensor, fx, fy, cx, cy
                         ) -> torch.Tensor:
    """Unproject an (H, W) metric depth map to camera-frame points
    (H*W, 3): X = (u - cx) * Z / fx, Y = (v - cy) * Z / fy, Z = depth.
    Depths <= 0 give rows of zeros."""
    h, w = depth_m.shape
    dev = depth_m.device
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    z = depth_m.float()
    x = (u - scalar(cx, z)) * z / scalar(fx, z)
    y = (v - scalar(cy, z)) * z / scalar(fy, z)
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    valid = (z > 0).reshape(-1, 1)
    return torch.where(valid, pts, 0.0)


def rotate_points(points: torch.Tensor, quat_wxyz: torch.Tensor
                  ) -> torch.Tensor:
    """Rotate (N, 3) points by a unit quaternion (w, x, y, z): the
    navigation engine's orientation correction."""
    q = quat_wxyz.to(device=points.device, dtype=torch.float32)
    w, x, y, z = q[0], q[1], q[2], q[3]
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])
    p = points
    cols = [p[:, 0] * rot[r, 0] + p[:, 1] * rot[r, 1] + p[:, 2] * rot[r, 2]
            for r in range(3)]
    return torch.stack(cols, dim=-1)


def grid_cells(x: torch.Tensor, z: torch.Tensor, grid_w: int, grid_d: int,
               cell_m, max_range_m: float) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Each point's flat (depth, lateral) cell, and whether it is in
    range; out-of-range points go to the dump cell grid_w * grid_d."""
    valid = (z > 0.05) & (z < max_range_m)
    cell = scalar(cell_m, x)
    col = (x / cell + grid_w / 2).to(torch.int32).clamp(0, grid_w - 1)
    row = (z / cell).to(torch.int32).clamp(0, grid_d - 1)
    flat = torch.where(valid, row * grid_w + col, grid_w * grid_d)
    return flat.long(), valid


def cell_reduce(flat: torch.Tensor, values: torch.Tensor, n_cells: int,
                how: str) -> torch.Tensor:
    """The max ("amax") or min ("amin") of ``values`` per flat cell, over
    n_cells + 1 cells (the last the dump cell), +-inf where none lands."""
    fill = -torch.inf if how == "amax" else torch.inf
    return torch.full((n_cells + 1,), fill, device=values.device
                      ).scatter_reduce(0, flat, values, how,
                                       include_self=True)


def points_to_height_grid(points: torch.Tensor, grid_w: int = 32,
                          grid_d: int = 32, cell_m: float = 0.25,
                          max_range_m: float = 8.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter points into a ground-plane (depth x lateral) grid: per-cell
    max height (-Y: camera Y points down) and sample count, each (grid_d,
    grid_w)."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    flat, valid = grid_cells(x, z, grid_w, grid_d, cell_m, max_range_m)
    n_cells = grid_w * grid_d
    heights = cell_reduce(flat, torch.where(valid, -y, -torch.inf), n_cells,
                          "amax")
    counts = torch.zeros((n_cells + 1,), dtype=torch.int32,
                         device=points.device).index_add_(0, flat,
                                                          valid.int())
    heights = torch.where(counts[:n_cells] > 0, heights[:n_cells], 0.0)
    return (heights.reshape(grid_d, grid_w),
            counts[:n_cells].reshape(grid_d, grid_w))
