"""Object/depth fusion and per-object attributes.

Port of ``trackiellm_tpu/vision/object_analysis.py``: all N boxes are fused
at once on the device (per-box region masks from broadcast coordinates,
masked statistics in one pass), with no per-object host loop; colour naming
from the fetched means is host code, copied.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from trackiellm_tpu_torch.ops.backend import exact_f32


def _central_masks(boxes: torch.Tensor, valid: torch.Tensor, h: int,
                   w: int) -> torch.Tensor:
    """(N, H, W) masks of each valid box's central 50% region."""
    dev = boxes.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    cx = (boxes[:, 0] + boxes[:, 2]) * 0.5
    cy = (boxes[:, 1] + boxes[:, 3]) * 0.5
    bw = (boxes[:, 2] - boxes[:, 0]).clamp_min(2.0)
    bh = (boxes[:, 3] - boxes[:, 1]).clamp_min(2.0)
    in_x = ((xs[None] >= (cx - bw * 0.25)[:, None, None])
            & (xs[None] <= (cx + bw * 0.25)[:, None, None]))
    in_y = ((ys[None] >= (cy - bh * 0.25)[:, None, None])
            & (ys[None] <= (cy + bh * 0.25)[:, None, None]))
    return in_x & in_y & valid[:, None, None]


def fuse_boxes_with_depth(boxes: torch.Tensor, valid: torch.Tensor,
                          depth_metric: torch.Tensor) -> torch.Tensor:
    """Per-box distances, (N, 2) [mean_m, min_m], over the central 50% of
    each box (``boxes`` xyxy in depth-map pixels): the central crop keeps
    background pixels at the box edges out."""
    h, w = depth_metric.shape
    mask = _central_masks(boxes, valid, h, w)
    d = depth_metric[None]
    count = mask.sum(dim=(1, 2)).clamp_min(1)
    mean = torch.where(mask, d, 0.0).sum(dim=(1, 2)) / count
    mn = torch.where(mask, d, torch.inf).amin(dim=(1, 2))
    mn = torch.where(torch.isfinite(mn), mn, 0.0)
    return torch.stack([mean, mn], dim=-1)


def box_color_stats(image_hwc: torch.Tensor, boxes: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Per-box mean RGB over the central region -> (N, 3); ``image_hwc``
    (H, W, 3) f32 in [0, 1]. The masked sum is one (N, H*W) x (H*W, 3)
    product in full f32."""
    h, w = image_hwc.shape[:2]
    mask = _central_masks(boxes, valid, h, w).reshape(boxes.shape[0], h * w)
    count = mask.sum(dim=1, keepdim=True).clamp_min(1)
    with exact_f32():
        sums = mask.float() @ image_hwc.reshape(h * w, 3)
    return sums / count


_COLOR_NAMES = (
    (0.0, "red"), (30.0, "orange"), (55.0, "yellow"), (90.0, "green"),
    (150.0, "cyan"), (210.0, "blue"), (270.0, "purple"), (330.0, "pink"),
    (360.0, "red"),
)


def rgb_to_color_name(rgb: np.ndarray) -> str:
    """Host-side colour naming from a mean RGB triple (the attribute
    classifier's 'color:x' tags)."""
    r, g, b = float(rgb[0]), float(rgb[1]), float(rgb[2])
    mx, mn = max(r, g, b), min(r, g, b)
    v, d = mx, mx - mn
    if v < 0.15:
        return "black"
    if d < 0.08:
        return "white" if v > 0.7 else "gray"
    if mx == r:
        hue = 60.0 * (((g - b) / d) % 6.0)
    elif mx == g:
        hue = 60.0 * ((b - r) / d + 2.0)
    else:
        hue = 60.0 * ((r - g) / d + 4.0)
    for bound, name in _COLOR_NAMES:
        if hue <= bound + 15.0:
            return name
    return "red"


def attributes_for(rgb_means: np.ndarray, valid: np.ndarray
                   ) -> List[List[str]]:
    """Per-object attribute tag lists from the fetched colour means."""
    out: List[List[str]] = []
    for i in range(rgb_means.shape[0]):
        if not valid[i]:
            out.append([])
            continue
        out.append([f"color:{rgb_to_color_name(rgb_means[i])}"])
    return out
