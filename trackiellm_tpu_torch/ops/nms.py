"""Box decode and non-maximum suppression at fixed shapes, on the boxes'
device.

Port of ``trackiellm_tpu/ops/nms.py``: a top-K pre-selection, one dense
K x K IoU matrix, and a K-step greedy sweep over mask vectors, all on the
device, so a frame's detections leave it only with the pipeline's one
fetch. The order of equal scores is the reference's: ``lax.top_k`` puts
the lower index first, and every score under the threshold is 0, so
thousands of anchors tie; a stable descending sort then the first K gives
the same candidates on the CPU and the card (``torch.topk`` does not
promise that order), and with them the same class-aware shift.

The sweep is sequential, as the reference's ``fori_loop``: three launches a
step on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Detections(NamedTuple):
    """Fixed-shape detection set; ``valid`` masks the real rows."""

    boxes: torch.Tensor    # (max_out, 4) xyxy in letterbox pixels
    scores: torch.Tensor   # (max_out,)
    classes: torch.Tensor  # (max_out,) int32
    valid: torch.Tensor    # (max_out,) bool


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between two xyxy box sets: (N, 4), (M, 4) -> (N, M)."""
    area_a = ((a[:, 2] - a[:, 0]).clamp_min(0)
              * (a[:, 3] - a[:, 1]).clamp_min(0))
    area_b = ((b[:, 2] - b[:, 0]).clamp_min(0)
              * (b[:, 3] - b[:, 1]).clamp_min(0))
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / union.clamp_min(1e-9)


def greedy_sweep(cand: torch.Tensor) -> torch.Tensor:
    """The K-step greedy suppression: ``cand[i, j]`` says that candidate
    i, if it survives, knocks out j. Returns the (K,) suppressed mask."""
    k = cand.shape[0]
    suppressed = torch.zeros((k,), dtype=torch.bool, device=cand.device)
    for i in range(k):
        suppressed |= cand[i] & ~suppressed[i]
    return suppressed


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
              iou_thresh: float = 0.45, max_out: int = 32) -> Detections:
    """Greedy NMS over K score-sorted candidates, fixed output shape.

    ``boxes`` (K, 4) xyxy, ``scores`` (K,); rows with score 0 are inert.
    Iteration i (a surviving box, in score order) knocks out every
    lower-scored box that overlaps it above ``iou_thresh``. ``classes`` of
    the result holds each survivor's index into ``boxes``."""
    k = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    boxes_s = boxes[order]
    scores_s = scores[order]

    iou = pairwise_iou(boxes_s, boxes_s)
    idx = torch.arange(k, device=boxes.device)
    lower = idx[None, :] > idx[:, None]  # j strictly after i in score order
    cand = lower & (iou > iou_thresh) & (scores_s > 0)[:, None]
    suppressed = greedy_sweep(cand)
    keep = ~suppressed & (scores_s > 0)

    # The first max_out kept rows, already in score order; the rest go to
    # a dump row (the reference's scatter drops ranks past it).
    kept_rank = torch.cumsum(keep.int(), 0) - 1
    slot = torch.where(keep & (kept_rank < max_out), kept_rank,
                       max_out).long()
    dev = boxes.device
    out_scores = torch.zeros((max_out + 1,), dtype=scores.dtype, device=dev)
    out_scores[slot] = scores_s
    out_boxes = torch.zeros((max_out + 1, 4), dtype=boxes.dtype, device=dev)
    out_boxes[slot] = boxes_s
    out_order = torch.full((max_out + 1,), -1, dtype=torch.int32, device=dev)
    out_order[slot] = order.int()
    valid = out_scores[:max_out] > 0
    return Detections(boxes=out_boxes[:max_out], scores=out_scores[:max_out],
                      classes=out_order[:max_out], valid=valid)


def top_k_first_index(values: torch.Tensor, k: int):
    """``lax.top_k`` on a vector: the k largest, the lower index first
    among equals."""
    top, idx = torch.sort(values, descending=True, stable=True)
    return top[:k], idx[:k]


@torch.no_grad()
def decode_and_nms(boxes_xyxy: torch.Tensor, class_scores: torch.Tensor,
                   score_thresh: float = 0.5, iou_thresh: float = 0.45,
                   pre_topk: int = 256, max_out: int = 32,
                   class_aware: bool = True) -> Detections:
    """The detector's postprocess: score filter, top-K, NMS.

    ``boxes_xyxy`` (A, 4) decoded boxes, ``class_scores`` (A, C) class
    probabilities. Class-aware NMS shifts each box by class_id * span, so
    boxes of two classes never overlap and one sweep serves all classes."""
    best_score, best_cls = class_scores.max(dim=-1)
    best_cls = best_cls.int()
    best_score = torch.where(best_score >= score_thresh, best_score, 0.0)

    k = min(pre_topk, boxes_xyxy.shape[0])
    top_scores, top_idx = top_k_first_index(best_score, k)
    top_boxes = boxes_xyxy[top_idx]
    top_cls = best_cls[top_idx]

    if class_aware:
        span = top_boxes.max() + 1.0
        nms_boxes = top_boxes + (top_cls.to(top_boxes.dtype) * span)[:, None]
    else:
        nms_boxes = top_boxes

    det = nms_fixed(nms_boxes, top_scores, iou_thresh, max_out)
    # det.classes indexes the score-sorted candidates (nms_fixed's order).
    sel = det.classes.clamp_min(0).long()
    boxes_out = torch.where(det.valid[:, None], top_boxes[sel], 0.0)
    cls_out = torch.where(det.valid, top_cls[sel], -1)
    return Detections(boxes=boxes_out, scores=det.scores, classes=cls_out,
                      valid=det.valid)


def boxes_to_original(boxes: torch.Tensor, meta: torch.Tensor
                      ) -> torch.Tensor:
    """Letterbox xyxy boxes back to camera pixels, from the ``[scale,
    pad_x, pad_y]`` of :func:`trackiellm_tpu_torch.ops.preprocess.
    letterbox_preprocess` (a division by the device's scale, as the
    reference divides)."""
    shift = meta[[1, 2, 1, 2]]
    return (boxes - shift) / meta[0]
