"""Vision pipeline: per-frame detection, depth, OCR, fusion, attributes,
scene graph and navigation cues.

Port of ``trackiellm_tpu/vision/pipeline.py``. The analyses are gated by a
flag mask; OCR is also triggered when a text-bearing label is detected;
detections are fused with depth for distances; the scene graph is built on
the host; a stage that fails logs, clears its ``valid_analyses`` bit and
lets the frame go on; thresholds can be changed at run time.

The device work of a frame (letterbox, detector, NMS, the mapping back to
camera pixels, the depth normalization and model, the metric mapping and
the box-depth fusion) is all dispatched first, then fetched to the host in
**one** copy of one packed f32 buffer. ``timings_ms`` are host dispatch
times, as in the reference (a caller that wants device time synchronizes).
Model backends are injected callables, so the pipeline runs with stub
models in the tests. The pipeline runs on ``device``: the CUDA card by
default, the CPU when asked for.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trackiellm_tpu_torch.models.depth import relative_to_metric
from trackiellm_tpu_torch.models.detector import COCO_LABELS
from trackiellm_tpu_torch.ops.backend import default_device
from trackiellm_tpu_torch.ops.nms import boxes_to_original, decode_and_nms
from trackiellm_tpu_torch.ops.pointcloud import scalar
from trackiellm_tpu_torch.ops.preprocess import (
    as_frame,
    dpt_normalize_chw,
    imagenet_normalize_chw,
    letterbox_preprocess,
)
from trackiellm_tpu_torch.utils.logging import get_logger
from trackiellm_tpu_torch.vision import object_analysis as oa
from trackiellm_tpu_torch.vision.scene_graph import (
    SceneNode,
    build_scene_graph,
)

log = get_logger("vision.pipeline")


class AnalysisFlags(enum.IntFlag):
    """The reference's TK_VISION_ANALYZE_* bitmask."""

    NONE = 0
    DETECTION = 1 << 0
    DEPTH = 1 << 1
    OCR = 1 << 2
    ATTRIBUTES = 1 << 3
    SCENE_GRAPH = 1 << 4
    NAVIGATION = 1 << 5
    ALL = DETECTION | DEPTH | OCR | ATTRIBUTES | SCENE_GRAPH | NAVIGATION


# Labels that trigger OCR when detected.
TEXT_BEARING_LABELS = frozenset(
    {"stop sign", "book", "tv", "laptop", "cell phone", "clock"})


@dataclasses.dataclass
class VisionConfig:
    """Run-time pipeline parameters."""

    confidence_threshold: float = 0.5
    iou_threshold: float = 0.45
    max_objects: int = 20
    detector_input: int = 640
    depth_input: int = 384
    # Depth-model input statistics: "imagenet" for MiDaS v2.1-small, "dpt"
    # ((x - 0.5) / 0.5) for the DPT-SwinV2 family; with "dpt" set
    # depth_input to the DPT config's image_size (256/384).
    depth_preproc: str = "imagenet"
    min_depth_m: float = 0.3
    max_depth_m: float = 10.0
    labels: Tuple[str, ...] = COCO_LABELS
    ocr_crop_hw: Tuple[int, int] = (32, 128)
    # Full-page OCR tiling (rows, cols): an explicit OCR flag scans the
    # whole frame as a strip grid, not only detection crops.
    ocr_page_grid: Tuple[int, int] = (4, 2)
    # Optional regex on recognized texts; non-matching results are dropped.
    ocr_text_filter: Optional[str] = None


@dataclasses.dataclass
class DetectedObject:
    class_id: int
    label: str
    confidence: float
    box: List[float]  # xyxy camera pixels
    distance_m: Optional[float] = None
    min_distance_m: Optional[float] = None
    attributes: List[str] = dataclasses.field(default_factory=list)
    text: Optional[str] = None  # OCR result if this object triggered it


@dataclasses.dataclass
class TextRegion:
    """A recognized text span with its frame-pixel box."""

    box: List[float]  # xyxy camera pixels
    text: str


@dataclasses.dataclass
class VisionResult:
    frame_id: int
    objects: List[DetectedObject]
    depth_map_m: Optional[np.ndarray]
    scene_graph: Optional[Dict[str, Any]]
    valid_analyses: AnalysisFlags
    timings_ms: Dict[str, float]
    barcodes: List[str] = dataclasses.field(default_factory=list)
    navigation_cues: List[str] = dataclasses.field(default_factory=list)
    # Full-page OCR: per-region texts and their concatenation in reading
    # order (top to bottom, left to right).
    text_regions: List["TextRegion"] = dataclasses.field(
        default_factory=list)
    full_text: str = ""


# Injected model backends (real models or test stubs); the detector and
# depth backends return tensors on the pipeline's device:
DetectorFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
DepthFn = Callable[[torch.Tensor], torch.Tensor]
OCRFn = Callable[[np.ndarray], List[str]]


def _host_resize_gray(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Nearest-neighbour host resize for OCR crops (crop shapes vary)."""
    in_h, in_w = img.shape[:2]
    ys = np.clip(((np.arange(out_h) + 0.5) * in_h / out_h).astype(int),
                 0, in_h - 1)
    xs = np.clip(((np.arange(out_w) + 0.5) * in_w / out_w).astype(int),
                 0, in_w - 1)
    return img[ys][:, xs]


def host_frame(frame) -> np.ndarray:
    """An HWC frame as a host array: a tensor (on the card or the CPU) is
    fetched once, anything else goes through ``np.asarray``."""
    if isinstance(frame, torch.Tensor):
        return frame.cpu().numpy()
    return np.asarray(frame)


def fetch(tensors: List[Optional[torch.Tensor]]
          ) -> List[Optional[np.ndarray]]:
    """Every given tensor on the host in one device-to-host copy: each is
    flattened to f32 (exact for the boxes, scores, class ids, masks and
    maps sent here), packed, copied, and cut back to its shape and dtype.
    None stays None."""
    live = [t for t in tensors if t is not None]
    if not live:
        return [None] * len(tensors)
    host = torch.cat([t.reshape(-1).float() for t in live]).cpu().numpy()
    out: List[Optional[np.ndarray]] = []
    at = 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        n = t.numel()
        a = host[at:at + n].reshape(tuple(t.shape))
        at += n
        if t.dtype == torch.bool:
            a = a != 0
        elif not t.dtype.is_floating_point:
            a = a.astype(np.int32)
        out.append(a)
    return out


class VisionPipeline:
    """Host orchestrator over the device programs."""

    def __init__(
        self,
        detector_fn: Optional[DetectorFn],
        depth_fn: Optional[DepthFn] = None,
        ocr_fn: Optional[OCRFn] = None,
        config: Optional[VisionConfig] = None,
        barcode_fn: Optional[Callable] = None,
        navigation_engine=None,
        device=None,
    ):
        self.detector_fn = detector_fn
        self.depth_fn = depth_fn
        self.ocr_fn = ocr_fn
        # QR/barcode hook: called on the grayscale frame whenever OCR runs;
        # results land in VisionResult.barcodes.
        self.barcode_fn = barcode_fn
        # Navigation cues over the depth grid.
        self.navigation_engine = navigation_engine
        self.config = config or VisionConfig()
        self.device = default_device(device, "build a VisionPipeline")
        self._frame_counter = 0
        # OCR results keyed by crop hash, with expiry.
        self._ocr_cache: Dict[str, Tuple[str, float]] = {}
        self.ocr_cache_ttl_s = 30.0
        self.ocr_cache_hits = 0
        # "<stage>: <error>" -> frames it degraded. A stage's error clears
        # its bit and the frame goes on; the count keeps it visible.
        self.stage_failures: Dict[str, int] = {}

    def _stage_failed(self, stage: str, error: Exception) -> None:
        log.warning("%s failed on frame %d: %s", stage, self._frame_counter,
                    error)
        key = f"{stage}: {error!r}"
        self.stage_failures[key] = self.stage_failures.get(key, 0) + 1

    def update_thresholds(self, confidence: Optional[float] = None,
                          iou: Optional[float] = None,
                          max_objects: Optional[int] = None) -> None:
        if confidence is not None:
            self.config.confidence_threshold = confidence
        if iou is not None:
            self.config.iou_threshold = iou
        if max_objects is not None:
            self.config.max_objects = max_objects

    def _on_device(self, t) -> torch.Tensor:
        return torch.as_tensor(t, device=self.device)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def process_frame(self, frame_hwc_u8: np.ndarray,
                      flags: AnalysisFlags = AnalysisFlags.ALL,
                      orientation_wxyz=None) -> VisionResult:
        cfg = self.config
        self._frame_counter += 1
        valid = AnalysisFlags.NONE
        timings: Dict[str, float] = {}
        objects: List[DetectedObject] = []
        depth_map: Optional[np.ndarray] = None
        graph = None

        frame = as_frame(frame_hwc_u8, self.device)

        # --- detection + depth: dispatch everything, fetch once ---------
        det_dev = None
        depth_dev = None
        stats_dev = None
        t_det = t_dep = 0.0
        if flags & AnalysisFlags.DETECTION and self.detector_fn is not None:
            t0 = time.perf_counter()
            try:
                chw, meta = letterbox_preprocess(
                    frame, cfg.detector_input, cfg.detector_input)
                raw_boxes, cls_probs = self.detector_fn(chw)
                det = decode_and_nms(
                    raw_boxes, cls_probs,
                    score_thresh=cfg.confidence_threshold,
                    iou_thresh=cfg.iou_threshold,
                    max_out=cfg.max_objects)
                cam_boxes = boxes_to_original(det.boxes, meta)
                det_dev = (cam_boxes, det.scores, det.classes, det.valid)
            except Exception as e:  # degradation, not failure
                self._stage_failed("detection", e)
            t_det = time.perf_counter() - t0

        if flags & AnalysisFlags.DEPTH and self.depth_fn is not None:
            t0 = time.perf_counter()
            try:
                depth_norm = (dpt_normalize_chw
                              if cfg.depth_preproc == "dpt"
                              else imagenet_normalize_chw)
                chw = depth_norm(frame, cfg.depth_input, cfg.depth_input)
                rel = self.depth_fn(chw)
                depth_dev = relative_to_metric(rel, cfg.min_depth_m,
                                               cfg.max_depth_m)
                if det_dev is not None:
                    h, w = frame_hwc_u8.shape[:2]
                    dh, dw = depth_dev.shape
                    scale = self._on_device(np.asarray(
                        [dw / w, dh / h, dw / w, dh / h], np.float32))
                    stats_dev = oa.fuse_boxes_with_depth(
                        det_dev[0] * scale, det_dev[3], depth_dev)
            except Exception as e:
                self._stage_failed("depth", e)
            t_dep = time.perf_counter() - t0

        # one host copy for every device output of both stages
        try:
            host = fetch([*(det_dev or (None,) * 4), depth_dev, stats_dev])
            det_host = None if det_dev is None else host[:4]
            depth_host, stats_host = host[4], host[5]
        except Exception as e:
            self._stage_failed("vision fetch", e)
            det_host = depth_host = stats_host = None

        if det_host is not None:
            cam_np, scores_np, classes_np, valid_mask = det_host
            for i in range(len(valid_mask)):
                if not valid_mask[i]:
                    continue
                cid = int(classes_np[i])
                label = (cfg.labels[cid]
                         if 0 <= cid < len(cfg.labels) else f"class{cid}")
                obj = DetectedObject(
                    class_id=cid, label=label,
                    confidence=float(scores_np[i]),
                    box=[float(v) for v in cam_np[i]])
                if stats_host is not None:
                    obj.distance_m = float(stats_host[i, 0])
                    obj.min_distance_m = float(stats_host[i, 1])
                objects.append(obj)
            valid |= AnalysisFlags.DETECTION
        if depth_host is not None:
            depth_map = depth_host
            valid |= AnalysisFlags.DEPTH
        timings["detection"] = t_det * 1e3
        timings["depth"] = t_dep * 1e3

        # --- attributes ---------------------------------------------------
        if flags & AnalysisFlags.ATTRIBUTES and objects:
            t0 = time.perf_counter()
            try:
                # A division by the device's 255, as the reference divides.
                img01 = frame.float() / scalar(255.0, frame)
                bx = self._on_device(np.stack([np.asarray(o.box, np.float32)
                                               for o in objects]))
                ok = torch.ones((len(objects),), dtype=torch.bool,
                                device=self.device)
                rgb = oa.box_color_stats(img01, bx, ok).cpu().numpy()
                tags = oa.attributes_for(rgb, np.ones(len(objects), bool))
                for obj, t in zip(objects, tags):
                    obj.attributes = t
                valid |= AnalysisFlags.ATTRIBUTES
            except Exception as e:
                self._stage_failed("attributes", e)
            timings["attributes"] = (time.perf_counter() - t0) * 1e3

        # --- OCR (explicit or auto-triggered) ----------------------------
        # Auto-trigger reads detection crops; an explicit OCR flag also
        # scans the whole frame as a strip grid and returns text regions,
        # so a sign with no detected text-bearing box is still read.
        barcodes: List[str] = []
        text_regions: List[TextRegion] = []
        want_ocr = bool(flags & AnalysisFlags.OCR)
        auto = [o for o in objects if o.label in TEXT_BEARING_LABELS]
        if self.ocr_fn is not None and (want_ocr or auto):
            t0 = time.perf_counter()
            try:
                # One fetch of a frame already on the card; the gray image
                # is then the numpy path's, byte for byte.
                gray = host_frame(frame_hwc_u8).astype(np.float32).mean(-1) \
                    / 255.0
                h, w = gray.shape
                now = time.monotonic()
                self._ocr_cache = {
                    k: v for k, v in self._ocr_cache.items()
                    if now - v[1] < self.ocr_cache_ttl_s
                }

                # One batched model pass covers the detection crops and
                # the page grid; sinks record where each text lands.
                crops, fresh = [], []

                def stage(region_gray, key_salt, sink):
                    crop = _host_resize_gray(region_gray,
                                             *cfg.ocr_crop_hw)
                    key = hashlib.md5(
                        np.ascontiguousarray(crop)).hexdigest() + key_salt
                    cached = self._ocr_cache.get(key)
                    if cached is not None:
                        sink(cached[0])
                        self.ocr_cache_hits += 1
                    else:
                        crops.append(crop)
                        fresh.append((key, sink))

                for o in auto:
                    x1, y1, x2, y2 = [int(max(v, 0)) for v in o.box]
                    stage(gray[y1:max(y2, y1 + 2), x1:max(x2, x1 + 2)],
                          "", lambda t, o=o: setattr(o, "text", t))

                if want_ocr:
                    rows, cols = cfg.ocr_page_grid
                    bh, bw = h // rows, w // cols
                    for r in range(rows):
                        for c in range(cols):
                            y1, x1 = r * bh, c * bw
                            box = [float(x1), float(y1),
                                   float(x1 + bw), float(y1 + bh)]

                            def add_region(t, box=box):
                                if t and self._text_passes_filter(t):
                                    text_regions.append(
                                        TextRegion(box=box, text=t))
                            stage(gray[y1:y1 + bh, x1:x1 + bw], "",
                                  add_region)

                if crops:
                    texts = self.ocr_fn(np.stack(crops))
                    for (key, sink), t in zip(fresh, texts):
                        self._ocr_cache[key] = (t, now)
                        sink(t)
                if self.barcode_fn is not None:
                    barcodes = list(self.barcode_fn(gray) or [])
                valid |= AnalysisFlags.OCR
            except Exception as e:
                self._stage_failed("ocr", e)
            timings["ocr"] = (time.perf_counter() - t0) * 1e3
        # Reading order: top to bottom, then left to right.
        text_regions.sort(key=lambda tr: (tr.box[1], tr.box[0]))

        # --- navigation cues over the depth grid -------------------------
        navigation_cues: List[str] = []
        if (flags & AnalysisFlags.NAVIGATION
                and self.navigation_engine is not None
                and depth_map is not None):
            t0 = time.perf_counter()
            try:
                self.navigation_engine.update(depth_map, orientation_wxyz)
                navigation_cues = self.navigation_engine.current_hazards()
                valid |= AnalysisFlags.NAVIGATION
            except Exception as e:
                self._stage_failed("navigation cues", e)
            timings["navigation"] = (time.perf_counter() - t0) * 1e3

        # --- scene graph ---------------------------------------------------
        if flags & AnalysisFlags.SCENE_GRAPH and objects:
            t0 = time.perf_counter()
            try:
                nodes = [SceneNode(i, o.label, o.box, o.distance_m,
                                   o.attributes)
                         for i, o in enumerate(objects)]
                graph = build_scene_graph(nodes)
                valid |= AnalysisFlags.SCENE_GRAPH
            except Exception as e:
                self._stage_failed("scene graph", e)
            timings["scene_graph"] = (time.perf_counter() - t0) * 1e3

        return VisionResult(
            frame_id=self._frame_counter,
            objects=objects,
            depth_map_m=depth_map,
            scene_graph=graph,
            valid_analyses=valid,
            timings_ms=timings,
            barcodes=barcodes,
            navigation_cues=navigation_cues,
            text_regions=text_regions,
            full_text=" ".join(tr.text for tr in text_regions),
        )

    def set_ocr_filter(self, pattern: Optional[str]) -> None:
        """Regex gate on recognized texts; None clears it."""
        if pattern is not None:
            re.compile(pattern)  # validate eagerly
        self.config.ocr_text_filter = pattern

    def _text_passes_filter(self, text: str) -> bool:
        pat = self.config.ocr_text_filter
        if not pat:
            return True
        try:
            return re.search(pat, text) is not None
        except re.error:
            return True
