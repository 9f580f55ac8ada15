"""Detector accuracy parity: run YOLOv8n weights through the port's
detection path and score mAP@0.5 against expected boxes.

    python -m trackiellm_tpu_torch.tools.parity_detector --checkpoint W \\
        --images imgs/ [--expected expected_boxes.json] [--iou 0.5]
        [--conf 0.25] [--input-size 640] [--device D] [--no-record]

The twin of the JAX package's ``tools/parity_detector.py``: the same flags
(plus ``--device``), failures and JSON payload. Checkpoints: an
ultralytics .pt, a .safetensors/.npz state dict, or a weights-only .onnx
in the torch layout ``detector_from_torch`` reads. Expected boxes:
{"image.jpg": [{"box": [x1, y1, x2, y2], "cls": 41}, ...]} in the original
image's pixels. Without ``--expected`` it dumps the detections.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from trackiellm_tpu_torch.tools.parity_common import (
    die, emit, load_image, load_state_dict, mean_ap, ready, record,
    require_file)
from trackiellm_tpu_torch.tools.parity_common import device as pick_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="parity_detector")
    ap.add_argument("--checkpoint", required=True,
                    help="YOLOv8n weights (.pt/.safetensors/.npz/.onnx)")
    ap.add_argument("--images", required=True,
                    help="image file, directory, or glob")
    ap.add_argument("--expected", default=None,
                    help="ground-truth boxes JSON (omit to dump detections)")
    ap.add_argument("--iou", type=float, default=0.5)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--input-size", type=int, default=640,
                    help="letterbox input size (640 for real v8n; the "
                    "weights don't encode it — fully convolutional)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--no-record", action="store_true",
                    help="don't append to the results table")
    args = ap.parse_args(argv)

    ckpt = require_file(
        args.checkpoint, "detector checkpoint",
        "expected a YOLOv8n ultralytics .pt or torch-layout state dict")
    if os.path.isdir(args.images):
        paths = sorted(
            p for p in glob.glob(os.path.join(args.images, "*"))
            if p.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
    else:
        paths = sorted(glob.glob(args.images))
    if not paths:
        die(f"no images found under {args.images!r}")

    dev = pick_device(args.device, "parity_detector")
    ready("parity_detector", dev)
    from trackiellm_tpu_torch.models import detector as det_model
    from trackiellm_tpu_torch.models.convert import detector_from_torch
    from trackiellm_tpu_torch.vision.pipeline import (AnalysisFlags,
                                                      VisionPipeline)

    state = load_state_dict(ckpt)
    try:
        params, cfg = detector_from_torch(state, device=dev)
    except KeyError as e:
        die(f"checkpoint {ckpt!r} is missing expected tensor {e}; "
            "list its names with python -m trackiellm_tpu_torch inspect "
            "and check models/convert.py::detector_from_torch's layout "
            "table")

    pipe = VisionPipeline(
        detector_fn=lambda chw: det_model.detector_forward(
            params, cfg, chw), device=dev)
    pipe.update_thresholds(confidence=args.conf)
    pipe.config.detector_input = args.input_size

    dets = {}
    for p in paths:
        img = load_image(p)
        result = pipe.process_frame(img, AnalysisFlags.DETECTION)
        name = os.path.basename(p)
        dets[name] = [{"box": [float(v) for v in o.box],
                       "score": float(o.confidence),
                       "cls": int(o.class_id), "label": o.label}
                      for o in result.objects]
        print(f"{name}: {len(dets[name])} objects", file=sys.stderr)

    if not args.expected:
        emit({"tool": "parity_detector", "checkpoint": ckpt,
              "detections": dets,
              "note": "no --expected given; dumped detections only"})
        return

    gt_raw = json.loads(open(require_file(
        args.expected, "expected-boxes JSON")).read())
    gt = {img: [{"box": g["box"], "cls": g["cls"]} for g in boxes]
          for img, boxes in gt_raw.items()}
    missing = set(gt) - set(dets)
    if missing:
        die(f"expected file references images not given: {sorted(missing)}")
    scores = mean_ap(dets, gt, iou_thresh=args.iou)
    payload = {"tool": "parity_detector", "checkpoint": ckpt,
               "n_images": len(paths), "mAP@%.2f" % args.iou:
               round(scores["mAP"], 4),
               "per_class": {str(k): round(v, 4)
                             for k, v in scores["per_class"].items()}}
    emit(payload)
    if not args.no_record:
        record("parity_detector", ckpt, f"mAP@{args.iou:.2f}",
               round(scores["mAP"], 4), f"{len(paths)} images")


if __name__ == "__main__":
    main()
