"""Shared plumbing of the port's accuracy-parity tools (``parity_*.py``).

The JAX package's ``tools/parity_common.py``, kept here as the port's own
copy: the same failure messages and exit code 2 on a missing file, the
same metrics (WER, edit distance, IoU, VOC average precision, mAP) and the
same results table. Its readers are the port's: state dicts through
``models/convert.py:load_state_dict`` (``models/loader.py``'s safetensors
reader, ``models/onnx_reader.py``, ``torch.load``, numpy), WAVs resampled
by ``ops/resample.py``.

:func:`record` appends to ``PARITY-RESULTS-torch.md`` at the checkout's
root (created on first use), or to the file ``$TRACKIE_PARITY_RESULTS``
names; the JAX package's ``PARITY-RESULTS.md`` is never written. Each twin
takes ``--device`` (the CUDA card by default, and no fallback to the CPU:
``--device cpu`` asks for it) and calls :func:`ready` once its imports
are done, which on the card loads the kernel library (built by an earlier
process of the checkout, or now) and prints one ``ready`` line on stderr
with the wall time and whether nvcc ran; ``parity_llm`` ends with a
``launches`` line (:func:`launches`) of its kernels' launch counts.
"""

from __future__ import annotations

import datetime
import json
import os
import pathlib
import sys
import time
from typing import Dict, List, Sequence

RESULTS_ENV = "TRACKIE_PARITY_RESULTS"
RESULTS_FILE = str(pathlib.Path(__file__).resolve().parents[2]
                   / "PARITY-RESULTS-torch.md")
READY_PREFIX = "parity ready: "
LAUNCHES_PREFIX = "parity launches: "

_HEADER = """# PARITY-RESULTS-torch — measured accuracy parity of the PyTorch port

Appended by python -m trackiellm_tpu_torch.tools.parity_{llm,asr,vad,tts,
detector,depth,ocr,embed,vlm} runs against real checkpoints. Empty table =
no real checkpoints have been available yet.

| date | tool | checkpoint | metric | value | details |
|---|---|---|---|---|---|
"""


def die(msg: str) -> None:
    print(f"ERROR: {msg}", file=sys.stderr)
    raise SystemExit(2)


def require_file(path: str, what: str, hint: str = "") -> str:
    if not path:
        die(f"missing required path for {what}. {hint}")
    if not os.path.exists(path):
        die(f"{what} not found: {path!r}. {hint}")
    return path


def results_file() -> str:
    return os.environ.get(RESULTS_ENV) or RESULTS_FILE


def record(tool: str, checkpoint: str, metric: str, value,
           details: str = "") -> None:
    """Append one row to the port's results table (created on first use)."""
    path = results_file()
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write(_HEADER)
    date = datetime.date.today().isoformat()
    with open(path, "a") as f:
        f.write(f"| {date} | {tool} | {os.path.basename(checkpoint)} "
                f"| {metric} | {value} | {details} |\n")


def emit(payload: Dict) -> None:
    print(json.dumps(payload))


def device(name, tool: str):
    """The device asked for; by default the CUDA card, and with none an
    error (exit 2) rather than the CPU."""
    import torch

    if name is not None:
        return torch.device(name)
    if not torch.cuda.is_available():
        die(f"no CUDA device: pass --device cpu to run {tool} on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def ready(tool: str, dev) -> None:
    """On the card, load the kernel library (``ops/_build.py`` finds the
    checkout's build, or runs nvcc); then print on stderr when the tool was
    ready to work (``time.time()``) and whether nvcc ran."""
    compiled = None
    if dev.type == "cuda":
        from trackiellm_tpu_torch.ops import _build

        _build.build()
        _build.library()
        compiled = bool(_build.last_build.get("compiled"))
    print(READY_PREFIX + json.dumps({"tool": tool, "at": time.time(),
                                     "device": str(dev),
                                     "compiled": compiled}),
          file=sys.stderr, flush=True)


def launches(dev) -> None:
    """On the card, print on stderr each hand-written kernel's launches in
    this process so far (``ops.kernel_wrappers``' counts)."""
    if dev.type != "cuda":
        return
    from trackiellm_tpu_torch.ops import kernel_wrappers

    print(LAUNCHES_PREFIX + json.dumps(
        {k: w.launches for k, w in kernel_wrappers().items()}),
        file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance (words or chars)."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def wer(ref: str, hyp: str) -> float:
    """Word error rate of hyp against ref (0.0 = exact)."""
    r = ref.split()
    if not r:
        return 0.0 if not hyp.split() else 1.0
    return edit_distance(r, hyp.split()) / len(r)


def iou_xyxy(a, b) -> float:
    ix1, iy1 = max(a[0], b[0]), max(a[1], b[1])
    ix2, iy2 = min(a[2], b[2]), min(a[3], b[3])
    iw, ih = max(ix2 - ix1, 0.0), max(iy2 - iy1, 0.0)
    inter = iw * ih
    area_a = max(a[2] - a[0], 0.0) * max(a[3] - a[1], 0.0)
    area_b = max(b[2] - b[0], 0.0) * max(b[3] - b[1], 0.0)
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def average_precision(detections: List[Dict], n_gt: int,
                      iou_thresh: float = 0.5) -> float:
    """VOC-style all-point-interpolated AP for ONE class.

    ``detections``: [{"score": s, "box": xyxy, "image": id}] across all
    images; ``n_gt`` total ground-truth boxes of this class. Each
    detection dict must carry "gt_boxes": the same-class GT boxes of
    its image (matched greedily, each GT used once per image).
    """
    if n_gt == 0:
        return 0.0
    detections = sorted(detections, key=lambda d: -d["score"])
    matched: Dict = {}
    tp, fp = [], []
    for d in detections:
        best, best_iou = None, iou_thresh
        for gi, g in enumerate(d["gt_boxes"]):
            key = (d["image"], gi)
            if key in matched:
                continue
            i = iou_xyxy(d["box"], g)
            if i >= best_iou:
                best, best_iou = key, i
        if best is not None:
            matched[best] = True
            tp.append(1)
            fp.append(0)
        else:
            tp.append(0)
            fp.append(1)
    # precision/recall curve -> all-point interpolation
    ap = 0.0
    cum_tp = cum_fp = 0
    best_prec_at = []
    for t, f in zip(tp, fp):
        cum_tp += t
        cum_fp += f
        best_prec_at.append((cum_tp / (cum_tp + cum_fp), cum_tp / n_gt))
    # integrate precision envelope over recall
    prev_recall = 0.0
    for i in range(len(best_prec_at)):
        prec_tail = max(p for p, _ in best_prec_at[i:])
        recall = best_prec_at[i][1]
        ap += prec_tail * (recall - prev_recall)
        prev_recall = recall
    return ap


def mean_ap(per_image_dets: Dict[str, List[Dict]],
            per_image_gt: Dict[str, List[Dict]],
            iou_thresh: float = 0.5) -> Dict:
    """mAP@iou over classes present in GT.

    dets: image -> [{"box": xyxy, "score": s, "cls": c}]
    gt:   image -> [{"box": xyxy, "cls": c}]
    """
    classes = sorted({g["cls"] for boxes in per_image_gt.values()
                      for g in boxes})
    aps = {}
    for c in classes:
        dets_c = []
        n_gt = 0
        for img, gts in per_image_gt.items():
            gt_boxes = [g["box"] for g in gts if g["cls"] == c]
            n_gt += len(gt_boxes)
            for d in per_image_dets.get(img, []):
                if d["cls"] == c:
                    dets_c.append({"score": d["score"], "box": d["box"],
                                   "image": img, "gt_boxes": gt_boxes})
        aps[c] = average_precision(dets_c, n_gt, iou_thresh)
    m = sum(aps.values()) / len(aps) if aps else 0.0
    return {"mAP": m, "per_class": aps, "iou": iou_thresh}


# ---------------------------------------------------------------------------
# Checkpoint ingestion helpers
# ---------------------------------------------------------------------------

def load_state_dict(path: str) -> Dict:
    """A name -> array state dict from .pt/.pth/.bin (torch),
    .safetensors, .npz, or .onnx (weights-only initializer read)."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".pt", ".pth", ".bin", ".safetensors", ".npz", ".onnx"):
        die(f"unsupported checkpoint format {ext!r} for {path}")
    from trackiellm_tpu_torch.models.convert import (
        load_state_dict as read)

    return read(path)


def load_image(path: str):
    """Image file -> HWC uint8 RGB numpy array."""
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def load_wav(path: str, target_sr: int = 16_000):
    """WAV/npy -> mono f32 at target_sr (resampled on the CPU)."""
    import numpy as np

    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    import wave

    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        raw = w.readframes(n)
        ch = w.getnchannels()
    dtype = {1: np.uint8, 2: np.int16, 4: np.int32}.get(width)
    if dtype is None:
        die(f"unsupported WAV sample width {width} in {path}")
    audio = np.frombuffer(raw, dtype).astype(np.float32)
    if width == 1:
        audio = (audio - 128.0) / 128.0
    else:
        audio = audio / float(2 ** (8 * width - 1))
    if ch > 1:
        audio = audio.reshape(-1, ch).mean(axis=1)
    if sr != target_sr:
        import torch

        from trackiellm_tpu_torch.ops.resample import resample_poly

        audio = resample_poly(torch.from_numpy(np.ascontiguousarray(audio)),
                              target_sr, sr).numpy()
    return audio
