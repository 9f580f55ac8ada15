"""QR finder-pattern detection (detection-only).

Parity: the reference's QR/barcode detection hooks in the OCR engine
(reference: src/vision/tk_text_recognition.cpp:103-104 — hooks
only; no decoder ships there either). This fills the pipeline's
``barcode_fn`` surface with a real detector: classic 1:1:3:1:1
run-ratio scanning for the three QR finder patterns, grouped into QR
candidate regions. Decoding the payload is out of scope (the hook
surface reports presence + location, which the cortex can announce —
"ha um codigo QR a sua frente").

Host-side numpy by design: the scan is a cheap O(H*W) run-length pass
over a downsampled grayscale frame, triggered only when OCR runs; a
device round trip would cost more than the compute.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# A finder pattern is dark:light:dark:light:dark at 1:1:3:1:1 module
# widths. Tolerance is per-module (0.5 = llama-level classic zxing
# tolerance).
_RATIOS = (1.0, 1.0, 3.0, 1.0, 1.0)
_TOL = 0.55
_MAX_SIDE = 480  # downsample bound (scan cost + noise robustness)


def _line_hits(dark: np.ndarray) -> List[Tuple[float, float]]:
    """One binarized line -> [(center_px, module_size)] finder hits."""
    d = np.flatnonzero(np.diff(dark.astype(np.int8)))
    # Run boundaries: [0, d+1..., len) ; runs alternate value.
    starts = np.concatenate(([0], d + 1))
    ends = np.concatenate((d + 1, [dark.size]))
    lengths = ends - starts
    first_dark = bool(dark[0])
    hits = []
    # Windows of 5 runs starting with a dark run.
    start_idx = 0 if first_dark else 1
    for i in range(start_idx, len(lengths) - 4, 2):
        w = lengths[i:i + 5].astype(np.float64)
        module = w.sum() / 7.0
        if module < 1.8:  # sub-2px modules are scan noise
            continue
        if all(abs(w[j] - _RATIOS[j] * module) <= _TOL * module
               + 0.5 for j in range(5)):
            center = starts[i] + w[0] + w[1] + w[2] / 2.0
            hits.append((float(center), float(module)))
    return hits


def _binarize(gray: np.ndarray) -> np.ndarray:
    g = np.asarray(gray, np.float32)
    if g.max() > 1.5:
        g = g / 255.0
    thresh = (float(g.min()) + float(g.max())) / 2.0
    return g < thresh


def detect_finder_patterns(gray: np.ndarray) -> List[Dict]:
    """Grayscale (H, W) -> finder-pattern candidates
    [{"x", "y", "module"}] (frame-pixel coordinates)."""
    g = np.asarray(gray)
    if g.ndim == 3:
        g = g.mean(axis=-1)
    h, w = g.shape
    stride = max(1, int(np.ceil(max(h, w) / _MAX_SIDE)))
    gs = g[::stride, ::stride]
    dark = _binarize(gs)
    hs, ws = dark.shape

    row_hits: List[Tuple[float, float, float]] = []  # (x, y, module)
    for y in range(hs):
        for cx, m in _line_hits(dark[y]):
            row_hits.append((cx, float(y), m))
    col_hits: List[Tuple[float, float, float]] = []
    for x in range(ws):
        for cy, m in _line_hits(dark[:, x]):
            col_hits.append((float(x), cy, m))
    if not row_hits or not col_hits:
        return []

    ra = np.asarray(row_hits)
    ca = np.asarray(col_hits)
    # Cross-confirm: a real finder pattern produces the ratio on BOTH a
    # row through its center and a column through its center.
    patterns: List[Dict] = []
    for x, y, m in ra:
        near = ca[(np.abs(ca[:, 0] - x) <= m)
                  & (np.abs(ca[:, 1] - y) <= m)
                  & (np.abs(ca[:, 2] - m) <= 0.6 * m)]
        if near.size == 0:
            continue
        cx = (x + float(near[:, 0].mean())) / 2.0
        cy = (y + float(near[:, 1].mean())) / 2.0
        for pat in patterns:
            if (abs(pat["_sx"] - cx) <= 3.5 * m
                    and abs(pat["_sy"] - cy) <= 3.5 * m):
                pat["_n"] += 1
                pat["_sx"] += (cx - pat["_sx"]) / pat["_n"]
                pat["_sy"] += (cy - pat["_sy"]) / pat["_n"]
                break
        else:
            patterns.append({"_sx": cx, "_sy": cy, "_n": 1,
                             "module": float(m)})
    out = []
    for pat in patterns:
        if pat["_n"] < 3:  # demand >= 3 cross-confirmed scanlines
            continue
        out.append({"x": pat["_sx"] * stride, "y": pat["_sy"] * stride,
                    "module": pat["module"] * stride})
    return out


def detect_qr(gray: np.ndarray) -> List[Dict]:
    """Grayscale frame -> QR candidate regions: groups of >= 3 finder
    patterns with consistent module size. Returns
    [{"bbox": [x0, y0, x1, y1], "centers": [(x, y)...], "module": m}].
    """
    pats = detect_finder_patterns(gray)
    if len(pats) < 3:
        return []
    # A QR code's three finder patterns share a scale AND sit within
    # the code's extent — up to ~25 modules apart for the versions a
    # hand-held camera resolves. Scale-only grouping would collapse
    # two same-sized codes (or three scattered false positives) into
    # one full-frame candidate.
    max_span_modules = 30.0
    used = [False] * len(pats)
    results = []
    for i, p in enumerate(pats):
        if used[i]:
            continue
        group = [j for j in range(len(pats)) if not used[j]
                 and 0.5 <= pats[j]["module"] / p["module"] <= 2.0
                 and abs(pats[j]["x"] - p["x"])
                 <= max_span_modules * p["module"]
                 and abs(pats[j]["y"] - p["y"])
                 <= max_span_modules * p["module"]]
        if len(group) < 3:
            continue
        for j in group:
            used[j] = True
        xs = [pats[j]["x"] for j in group]
        ys = [pats[j]["y"] for j in group]
        m = float(np.mean([pats[j]["module"] for j in group]))
        pad = 3.5 * m  # finder center sits 3.5 modules inside the code
        results.append({
            "bbox": [min(xs) - pad, min(ys) - pad,
                     max(xs) + pad, max(ys) + pad],
            "centers": [(pats[j]["x"], pats[j]["y"]) for j in group],
            "module": m,
        })
    return results


class QRFinderDetector:
    """The vision pipeline's ``barcode_fn``: gray frame -> descriptive
    strings, one per QR candidate. Detection fills the
    tk_text_recognition.cpp:103-104 hook surface; when the payload
    DECODES (vision/qr_decode.py — affine sampling + format BCH +
    Reed-Solomon + segment parse) the string carries the text so the
    cortex can SPEAK it, not just announce presence. Decode failures
    (perspective, unsupported version, damage past EC) degrade to the
    detection-only string, never drop the candidate."""

    def __init__(self, decode: bool = True):
        self.decode = decode

    def __call__(self, gray: np.ndarray) -> List[str]:
        out = []
        for qr in detect_qr(gray):
            x0, y0, x1, y1 = (int(round(v)) for v in qr["bbox"])
            payload = None
            if self.decode:
                from trackiellm_tpu_torch.vision.qr_decode import (
                    decode_qr_payload)

                payload = decode_qr_payload(gray, qr)
            if payload:
                out.append(f"qr_code@[{x0},{y0},{x1},{y1}]:{payload}")
            else:
                out.append(f"qr_code@[{x0},{y0},{x1},{y1}]")
        return out
