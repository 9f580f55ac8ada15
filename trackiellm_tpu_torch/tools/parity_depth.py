"""Depth accuracy parity: run MiDaS v2.1-small (or DPT-SwinV2) weights
through the port's depth path and score the relative-depth maps against
expected maps (dumped from the reference's ONNX Runtime session).

    python -m trackiellm_tpu_torch.tools.parity_depth --checkpoint W \\
        --images imgs/ [--expected expected_depth.npz] [--input-size N]
        [--family midas-small|dpt-swinv2] [--window-size 16]
        [--out depth_out.npz] [--name-map auto] [--device D] [--no-record]

The twin of the JAX package's ``tools/parity_depth.py``: the same flags
(plus ``--device``), failures and JSON payload. MiDaS outputs are
relative (affine-ambiguous), so each map is aligned to the expected one by
the least-squares scale and shift first, then scored by the RMSE of the
normalized maps and the Pearson correlation. An expected map at another
resolution takes the prediction resized bilinearly (antialiased on a
downscale, as ``jax.image.resize``). Without ``--expected`` it dumps the
maps to ``--out``.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from trackiellm_tpu_torch.tools.parity_common import (
    die, emit, load_image, load_state_dict, ready, record, require_file)
from trackiellm_tpu_torch.tools.parity_common import device as pick_device


def _images(spec):
    if os.path.isdir(spec):
        paths = sorted(
            p for p in glob.glob(os.path.join(spec, "*"))
            if p.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")))
    else:
        paths = sorted(glob.glob(spec)) or [spec]
    if not paths:
        die(f"no images matched {spec!r}")
    return paths


def _align_scale_shift(pred, ref):
    """Least-squares s, t minimizing ||s*pred + t - ref||^2."""
    p = pred.reshape(-1).astype(np.float64)
    r = ref.reshape(-1).astype(np.float64)
    a = np.stack([p, np.ones_like(p)], 1)
    (s, t), *_ = np.linalg.lstsq(a, r, rcond=None)
    return pred * s + t


def _resize(pred: np.ndarray, shape) -> np.ndarray:
    import torch
    import torch.nn.functional as F

    x = torch.from_numpy(np.ascontiguousarray(pred, np.float32))[None, None]
    return F.interpolate(x, size=tuple(shape), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0].numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="parity_depth")
    ap.add_argument("--checkpoint", required=True,
                    help="MiDaS small weights (.pt/.safetensors/.npz/.onnx)")
    ap.add_argument("--images", required=True,
                    help="image file, directory, or glob")
    ap.add_argument("--expected", default=None,
                    help=".npz of expected relative-depth maps keyed by "
                    "image basename (omit to dump predictions)")
    ap.add_argument("--input-size", type=int, default=0,
                    help="override the model input size (default: the "
                    "config's 256 — the real midas_v21_small_256 "
                    "resolution; fully convolutional)")
    ap.add_argument("--family", default="midas-small",
                    choices=["midas-small", "dpt-swinv2"],
                    help="midas-small: midas_v21_small torch layout; "
                    "dpt-swinv2: HF DPTForDepthEstimation w/ Swinv2 "
                    "backbone (Intel/dpt-swinv2-tiny-256)")
    ap.add_argument("--window-size", type=int, default=16,
                    help="dpt-swinv2 only: backbone window size from "
                    "the checkpoint config (tiny_256: 16, "
                    "base/large_384: 24) — not derivable from weights")
    ap.add_argument("--out", default="depth_out.npz")
    ap.add_argument("--name-map", default="auto",
                    help="bundled name-map or JSON path normalizing the "
                    "real file's tensor names onto the converter layout "
                    "('auto' = midas_small for --family midas-small, "
                    "none for dpt-swinv2; 'none' to skip)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--no-record", action="store_true")
    args = ap.parse_args(argv)

    ckpt = require_file(
        args.checkpoint, "depth checkpoint",
        "expected the midas_v21_small torch state dict "
        "(pretrained.layer*/scratch.* names) or an HF DPT-SwinV2 one "
        "(backbone.*/neck.*/head.* names, --family dpt-swinv2)")
    paths = _images(args.images)

    dev = pick_device(args.device, "parity_depth")
    ready("parity_depth", dev)
    import torch

    from trackiellm_tpu_torch.ops.preprocess import (dpt_normalize_chw,
                                                     imagenet_normalize_chw)

    state = load_state_dict(ckpt)
    nm = args.name_map
    if nm == "auto":
        nm = "midas_small" if args.family == "midas-small" else "none"
    if nm and nm.lower() != "none":
        from trackiellm_tpu_torch.models.convert import (apply_name_map,
                                                         load_name_map)

        state = apply_name_map(state, load_name_map(nm))
    if args.family == "dpt-swinv2":
        from trackiellm_tpu_torch.models import dpt as dpt_model
        from trackiellm_tpu_torch.models.convert import dpt_swinv2_from_torch

        try:
            params, cfg = dpt_swinv2_from_torch(
                state, image_size=args.input_size or 256,
                window_size=args.window_size, device=dev)
        except KeyError as exc:
            die(f"checkpoint does not match the HF DPT-SwinV2 layout "
                f"(missing {exc}); run python -m trackiellm_tpu_torch "
                f"inspect to list its names")
        size = cfg.image_size
        forward = lambda chw: dpt_model.dpt_forward(params, cfg, chw)  # noqa: E731
        normalize = dpt_normalize_chw
    else:
        from trackiellm_tpu_torch.models import depth as depth_model
        from trackiellm_tpu_torch.models.convert import midas_small_from_torch

        try:
            params, cfg = midas_small_from_torch(state, device=dev)
        except KeyError as exc:
            die(f"checkpoint does not match the midas_v21_small layout "
                f"(missing {exc}); run python -m trackiellm_tpu_torch "
                f"inspect to list its names")
        if args.input_size:
            cfg = cfg._replace(img_size=args.input_size)
        size = cfg.img_size
        forward = lambda chw: depth_model.depth_forward(params, cfg, chw)  # noqa: E731
        normalize = imagenet_normalize_chw

    preds = {}
    with torch.no_grad():
        for p in paths:
            img = torch.as_tensor(load_image(p), device=dev)
            rel = forward(normalize(img, size, size))
            preds[os.path.basename(p)] = rel.float().cpu().numpy()

    if not args.expected:
        np.savez_compressed(args.out, **preds)
        emit({"tool": "parity_depth", "dumped": args.out,
              "images": len(preds)})
        return

    require_file(args.expected, "expected depth maps",
                 ".npz keyed by image basename")
    rmses, corrs = [], []
    with np.load(args.expected) as z:
        for name, pred in preds.items():
            if name not in z.files:
                die(f"expected maps missing image {name!r}")
            ref = np.asarray(z[name], np.float32)
            if ref.shape != pred.shape:
                # Expected map may be at the ORT session's resolution.
                pred = _resize(pred, ref.shape)
            aligned = _align_scale_shift(pred, ref)
            span = float(ref.max() - ref.min()) or 1.0
            rmse = float(np.sqrt(np.mean((aligned - ref) ** 2))) / span
            rmses.append(rmse)
            if ref.std() < 1e-12 or aligned.std() < 1e-12:
                # Degenerate (constant) map: correlation is undefined;
                # agreement is decided by the rmse alone.
                corrs.append(1.0 if rmse < 1e-6 else 0.0)
            else:
                corrs.append(float(np.corrcoef(
                    aligned.reshape(-1), ref.reshape(-1))[0, 1]))
    result = {"tool": "parity_depth", "images": len(preds),
              "rmse_norm_mean": round(float(np.mean(rmses)), 5),
              "pearson_mean": round(float(np.mean(corrs)), 5)}
    emit(result)
    if not args.no_record:
        record("parity_depth", ckpt, "rmse_norm / pearson",
               f"{result['rmse_norm_mean']} / {result['pearson_mean']}",
               f"{len(preds)} images, scale-shift aligned")


if __name__ == "__main__":
    main()
