"""Camera-frame preprocessing for the detector, the depth models and the
CLIP vision tower.

Port of ``trackiellm_tpu/ops/preprocess.py``: a half-pixel bilinear resize
written as the reference's gathers (so the CPU gives its f32 bytes), the
YOLO letterbox onto a grey canvas, and the ImageNet, DPT and CLIP
normalizations,
each returning a CHW f32 tensor on the frame's device. A frame given as a
numpy array or a CPU tensor is moved to ``device`` first.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _bilinear_resize(img: torch.Tensor, out_h: int, out_w: int
                     ) -> torch.Tensor:
    """Bilinear resize of an HWC image with half-pixel centres (the
    reference preprocessors' OpenCV-style convention) -> f32 HWC."""
    in_h, in_w = img.shape[0], img.shape[1]
    dev = img.device
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) \
        * (in_h / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) \
        * (in_w / out_w) - 0.5
    ys = ys.clamp(0.0, in_h - 1.0)
    xs = xs.clamp(0.0, in_w - 1.0)

    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = (y0 + 1).clamp_max(in_h - 1)
    x1 = (x0 + 1).clamp_max(in_w - 1)
    wy = (ys - y0.float())[:, None, None]
    wx = (xs - x0.float())[None, :, None]

    imgf = img.float()
    r0, r1 = imgf[y0], imgf[y1]
    top = r0[:, x0] * (1 - wx) + r0[:, x1] * wx
    bot = r1[:, x0] * (1 - wx) + r1[:, x1] * wx
    return top * (1 - wy) + bot * wy


@functools.lru_cache(maxsize=64)
def _const(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A small f32 constant on ``device``, copied there once."""
    return torch.tensor(values, dtype=torch.float32).to(device)


def as_frame(image_u8, device=None) -> torch.Tensor:
    """An HWC uint8 frame as a tensor on ``device`` (its own device when
    None and it is a tensor already)."""
    t = (image_u8 if isinstance(image_u8, torch.Tensor)
         else torch.from_numpy(np.ascontiguousarray(image_u8)))
    return t if device is None else t.to(device)


def letterbox_preprocess(image_u8: torch.Tensor, target_h: int = 640,
                         target_w: int = 640,
                         pad_value: float = 114.0 / 255.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Letterbox an HWC uint8 frame into a CHW model input.

    The aspect ratio is kept and the image centred on a grey canvas (YOLO's
    114/255). Returns ``(chw, meta)`` with ``meta = [scale, pad_x, pad_y]``
    in target pixels, what :func:`trackiellm_tpu_torch.ops.nms.
    boxes_to_original` takes to map boxes back to camera pixels."""
    in_h, in_w = image_u8.shape[0], image_u8.shape[1]
    scale = min(target_h / in_h, target_w / in_w)
    new_h, new_w = int(round(in_h * scale)), int(round(in_w * scale))
    pad_y, pad_x = (target_h - new_h) // 2, (target_w - new_w) // 2

    resized = _bilinear_resize(image_u8, new_h, new_w) * (1.0 / 255.0)
    canvas = torch.full((target_h, target_w, 3), pad_value,
                        dtype=torch.float32, device=image_u8.device)
    canvas[pad_y:pad_y + new_h, pad_x:pad_x + new_w] = resized
    chw = canvas.permute(2, 0, 1).contiguous()
    meta = _const((scale, float(pad_x), float(pad_y)), image_u8.device)
    return chw, meta


def _normalize_chw(image_u8: torch.Tensor, target_h: int, target_w: int,
                   mean, std) -> torch.Tensor:
    resized = _bilinear_resize(image_u8, target_h, target_w) * (1.0 / 255.0)
    m = _const(tuple(mean), image_u8.device)
    s = _const(tuple(std), image_u8.device)
    return ((resized - m) / s).permute(2, 0, 1).contiguous()


def imagenet_normalize_chw(image_u8: torch.Tensor, target_h: int = 384,
                           target_w: int = 384) -> torch.Tensor:
    """Resize (no letterbox), ImageNet mean/std, HWC -> CHW: the MiDaS
    preprocess."""
    return _normalize_chw(image_u8, target_h, target_w, IMAGENET_MEAN,
                          IMAGENET_STD)


def dpt_normalize_chw(image_u8: torch.Tensor, target_h: int = 256,
                      target_w: int = 256) -> torch.Tensor:
    """Resize (no letterbox), (x - 0.5) / 0.5, HWC -> CHW: the statistics
    the DPT-SwinV2 checkpoints were trained under, not ImageNet's."""
    return _normalize_chw(image_u8, target_h, target_w, (0.5, 0.5, 0.5),
                          (0.5, 0.5, 0.5))


def clip_normalize_chw(image_u8: torch.Tensor, target_h: int = 336,
                       target_w: int = 336) -> torch.Tensor:
    """Resize (no letterbox), OpenAI-CLIP mean/std, HWC -> CHW: the
    statistics the LLaVA towers were trained under (models/clip.py). HF's
    CLIPImageProcessor resizes bicubic on the shortest side and crops; the
    camera path takes a direct square resize for latency."""
    return _normalize_chw(image_u8, target_h, target_w, CLIP_MEAN, CLIP_STD)
