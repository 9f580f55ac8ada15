"""YOLO-family object detector, PyTorch (NCHW activations, OIHW weights).

Port of ``trackiellm_tpu/models/detector.py``: the v8 graph (C2f stages,
SPPF, PAN neck) and the v5u graph (6x6 stem, C3 stages, the v5 neck whose
1x1 laterals feed both the upsample and the pan concat), sharing the
decoupled anchor-free head with the DFL box decode. Weights are fused
conv + bias (BN folded), as exported checkpoints carry them; a JAX-package
tree (HWIO) comes across with :func:`params_from_jax`.

Every conv pads symmetrically by k // 2 (torch's convention, not XLA's
"SAME"; the v5 stem pads 2) and sums in f32 under
:func:`~trackiellm_tpu_torch.ops.backend.exact_f32`, as the reference asks
for f32 sums.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.models.bridge import hwio_tree_from_jax
from trackiellm_tpu_torch.ops.backend import exact_f32


class DetectorConfig(NamedTuple):
    num_classes: int = 80
    # YOLOv8n widths after multiplier: stem->16, stages 32/64/128/256.
    channels: Tuple[int, ...] = (16, 32, 64, 128, 256)
    # C2f bottleneck counts per stage (v8n depth): 1, 2, 2, 1.
    depths: Tuple[int, ...] = (1, 2, 2, 1)
    reg_max: int = 16
    img_size: int = 640
    variant: str = "v8"  # "v8" (C2f) | "v5" (YOLOv5u: C3 + v5 neck)

    @property
    def head_box_ch(self) -> int:
        """Detect box-branch width: ultralytics ``c2 = max(16, ch[0]//4,
        reg_max*4)`` with ch[0] = P3 channels."""
        return max(16, self.channels[2] // 4, self.reg_max * 4)

    @property
    def head_cls_ch(self) -> int:
        """Detect cls-branch width: ultralytics ``c3 = max(ch[0], min(nc,
        100))``."""
        return max(self.channels[2], min(self.num_classes, 100))

    @classmethod
    def v8n(cls) -> "DetectorConfig":
        return cls()

    @classmethod
    def v5nu(cls) -> "DetectorConfig":
        """YOLOv5nu, the reference's detector checkpoint: width 0.25 /
        depth 0.33 of yolov5.yaml -> C3 repeats (1, 2, 3, 1), v8n's
        channels, the anchor-free u-head."""
        return cls(depths=(1, 2, 3, 1), variant="v5")

    @classmethod
    def tiny(cls) -> "DetectorConfig":
        """Test scale: the same topology at 1/4 width, img 160, reg_max 4."""
        return cls(num_classes=8, channels=(4, 8, 16, 32, 64),
                   depths=(1, 1, 1, 1), img_size=160, reg_max=4)

    @classmethod
    def tiny_v5(cls) -> "DetectorConfig":
        """Test-scale v5 (one stage of 2 repeats runs the C3 chain)."""
        return cls(num_classes=8, channels=(4, 8, 16, 32, 64),
                   depths=(1, 1, 2, 1), img_size=160, reg_max=4,
                   variant="v5")


# ---------------------------------------------------------------------------
# Parameter init (random, from a torch.Generator, on its device)
# ---------------------------------------------------------------------------

def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int
               ) -> Dict[str, torch.Tensor]:
    scale = 1.0 / math.sqrt(kh * kw * cin)
    w = (torch.rand((cout, cin, kh, kw), generator=gen, device=gen.device)
         * 2 - 1) * scale
    return {"w": w, "b": torch.zeros((cout,), device=gen.device)}


def _c2f_init(gen, cin, cout, n) -> Dict[str, Any]:
    c = cout // 2
    return {"cv1": _conv_init(gen, 1, 1, cin, cout),
            "m": [{"cv1": _conv_init(gen, 3, 3, c, c),
                   "cv2": _conv_init(gen, 3, 3, c, c)} for _ in range(n)],
            "cv2": _conv_init(gen, 1, 1, (2 + n) * c, cout)}


def _c3_init(gen, cin, cout, n) -> Dict[str, Any]:
    c = cout // 2
    return {"cv1": _conv_init(gen, 1, 1, cin, c),
            "cv2": _conv_init(gen, 1, 1, cin, c),
            # v5 Bottleneck: cv1 is 1x1 (v8's C2f uses 3x3).
            "m": [{"cv1": _conv_init(gen, 1, 1, c, c),
                   "cv2": _conv_init(gen, 3, 3, c, c)} for _ in range(n)],
            "cv3": _conv_init(gen, 1, 1, 2 * c, cout)}


def _sppf_init(gen, c) -> Dict[str, Any]:
    return {"cv1": _conv_init(gen, 1, 1, c, c // 2),
            "cv2": _conv_init(gen, 1, 1, c * 2, c)}


def _head_init(gen, cfg: DetectorConfig, params: Dict[str, Any]) -> None:
    """Decoupled head per level (P3, P4, P5), ultralytics Detect: box
    branch 3x3 -> 3x3 -> 1x1 (4 * reg_max), class branch 3x3 -> 3x3 ->
    1x1 (nc)."""
    ch = cfg.channels
    c2, c3 = cfg.head_box_ch, cfg.head_cls_ch
    for i, c in enumerate((ch[2], ch[3], ch[4])):
        params[f"head{i}_box1"] = _conv_init(gen, 3, 3, c, c2)
        params[f"head{i}_box2"] = _conv_init(gen, 3, 3, c2, c2)
        params[f"head{i}_box3"] = _conv_init(gen, 1, 1, c2, 4 * cfg.reg_max)
        params[f"head{i}_cls1"] = _conv_init(gen, 3, 3, c, c3)
        params[f"head{i}_cls2"] = _conv_init(gen, 3, 3, c3, c3)
        params[f"head{i}_cls3"] = _conv_init(gen, 1, 1, c3, cfg.num_classes)


def init_detector(gen: torch.Generator, cfg: DetectorConfig
                  ) -> Dict[str, Any]:
    """Random params in the reference's tree (OIHW convs), on ``gen``'s
    device."""
    ch, d = cfg.channels, cfg.depths
    if cfg.variant == "v5":
        params: Dict[str, Any] = {
            "stem": _conv_init(gen, 6, 6, 3, ch[0]),
            "down1": _conv_init(gen, 3, 3, ch[0], ch[1]),
            "c3_1": _c3_init(gen, ch[1], ch[1], d[0]),
            "down2": _conv_init(gen, 3, 3, ch[1], ch[2]),
            "c3_2": _c3_init(gen, ch[2], ch[2], d[1]),
            "down3": _conv_init(gen, 3, 3, ch[2], ch[3]),
            "c3_3": _c3_init(gen, ch[3], ch[3], d[2]),
            "down4": _conv_init(gen, 3, 3, ch[3], ch[4]),
            "c3_4": _c3_init(gen, ch[4], ch[4], d[3]),
            "sppf": _sppf_init(gen, ch[4]),
            "pre_up1": _conv_init(gen, 1, 1, ch[4], ch[3]),
            "up_c3_1": _c3_init(gen, 2 * ch[3], ch[3], d[0]),
            "pre_up2": _conv_init(gen, 1, 1, ch[3], ch[2]),
            "up_c3_2": _c3_init(gen, 2 * ch[2], ch[2], d[0]),
            "pan_down1": _conv_init(gen, 3, 3, ch[2], ch[2]),
            "pan_c3_1": _c3_init(gen, 2 * ch[2], ch[3], d[0]),
            "pan_down2": _conv_init(gen, 3, 3, ch[3], ch[3]),
            "pan_c3_2": _c3_init(gen, 2 * ch[3], ch[4], d[0]),
        }
    else:
        params = {
            "stem": _conv_init(gen, 3, 3, 3, ch[0]),
            "down1": _conv_init(gen, 3, 3, ch[0], ch[1]),
            "c2f1": _c2f_init(gen, ch[1], ch[1], d[0]),
            "down2": _conv_init(gen, 3, 3, ch[1], ch[2]),
            "c2f2": _c2f_init(gen, ch[2], ch[2], d[1]),
            "down3": _conv_init(gen, 3, 3, ch[2], ch[3]),
            "c2f3": _c2f_init(gen, ch[3], ch[3], d[2]),
            "down4": _conv_init(gen, 3, 3, ch[3], ch[4]),
            "c2f4": _c2f_init(gen, ch[4], ch[4], d[3]),
            "sppf": _sppf_init(gen, ch[4]),
            "up_c2f1": _c2f_init(gen, ch[4] + ch[3], ch[3], d[0]),
            "up_c2f2": _c2f_init(gen, ch[3] + ch[2], ch[2], d[0]),
            "pan_down1": _conv_init(gen, 3, 3, ch[2], ch[2]),
            "pan_c2f1": _c2f_init(gen, ch[2] + ch[3], ch[3], d[0]),
            "pan_down2": _conv_init(gen, 3, 3, ch[3], ch[3]),
            "pan_c2f2": _c2f_init(gen, ch[3] + ch[4], ch[4], d[0]),
        }
    _head_init(gen, cfg, params)
    return params


def params_from_jax(tree: Any, device=None) -> Dict[str, Any]:
    """The JAX package's detector params (HWIO convs, numpy or JAX arrays)
    as this module's (OIHW), on ``device`` (the CUDA card by default)."""
    return hwio_tree_from_jax(tree, device, "carry detector params")


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _conv(x, p, stride=1, act=True, pad=None):
    """NCHW conv + bias (+ SiLU), symmetric k // 2 padding (``pad``
    overrides: the v5 stem pads 2)."""
    k = p["w"].shape[2]
    out = F.conv2d(x, p["w"].to(x.dtype), p["b"], stride,
                   k // 2 if pad is None else pad)
    return F.silu(out) if act else out


def _bottleneck(x, p, shortcut):
    out = _conv(_conv(x, p["cv1"]), p["cv2"])
    return x + out if shortcut else out


def _c2f(x, p, shortcut=True):
    y = _conv(x, p["cv1"])
    outs = list(torch.chunk(y, 2, dim=1))
    for m in p["m"]:
        outs.append(_bottleneck(outs[-1], m, shortcut))
    return _conv(torch.cat(outs, dim=1), p["cv2"])


def _c3(x, p, shortcut=True):
    """v5 C3: two 1x1 laterals; the bottleneck chain runs on the first."""
    a = _conv(x, p["cv1"])
    for m in p["m"]:
        a = _bottleneck(a, m, shortcut)
    b = _conv(x, p["cv2"])
    return _conv(torch.cat([a, b], dim=1), p["cv3"])


def _sppf(x, p):
    """SPPF: three chained 5x5 max pools (padding counts as -inf)."""
    y = _conv(x, p["cv1"])
    pools = [y]
    for _ in range(3):
        pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
    return _conv(torch.cat(pools, dim=1), p["cv2"])


def _upsample2(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _head(x, p, i):
    box = _conv(_conv(_conv(x, p[f"head{i}_box1"]), p[f"head{i}_box2"]),
                p[f"head{i}_box3"], act=False)
    cls = _conv(_conv(_conv(x, p[f"head{i}_cls1"]), p[f"head{i}_cls2"]),
                p[f"head{i}_cls3"], act=False)
    return box, cls


@torch.no_grad()
def detector_forward(params: Dict[str, Any], cfg: DetectorConfig,
                     image_chw: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(3, S, S) letterboxed image -> decoded (A, 4) xyxy boxes in input
    pixels and (A, nc) class probabilities, A = S^2/64 + S^2/256 +
    S^2/1024."""
    with exact_f32():
        return _forward(params, cfg, image_chw[None])


def _forward(params, cfg, x):
    if cfg.variant == "v5":
        x = _conv(x, params["stem"], stride=2, pad=2)
        x = _c3(_conv(x, params["down1"], stride=2), params["c3_1"])
        p3 = _c3(_conv(x, params["down2"], stride=2), params["c3_2"])
        p4 = _c3(_conv(p3, params["down3"], stride=2), params["c3_3"])
        p5 = _sppf(_c3(_conv(p4, params["down4"], stride=2),
                       params["c3_4"]), params["sppf"])
        # v5 PAN: the 1x1 compressions feed the upsample and the pan concat.
        t5 = _conv(p5, params["pre_up1"])
        u4 = _c3(torch.cat([_upsample2(t5), p4], 1), params["up_c3_1"],
                 shortcut=False)
        t4 = _conv(u4, params["pre_up2"])
        u3 = _c3(torch.cat([_upsample2(t4), p3], 1), params["up_c3_2"],
                 shortcut=False)
        d4 = _c3(torch.cat([_conv(u3, params["pan_down1"], stride=2), t4],
                           1), params["pan_c3_1"], shortcut=False)
        d5 = _c3(torch.cat([_conv(d4, params["pan_down2"], stride=2), t5],
                           1), params["pan_c3_2"], shortcut=False)
    else:
        x = _conv(x, params["stem"], stride=2)
        x = _c2f(_conv(x, params["down1"], stride=2), params["c2f1"])
        p3 = _c2f(_conv(x, params["down2"], stride=2), params["c2f2"])
        p4 = _c2f(_conv(p3, params["down3"], stride=2), params["c2f3"])
        p5 = _sppf(_c2f(_conv(p4, params["down4"], stride=2),
                        params["c2f4"]), params["sppf"])
        u4 = _c2f(torch.cat([_upsample2(p5), p4], 1), params["up_c2f1"],
                  shortcut=False)
        u3 = _c2f(torch.cat([_upsample2(u4), p3], 1), params["up_c2f2"],
                  shortcut=False)
        d4 = _c2f(torch.cat([_conv(u3, params["pan_down1"], stride=2), u4],
                            1), params["pan_c2f1"], shortcut=False)
        d5 = _c2f(torch.cat([_conv(d4, params["pan_down2"], stride=2), p5],
                            1), params["pan_c2f2"], shortcut=False)

    # Heads and the DFL decode per level, concatenated over all anchors.
    boxes_all: List[torch.Tensor] = []
    cls_all: List[torch.Tensor] = []
    dev = x.device
    bins = torch.arange(cfg.reg_max, dtype=torch.float32, device=dev)
    for i, (feat, stride) in enumerate(((u3, 8), (d4, 16), (d5, 32))):
        box_raw, cls_raw = _head(feat, params, i)
        _, _, h, w = box_raw.shape
        # DFL: the softmax expectation over reg_max bins per side.
        dist = box_raw[0].permute(1, 2, 0).reshape(h * w, 4, cfg.reg_max)
        ltrb = (torch.softmax(dist.float(), -1) * bins).sum(-1)
        cy, cx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(w, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij")
        centers = torch.stack([cx.reshape(-1), cy.reshape(-1)], -1)
        xy1 = (centers - ltrb[:, :2]) * stride
        xy2 = (centers + ltrb[:, 2:]) * stride
        boxes_all.append(torch.cat([xy1, xy2], -1))
        cls_all.append(torch.sigmoid(
            cls_raw[0].permute(1, 2, 0).reshape(h * w, cfg.num_classes)
            .float()))
    return torch.cat(boxes_all, 0), torch.cat(cls_all, 0)


# COCO-80 label table.
COCO_LABELS = (
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)
