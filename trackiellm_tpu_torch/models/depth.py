"""Monocular depth: MiDaS v2.1 small's topology, PyTorch (NCHW, OIHW).

Port of ``trackiellm_tpu/models/depth.py``: the tf_efficientnet_lite3
encoder (MBConv stages, ReLU6, no SE, TF "SAME" padding, taps at strides
4/8/16/32), the RefineNet decoder (3x3 projections, fusion blocks of two
residual conv units, an align_corners=True bilinear x2 and a 1x1 out conv)
and the 3-conv head; :func:`relative_to_metric` maps relative inverse depth
to meters as the reference does. A JAX-package tree (HWIO) comes across
with :func:`params_from_jax`.

TF "SAME" pads a stride-2 convolution asymmetrically, the odd pad after;
``F.conv2d(padding="same")`` refuses stride 2, so the pad is explicit
(:func:`same_padding_2d`). The depthwise convolutions are grouped
convolutions. Every forward runs under
:func:`~trackiellm_tpu_torch.ops.backend.exact_f32`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.models.bridge import hwio_tree_from_jax
from trackiellm_tpu_torch.ops.backend import exact_f32
from trackiellm_tpu_torch.ops.conv import same_padding


class MBStage(NamedTuple):
    kernel: int
    stride: int
    expand: int
    cout: int
    repeats: int


class DepthConfig(NamedTuple):
    stem_ch: int = 32
    # efficientnet-lite3 resolved stages (width 1.2, depth 1.4, first/last
    # repeats unscaled): kernel, stride, expand, cout, n.
    stages: Tuple[MBStage, ...] = (
        MBStage(3, 1, 1, 24, 1),
        MBStage(3, 2, 6, 32, 3),
        MBStage(5, 2, 6, 48, 3),
        MBStage(3, 2, 6, 96, 5),
        MBStage(5, 1, 6, 136, 5),
        MBStage(5, 2, 6, 232, 6),
        MBStage(3, 1, 6, 384, 1),
    )
    features: int = 64   # decoder width (expand=True: x1/x2/x4/x8)
    img_size: int = 256

    @property
    def tap_channels(self) -> Tuple[int, int, int, int]:
        """Encoder channels at the 4 MiDaS taps (after stages 2, 3, 5, 7)."""
        s = self.stages
        return (s[1].cout, s[2].cout, s[4].cout, s[6].cout)

    @classmethod
    def small(cls) -> "DepthConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "DepthConfig":
        """Same topology at test scale."""
        return cls(
            stem_ch=8,
            stages=(
                MBStage(3, 1, 1, 8, 1),
                MBStage(3, 2, 6, 8, 1),
                MBStage(5, 2, 6, 8, 1),
                MBStage(3, 2, 6, 16, 1),
                MBStage(5, 1, 6, 16, 1),
                MBStage(5, 2, 6, 24, 1),
                MBStage(3, 1, 6, 32, 1),
            ),
            features=16, img_size=96)


# ---------------------------------------------------------------------------
# Init (random, from a torch.Generator, on its device)
# ---------------------------------------------------------------------------

def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
               bias: bool = True, depthwise: bool = False
               ) -> Dict[str, Any]:
    fan = kh * kw * (1 if depthwise else cin)
    scale = 1.0 / math.sqrt(fan)
    shape = (cout, 1, kh, kw) if depthwise else (cout, cin, kh, kw)
    w = (torch.rand(shape, generator=gen, device=gen.device) * 2 - 1) * scale
    return {"w": w,
            "b": torch.zeros((cout,), device=gen.device) if bias else None}


def init_depth(gen: torch.Generator, cfg: DepthConfig) -> Dict[str, Any]:
    """Random params in the reference's tree (OIHW convs; a depthwise
    conv's weight is (C, 1, k, k)), on ``gen``'s device."""
    blocks: List[List[Dict[str, Any]]] = []
    cin = cfg.stem_ch
    for st in cfg.stages:
        stage = []
        for _ in range(st.repeats):
            if st.expand == 1:  # DepthwiseSeparable (stage 1)
                stage.append({
                    "dw": _conv_init(gen, st.kernel, st.kernel, cin, cin,
                                     depthwise=True),
                    "pw": _conv_init(gen, 1, 1, cin, st.cout)})
            else:  # InvertedResidual
                mid = cin * st.expand
                stage.append({
                    "pw": _conv_init(gen, 1, 1, cin, mid),
                    "dw": _conv_init(gen, st.kernel, st.kernel, mid, mid,
                                     depthwise=True),
                    "pwl": _conv_init(gen, 1, 1, mid, st.cout)})
            cin = st.cout
        blocks.append(stage)

    f = cfg.features
    taps = cfg.tap_channels
    rn_out = (f, f * 2, f * 4, f * 8)

    def rcu(c):
        return {"c1": _conv_init(gen, 3, 3, c, c),
                "c2": _conv_init(gen, 3, 3, c, c)}

    # refinenet1..4 over (f, 2f, 4f, 8f); expand=True halves the channels
    # in out_conv except refinenet1.
    refine = [{"rcu1": rcu(rn_out[k]), "rcu2": rcu(rn_out[k]),
               "out": _conv_init(gen, 1, 1, rn_out[k],
                                 f if k == 0 else rn_out[k] // 2)}
              for k in range(4)]
    return {
        "stem": _conv_init(gen, 3, 3, 3, cfg.stem_ch),
        "blocks": blocks,
        "layer_rn": [_conv_init(gen, 3, 3, taps[k], rn_out[k], bias=False)
                     for k in range(4)],
        "refine": refine,
        "head1": _conv_init(gen, 3, 3, f, f // 2),
        "head2": _conv_init(gen, 3, 3, f // 2, 32),
        "head3": _conv_init(gen, 1, 1, 32, 1),
    }


def params_from_jax(tree: Any, device=None) -> Dict[str, Any]:
    """The JAX package's MiDaS params (HWIO) as this module's (OIHW), on
    ``device`` (the CUDA card by default)."""
    return hwio_tree_from_jax(tree, device, "carry depth params")


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def same_padding_2d(h: int, w: int, kh: int, kw: int, stride: int
                    ) -> Tuple[int, int, int, int]:
    """TF/XLA "SAME" padding of an (h, w) map as ``F.pad``'s (left, right,
    top, bottom): the odd pad after."""
    top, bottom = same_padding(h, kh, stride)
    left, right = same_padding(w, kw, stride)
    return left, right, top, bottom


def _conv(x, p, stride=1, padding="SAME", act=None, depthwise=False):
    """NCHW conv (+ bias, + activation). ``padding="SAME"`` is the TF
    convention the efficientnet-lite weights were trained under; "TORCH"
    pads k // 2 on both sides (the decoder's); "VALID" pads nothing."""
    w = p["w"].to(x.dtype)
    kh, kw = w.shape[2], w.shape[3]
    pad = 0
    if padding == "SAME":
        pads = same_padding_2d(x.shape[2], x.shape[3], kh, kw, stride)
        if any(pads):
            x = F.pad(x, pads)
    elif padding == "TORCH":
        pad = (kh // 2, kw // 2)
    out = F.conv2d(x, w, p.get("b"), stride, pad,
                   groups=x.shape[1] if depthwise else 1)
    if act == "relu6":
        return out.clamp(0.0, 6.0)
    if act == "relu":
        return F.relu(out)
    return out


def _bilinear_up2_ac(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample, align_corners=True."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def _bilinear_up2(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear, align_corners=False (half-pixel): what
    ``jax.image.resize`` "linear" computes at 2x."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def _rcu(x, p):
    """ResidualConvUnit_custom: relu-conv-relu-conv + skip."""
    out = _conv(F.relu(x), p["c1"], padding="TORCH")
    out = _conv(F.relu(out), p["c2"], padding="TORCH")
    return out + x


def _fusion(p, x, skip=None):
    """FeatureFusionBlock_custom (deconv=False, bn=False,
    align_corners=True)."""
    out = x
    if skip is not None:
        out = out + _rcu(skip, p["rcu1"])
    out = _rcu(out, p["rcu2"])
    out = _bilinear_up2_ac(out)
    return _conv(out, p["out"], padding="TORCH")


@torch.no_grad()
def depth_forward(params: Dict[str, Any], cfg: DepthConfig,
                  image_chw: torch.Tensor) -> torch.Tensor:
    """(3, S, S) ImageNet-normalized image -> (S, S) relative inverse depth
    (larger = nearer), non-negative."""
    with exact_f32():
        x = image_chw[None]
        x = _conv(x, params["stem"], stride=2, act="relu6")
        taps = []
        for si, (st, stage) in enumerate(zip(cfg.stages, params["blocks"])):
            for j, blk in enumerate(stage):
                stride = st.stride if j == 0 else 1
                if st.expand == 1:
                    y = _conv(x, blk["dw"], stride=stride, act="relu6",
                              depthwise=True)
                    y = _conv(y, blk["pw"])
                else:
                    y = _conv(x, blk["pw"], act="relu6")
                    y = _conv(y, blk["dw"], stride=stride, act="relu6",
                              depthwise=True)
                    y = _conv(y, blk["pwl"])
                x = x + y if (stride == 1 and x.shape[1] == y.shape[1]) else y
            if si in (1, 2, 4, 6):  # MiDaS taps: layer1..layer4
                taps.append(x)

        rn = [_conv(t, params["layer_rn"][k], padding="TORCH")
              for k, t in enumerate(taps)]
        path = _fusion(params["refine"][3], rn[3])
        path = _fusion(params["refine"][2], path, rn[2])
        path = _fusion(params["refine"][1], path, rn[1])
        path = _fusion(params["refine"][0], path, rn[0])

        y = _conv(path, params["head1"], padding="TORCH")
        y = _bilinear_up2(y)
        y = _conv(y, params["head2"], padding="TORCH", act="relu")
        y = _conv(y, params["head3"], act="relu")
    return y[0, 0].float()


def relative_to_metric(depth_rel: torch.Tensor, min_depth_m: float = 0.3,
                       max_depth_m: float = 10.0) -> torch.Tensor:
    """Relative inverse depth -> meters as the reference maps it: normalize
    to [0, 1], then ``max - norm * (max - min)``, so the nearest pixel
    (largest inverse depth) lands at ``min_depth_m``. The span is an f32
    difference, as the reference computes it; the quotient divides by a
    device tensor."""
    lo = depth_rel.min()
    hi = depth_rel.max()
    norm = (depth_rel - lo) / (hi - lo).clamp_min(1e-9)
    span = float(np.float32(max_depth_m) - np.float32(min_depth_m))
    return max_depth_m - norm * span
