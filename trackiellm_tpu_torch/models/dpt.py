"""DPT-SwinV2 monocular depth, PyTorch (NCHW convolutions, (in, out)
linears).

Port of ``trackiellm_tpu/models/dpt.py``, the MiDaS 3.1 DPT-SwinV2 family
(``dpt_swin2_tiny_256`` and siblings) as ``transformers``'
``DPTForDepthEstimation`` with a Swinv2 backbone computes it:

  - SwinV2 backbone: 4x4 patch embed + LayerNorm; 4 stages of shifted-
    window blocks with post-norm residuals, scaled-cosine attention
    (L2-normalized q/k, a per-head ``logit_scale`` clamped at ln 100) and
    the continuous position bias MLP (2 -> 512 -> heads over a log-spaced
    coordinate table, gathered pairwise, 16 * sigmoid); patch merging
    between stages. The window clamps to the stage resolution and the
    shift drops to 0 when one window covers it (:func:`_win_geometry`).
    The shifted-window mask is added twice, as the oracle adds it.
  - DPT neck: 3x3 no-bias projections, then the RefineNet fusion pyramid
    of :mod:`~trackiellm_tpu_torch.models.depth`.
  - Depth head: 3x3 conv, align_corners=True 2x upsample, 3x3 conv -> 32,
    ReLU, 1x1 conv -> 1, ReLU: relative inverse depth at input resolution.

The windowed attention is plain ``bmm`` + softmax. Activations inside the
backbone stay channels-last (tokens); the neck and head run NCHW. Inputs
are normalized (x - 0.5) / 0.5 (``ops.preprocess.dpt_normalize_chw``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.models.bridge import hwio_tree_from_jax
from trackiellm_tpu_torch.models.depth import (  # noqa: F401
    _bilinear_up2_ac,
    _conv,
    _conv_init,
    _fusion,
    relative_to_metric,
)
from trackiellm_tpu_torch.ops.backend import exact_f32


class DPTSwinConfig(NamedTuple):
    image_size: int = 256
    patch_size: int = 4
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 16
    mlp_ratio: float = 4.0
    eps: float = 1e-5
    fusion_hidden: int = 256

    @property
    def stage_dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * (2 ** i)
                     for i in range(len(self.depths)))

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @classmethod
    def tiny_256(cls) -> "DPTSwinConfig":
        """MiDaS 3.1 dpt_swin2_tiny_256 (= Intel/dpt-swinv2-tiny-256)."""
        return cls()

    @classmethod
    def base_384(cls) -> "DPTSwinConfig":
        """MiDaS 3.1 dpt_swin2_base_384 (= Intel/dpt-swinv2-base-384)."""
        return cls(image_size=384, embed_dim=128, depths=(2, 2, 18, 2),
                   num_heads=(4, 8, 16, 32), window_size=24)

    @classmethod
    def large_384(cls) -> "DPTSwinConfig":
        """MiDaS 3.1 dpt_swin2_large_384."""
        return cls(image_size=384, embed_dim=192, depths=(2, 2, 18, 2),
                   num_heads=(6, 12, 24, 48), window_size=24)

    @classmethod
    def test_tiny(cls) -> "DPTSwinConfig":
        """Same topology at test scale: clamped windows, shifted and
        unshifted blocks, every merge."""
        return cls(image_size=64, embed_dim=16, depths=(2, 2, 2, 2),
                   num_heads=(2, 2, 4, 4), window_size=4,
                   fusion_hidden=32)


# (x - mean) / std, the DPT image processor's statistics (not ImageNet's).
DPT_MEAN = (0.5, 0.5, 0.5)
DPT_STD = (0.5, 0.5, 0.5)


def _win_geometry(res: int, window: int, shift: int) -> Tuple[int, int]:
    """The oracle's window clamp: the window shrinks to the stage
    resolution, and there is no shift when one window covers it."""
    w = res if res <= window else window
    s = 0 if res <= w else shift
    return w, s


def _ln(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float
        ) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), p["g"], p["b"],
                        eps).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _coords_table(window: int) -> np.ndarray:
    """Log-spaced relative-coordinate table for the CPB MLP, ((2w-1)^2,
    2): the oracle's relative_coords_table with pretrained_window_size 0."""
    r = np.arange(-(window - 1), window, dtype=np.float64)
    t = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)
    if window > 1:
        t = t / (window - 1)
    t = t * 8.0
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / math.log2(8.0)
    return t.reshape(-1, 2).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rel_index(window: int) -> np.ndarray:
    """Pairwise relative-position index into the (2w-1)^2 bias table,
    (w*w, w*w)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _shift_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Shifted-window attention mask, (num_windows, w*w, w*w) of 0 / -100
    (the oracle's get_attn_mask)."""
    img = np.zeros((h, w), dtype=np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift),
               slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    mw = img.reshape(h // window, window, w // window, window)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0.0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _static(name: str, device: torch.device, *args) -> torch.Tensor:
    """The tables above as tensors on ``device``, copied there once."""
    table = {"coords": _coords_table, "index": _rel_index,
             "mask": _shift_mask}[name](*args)
    return torch.from_numpy(table).to(device)


def _cpb_bias(p: Dict[str, torch.Tensor], window: int, num_heads: int,
              device: torch.device) -> torch.Tensor:
    """Continuous relative position bias -> (heads, w*w, w*w)."""
    table = _static("coords", device, window)
    hdn = F.relu(table @ p["w0"] + p["b0"])
    out = hdn @ p["w1"]                       # ((2w-1)^2, heads)
    idx = _static("index", device, window).reshape(-1)
    bias = out[idx].reshape(window * window, window * window, num_heads)
    return (16.0 * torch.sigmoid(bias)).permute(2, 0, 1)


def _swin_block(x: torch.Tensor, p: Dict[str, Any], num_heads: int,
                window: int, shift: int, eps: float) -> torch.Tensor:
    """One SwinV2 block on a (B, H, W, C) map: post-norm residuals,
    scaled-cosine windowed attention. The resolution is a multiple of the
    (clamped) window."""
    b, hgt, wid, c = x.shape
    assert hgt % window == 0 and wid % window == 0, (hgt, wid, window)
    hd = c // num_heads
    shortcut = x
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))

    nh, nw = hgt // window, wid // window
    t = window * window
    xw = x.reshape(b, nh, window, nw, window, c)
    xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(b * nh * nw, t, c)

    def heads(y):
        return y.reshape(-1, t, num_heads, hd).transpose(1, 2)

    q = heads(xw @ p["wq"] + p["bq"])
    k = heads(xw @ p["wk"])               # the oracle's key has no bias
    v = heads(xw @ p["wv"] + p["bv"])

    # Scaled cosine attention (F.normalize's eps 1e-12).
    qn = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    kn = k / k.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    scale = torch.exp(p["logit_scale"].clamp_max(math.log(100.0)))
    scores = (qn @ kn.transpose(-1, -2)) * scale[None]
    scores = scores + _cpb_bias(p["cpb"], window, num_heads, x.device)[None]
    if shift > 0:
        mask = _static("mask", x.device, hgt, wid, window, shift)
        # The oracle adds the mask twice.
        scores = (scores.reshape(b, nh * nw, num_heads, t, t)
                  + 2.0 * mask[None, :, None])
        scores = scores.reshape(-1, num_heads, t, t)

    probs = torch.softmax(scores.float(), dim=-1)
    ctx = (probs.to(v.dtype) @ v).transpose(1, 2)
    ctx = ctx.reshape(-1, t, c) @ p["wo"] + p["bo"]
    ctx = ctx.reshape(b, nh, nw, window, window, c)
    ctx = ctx.permute(0, 1, 3, 2, 4, 5).reshape(b, hgt, wid, c)
    if shift > 0:
        ctx = torch.roll(ctx, (shift, shift), dims=(1, 2))

    # Post-norm residuals (SwinV2): norm the branch, then add.
    x = shortcut + _ln(ctx, p["ln1"], eps)
    h = F.gelu(x @ p["wi"] + p["bi"])
    h = h @ p["wp"] + p["bp"]
    return x + _ln(h, p["ln2"], eps)


def _patch_merge(x: torch.Tensor, p: Dict[str, Any], eps: float
                 ) -> torch.Tensor:
    """2x2 concat -> Linear(4C -> 2C, no bias) -> LayerNorm (v2 order)."""
    y = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1)
    return _ln(y @ p["w"], p["norm"], eps)


def init_dpt(gen: torch.Generator, cfg: DPTSwinConfig) -> Dict[str, Any]:
    """Random params in the reference's tree (OIHW convs, (in, out)
    linears), on ``gen``'s device."""
    dev = gen.device

    def lin(cin, cout):
        return (torch.randn((cin, cout), generator=gen, device=dev)
                / math.sqrt(cin))

    def zeros(n):
        return torch.zeros((n,), device=dev)

    def ln(c):
        return {"g": torch.ones((c,), device=dev), "b": zeros(c)}

    def block(dim, heads):
        mid = int(dim * cfg.mlp_ratio)
        return {
            "wq": lin(dim, dim), "bq": zeros(dim), "wk": lin(dim, dim),
            "wv": lin(dim, dim), "bv": zeros(dim),
            "wo": lin(dim, dim), "bo": zeros(dim),
            "wi": lin(dim, mid), "bi": zeros(mid),
            "wp": lin(mid, dim), "bp": zeros(dim),
            "ln1": ln(dim), "ln2": ln(dim),
            "logit_scale": torch.full((heads, 1, 1), math.log(10.0),
                                      device=dev),
            "cpb": {"w0": lin(2, 512), "b0": zeros(512),
                    "w1": lin(512, heads)},
        }

    stages: List[Dict[str, Any]] = []
    for i, (depth, heads) in enumerate(zip(cfg.depths, cfg.num_heads)):
        dim = cfg.stage_dims[i]
        stage: Dict[str, Any] = {"blocks": [block(dim, heads)
                                            for _ in range(depth)]}
        if i < len(cfg.depths) - 1:
            stage["merge"] = {"w": lin(4 * dim, 2 * dim),
                              "norm": ln(2 * dim)}
        stages.append(stage)

    f = cfg.fusion_hidden

    def rcu():
        return {"c1": _conv_init(gen, 3, 3, f, f),
                "c2": _conv_init(gen, 3, 3, f, f)}

    def fuse(first: bool):
        p = {"rcu2": rcu(), "out": _conv_init(gen, 1, 1, f, f)}
        if not first:
            p["rcu1"] = rcu()
        return p

    return {
        "patch_embed": _conv_init(gen, cfg.patch_size, cfg.patch_size, 3,
                                  cfg.embed_dim),
        "embed_norm": ln(cfg.embed_dim),
        "stages": stages,
        "neck_convs": [_conv_init(gen, 3, 3, d, f, bias=False)
                       for d in cfg.stage_dims],
        "fusion": [fuse(i == 0) for i in range(len(cfg.depths))],
        "head1": _conv_init(gen, 3, 3, f, f // 2),
        "head2": _conv_init(gen, 3, 3, f // 2, 32),
        "head3": _conv_init(gen, 1, 1, 32, 1),
    }


def params_from_jax(tree: Any, device=None) -> Dict[str, Any]:
    """The JAX package's DPT params (HWIO convs) as this module's (OIHW),
    on ``device`` (the CUDA card by default)."""
    return hwio_tree_from_jax(tree, device, "carry DPT params")


def swin_features(params: Dict[str, Any], cfg: DPTSwinConfig,
                  x: torch.Tensor) -> List[torch.Tensor]:
    """SwinV2 backbone: (B, 3, S, S) image -> per-stage feature maps
    before each downsample, (B, H, W, C) at strides 4/8/16/32."""
    x = _conv(x, params["patch_embed"], stride=cfg.patch_size,
              padding="VALID").permute(0, 2, 3, 1)
    x = _ln(x, params["embed_norm"], cfg.eps)
    feats: List[torch.Tensor] = []
    res = cfg.grid
    for i, stage in enumerate(params["stages"]):
        heads = cfg.num_heads[i]
        geometry = (_win_geometry(res, cfg.window_size, 0),
                    _win_geometry(res, cfg.window_size,
                                  cfg.window_size // 2))
        for j, blk in enumerate(stage["blocks"]):
            win, shift = geometry[j % 2]
            x = _swin_block(x, blk, heads, win, shift, cfg.eps)
        feats.append(x)
        if "merge" in stage:
            x = _patch_merge(x, stage["merge"], cfg.eps)
            res //= 2
    return feats


@torch.no_grad()
def dpt_forward(params: Dict[str, Any], cfg: DPTSwinConfig,
                image_chw: torch.Tensor) -> torch.Tensor:
    """(3, S, S) DPT-normalized image -> (S, S) relative inverse depth
    (larger = nearer), non-negative: models.depth.depth_forward's contract,
    so it drops into VisionPipeline's ``depth_fn``."""
    with exact_f32():
        feats = swin_features(params, cfg, image_chw[None])
        rn = [_conv(t.permute(0, 3, 1, 2), params["neck_convs"][i],
                    padding="TORCH") for i, t in enumerate(feats)]
        fusion = params["fusion"]
        path = _fusion(fusion[0], rn[3])
        path = _fusion(fusion[1], path, rn[2])
        path = _fusion(fusion[2], path, rn[1])
        path = _fusion(fusion[3], path, rn[0])
        # Depth head (align_corners=True upsample, unlike MiDaS-small's).
        y = _conv(path, params["head1"], padding="TORCH")
        y = _bilinear_up2_ac(y)
        y = _conv(y, params["head2"], padding="TORCH", act="relu")
        y = _conv(y, params["head3"], act="relu")
    return y[0, 0].float()
