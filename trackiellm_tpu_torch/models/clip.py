"""CLIP ViT vision tower + LLaVA multimodal projector, PyTorch.

Port of ``trackiellm_tpu/models/clip.py``: a CLIP ViT encoder
(transformers ``CLIPVisionModel`` semantics) and its SigLIP dialect
(PaliGemma's tower), then the LLaVA two-layer projector or PaliGemma's
single linear, whose output :func:`trackiellm_tpu_torch.models.llm.prefill`
takes as ``embeds`` over the image placeholder rows of a prompt.

- The patch "convolution" (stride == kernel) is one reshape and one
  ``(n_patches, 3*P*P) @ (3*P*P, D)`` product: ``patch_w`` is stored that
  way, so the tree carries across from the JAX package unchanged.
- LLaVA's ``vision_feature_layer=-2`` runs only the layers the tap needs
  (``n_run_layers``): the unused tail is never computed.
- The attention is plain f32 ``einsum`` + softmax over the whole sequence
  (577 rows at ViT-L/14-336): the reference's is plain XLA, no Pallas
  kernel. Every forward runs under ``exact_f32``, as the vision models do.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from trackiellm_tpu_torch.ops.backend import exact_f32
from trackiellm_tpu_torch.ops.preprocess import (  # noqa: F401
    CLIP_MEAN, CLIP_STD, as_frame, clip_normalize_chw)

__all__ = [
    "CLIPVisionConfig", "encode_image", "project_features",
    "encode_and_project", "init_params", "CLIP_MEAN", "CLIP_STD",
    "preprocess_clip",
]


class CLIPVisionConfig(NamedTuple):
    """Static geometry of the vision tower: CLIP ViT-L/14-336 by default
    (LLaVA-1.5's tower)."""

    image_size: int = 336
    patch_size: int = 14
    dim: int = 1024            # vision hidden size
    n_layers: int = 24
    n_heads: int = 16
    hidden_dim: int = 4096     # MLP intermediate
    norm_eps: float = 1e-5
    act: str = "quick_gelu"    # CLIP's activation
    # Which encoder hidden state feeds the projector, HF's
    # hidden_states[k] with k in [-(n_layers+1), n_layers]: -2 is the
    # output of the second-to-last layer.
    feature_layer: int = -2
    # True drops the CLS row before projection ("default" strategy).
    drop_cls: bool = True
    # Projector: vision dim -> LLM dim (0 = no projector params).
    proj_dim: int = 0
    proj_act: str = "gelu"
    # 2 = LLaVA's linear-act-linear; 1 = PaliGemma's single linear.
    proj_layers: int = 2
    # Tower dialect (CLIP defaults; SigLIP flips all four):
    use_cls: bool = True        # class token prepended
    patch_bias: bool = False    # patch projection bias
    pre_ln: bool = True         # pre-encoder LayerNorm
    post_ln: bool = False       # post-encoder LayerNorm on the feature tap

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def n_image_tokens(self) -> int:
        """Tokens one image contributes to the LLM prompt."""
        if not self.use_cls:
            return self.n_patches
        return self.n_patches + (0 if self.drop_cls else 1)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def n_run_layers(self) -> int:
        """How many encoder layers the feature tap needs."""
        k = self.feature_layer
        n = self.n_layers + k + 1 if k < 0 else k
        if not 0 <= n <= self.n_layers:
            raise ValueError(f"feature_layer {k} out of range")
        return n

    @classmethod
    def siglip_so400m_224(cls, proj_dim: int = 2048) -> "CLIPVisionConfig":
        """PaliGemma-3B-224's SigLIP-So400m/14 tower and its projector
        (``google/paligemma-3b-pt-224`` config.json)."""
        return cls(image_size=224, patch_size=14, dim=1152, n_layers=27,
                   n_heads=16, hidden_dim=4304, norm_eps=1e-6,
                   act="gelu_pytorch_tanh", feature_layer=-1,
                   drop_cls=False, use_cls=False, patch_bias=True,
                   pre_ln=False, post_ln=True, proj_dim=proj_dim,
                   proj_layers=1)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return torch.nn.functional.gelu(x)
    if name in ("gelu_new", "gelu_pytorch_tanh"):
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
        eps: float) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def _layer(layers: Dict[str, torch.Tensor], i: int) -> Dict[str, Any]:
    return {k: v[i] for k, v in layers.items()}


@torch.no_grad()
def encode_image(params: Dict[str, Any], cfg: CLIPVisionConfig,
                 pixels: torch.Tensor) -> torch.Tensor:
    """CLIP ViT forward: CLIP-normalized (3, H, W) f32 pixels (HF's
    ``pixel_values``) -> the feature tap's hidden states (n_image_tokens,
    dim), CLS dropped per config (``LlavaForConditionalGeneration.
    get_image_features``, "default" strategy)."""
    p = cfg.patch_size
    g = cfg.image_size // p
    with exact_f32():
        # (3, g, P, g, P) -> (g, g, 3, P, P) -> (N, 3*P*P): the (c, ph, pw)
        # flatten order of the converters' patch_w.
        x = pixels.reshape(3, g, p, g, p).permute(1, 3, 0, 2, 4)
        x = x.reshape(g * g, 3 * p * p) @ params["patch_w"]
        if cfg.patch_bias:
            x = x + params["patch_b"]
        if cfg.use_cls:
            x = torch.cat([params["cls"][None], x], dim=0)
        x = x + params["pos"]
        if cfg.pre_ln:
            x = _ln(x, params["pre_ln_g"], params["pre_ln_b"], cfg.norm_eps)

        seq, nh, hd = x.shape[0], cfg.n_heads, cfg.head_dim
        scale = hd ** -0.5
        for i in range(cfg.n_run_layers()):
            layer = _layer(params["layers"], i)
            h = _ln(x, layer["ln1_g"], layer["ln1_b"], cfg.norm_eps)
            q = (h @ layer["wq"] + layer["bq"]).reshape(seq, nh, hd)
            k = (h @ layer["wk"] + layer["bk"]).reshape(seq, nh, hd)
            v = (h @ layer["wv"] + layer["bv"]).reshape(seq, nh, hd)
            scores = torch.einsum("qhd,khd->hqk", q.float(),
                                  k.float()) * scale
            probs = torch.softmax(scores, dim=-1).to(v.dtype)
            attn = torch.einsum("hqk,khd->qhd", probs, v).reshape(seq, -1)
            x = x + (attn @ layer["wo"] + layer["bo"])
            h = _ln(x, layer["ln2_g"], layer["ln2_b"], cfg.norm_eps)
            h = _act(cfg.act, h @ layer["w1"] + layer["b1"])
            x = x + (h @ layer["w2"] + layer["b2"])
        if cfg.post_ln:
            # SigLIP taps the post_layernorm output; LLaVA taps raw hidden
            # states (CLIP's post-LN only feeds its contrastive head).
            x = _ln(x, params["post_ln_g"], params["post_ln_b"],
                    cfg.norm_eps)
    return x[1:] if (cfg.use_cls and cfg.drop_cls) else x


@torch.no_grad()
def project_features(params: Dict[str, Any], cfg: CLIPVisionConfig,
                     feats: torch.Tensor) -> torch.Tensor:
    """Multi-modal projector: (N, dim) -> (N, proj_dim). LLaVA's
    linear-act-linear (proj_layers=2) or PaliGemma's single linear."""
    proj = params["proj"]
    with exact_f32():
        h = feats @ proj["w1"] + proj["b1"]
        if cfg.proj_layers == 1:
            return h
        return _act(cfg.proj_act, h) @ proj["w2"] + proj["b2"]


def encode_and_project(params: Dict[str, Any], cfg: CLIPVisionConfig,
                       pixels: torch.Tensor) -> torch.Tensor:
    """Pixels -> projected LLM-space image tokens."""
    return project_features(params, cfg, encode_image(params, cfg, pixels))


def preprocess_clip(image_u8, cfg: CLIPVisionConfig,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """HWC uint8 frame (numpy or a tensor, moved to ``device`` when given)
    -> CLIP-normalized (3, S, S) f32 on the frame's device."""
    frame = as_frame(image_u8, device)
    return clip_normalize_chw(frame, cfg.image_size, cfg.image_size)


def init_params(cfg: CLIPVisionConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random params in the converters' layout on ``generator``'s device
    (tests, the smoke): N(0, 0.02) matrices and embeddings, unit norms,
    zero biases, as the reference's ``init_params``."""
    dev = generator.device
    d, hd = cfg.dim, cfg.hidden_dim
    pp = 3 * cfg.patch_size * cfg.patch_size
    n = cfg.n_layers

    def w(*shape, s=0.02):
        return (torch.randn(shape, generator=generator, device=dev)
                * s).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    layers = {
        "ln1_g": ones(n, d), "ln1_b": zeros(n, d),
        "ln2_g": ones(n, d), "ln2_b": zeros(n, d),
        "wq": w(n, d, d), "bq": zeros(n, d),
        "wk": w(n, d, d), "bk": zeros(n, d),
        "wv": w(n, d, d), "bv": zeros(n, d),
        "wo": w(n, d, d), "bo": zeros(n, d),
        "w1": w(n, d, hd), "b1": zeros(n, hd),
        "w2": w(n, hd, d), "b2": zeros(n, d),
    }
    n_pos = cfg.n_patches + (1 if cfg.use_cls else 0)
    params: Dict[str, Any] = {"patch_w": w(pp, d), "pos": w(n_pos, d),
                              "layers": layers}
    if cfg.use_cls:
        params["cls"] = w(d)
    if cfg.patch_bias:
        params["patch_b"] = zeros(d)
    if cfg.pre_ln:
        params["pre_ln_g"], params["pre_ln_b"] = ones(d), zeros(d)
    if cfg.post_ln:
        params["post_ln_g"], params["post_ln_b"] = ones(d), zeros(d)
    if cfg.proj_dim:
        params["proj"] = {"w1": w(d, cfg.proj_dim),
                          "b1": zeros(cfg.proj_dim)}
        if cfg.proj_layers == 2:
            params["proj"]["w2"] = w(cfg.proj_dim, cfg.proj_dim)
            params["proj"]["b2"] = zeros(cfg.proj_dim)
    return params

