"""VITS inference graph (Piper voices), PyTorch.

Port of ``trackiellm_tpu/models/vits.py``, the published-architecture
twin that reads Piper voice checkpoints (the reference synthesizes through
Piper's VITS graphs, src/audio/tk_tts_piper.c:237). Inference only:

  phonemes -> text encoder (transformer with windowed relative attention)
           -> (m_p, logs_p)
  durations: the stochastic duration predictor's reverse pass (spline
             flows), or the deterministic predictor
  expand:    frame -> phoneme alignment from cumulative durations
             (searchsorted over a static max_frames)
  z_p = m_p + noise * exp(logs_p) * noise_scale
  flow^-1:   the residual coupling stack inverted
  decoder:   HiFiGAN generator -> waveform

Shapes are static (the phoneme bucket and max_frames), layouts are
channel-first (C, T) as in the torch graphs, and the params keep the
reference's tree. The reference draws its two noises from ``jax.random``
inside ``vits_infer``; here they are arguments (standard normal, ``(2,
max_phonemes)`` for the duration flow and ``(d_model, max_frames)`` for
the latent), which :class:`VITSVoice` draws from its own seeded
``torch.Generator``. GELU is the tanh form (``jax.nn.gelu``'s default);
convolutions run in full f32 (``exact_f32``); the durations' cumulative
sum is the reference's (``ops/scan.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.ops.backend import default_device, exact_f32
from trackiellm_tpu_torch.ops.scan import cumsum


class VITSConfig(NamedTuple):
    vocab_size: int = 256
    d_model: int = 192          # inter_channels == hidden_channels
    n_heads: int = 2
    n_layers: int = 6
    ffn_ch: int = 768
    ffn_kernel: int = 3
    window: int = 4             # relative-attention window
    # flow
    n_flows: int = 4
    wn_layers: int = 4
    wn_kernel: int = 5
    wn_dilation: int = 1
    # stochastic duration predictor
    sdp_ch: int = 192
    sdp_kernel: int = 3
    sdp_flows: int = 4
    sdp_bins: int = 10
    sdp_tail: float = 5.0
    # HiFiGAN decoder
    up_init_ch: int = 512
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernels: Tuple[int, ...] = (16, 16, 4, 4)
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    # static bounds
    max_phonemes: int = 256
    max_frames: int = 768
    sample_rate: int = 22050

    @property
    def hop(self) -> int:
        h = 1
        for r in self.upsample_rates:
            h *= r
        return h

    @classmethod
    def tiny(cls) -> "VITSConfig":
        return cls(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                   ffn_ch=64, up_init_ch=64, upsample_rates=(4, 4),
                   upsample_kernels=(8, 8), resblock_kernels=(3,),
                   resblock_dilations=((1, 3),), wn_layers=2,
                   sdp_ch=32, sdp_flows=2, max_phonemes=32,
                   max_frames=64, sample_rate=16000)


def stack_trees(trees: list) -> Any:
    """Stack same-shaped subtrees leaf by leaf on a new axis 0 (the
    reference's ``tree_map(jnp.stack, *trees)``)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [stack_trees([t[j] for t in trees])
                for j in range(len(first))]
    return torch.stack(trees)


def _at(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked subtree (each tensor indexed on axis 0)."""
    if isinstance(tree, dict):
        return {k: _at(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_at(v, i) for v in tree]
    return tree[i]


# ---------------------------------------------------------------------------
# Primitives (channel-first (C, T) layout like the torch graphs)
# ---------------------------------------------------------------------------

def _conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            stride: int = 1, padding: int = 0,
            dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """torch.nn.Conv1d on (C, T): w is (out, in/groups, K); the bias is
    added after the sum, as the reference adds it."""
    y = F.conv1d(x[None], w, None, stride=stride, padding=padding,
                 dilation=dilation, groups=groups)[0]
    if b is not None:
        y = y + b[:, None]
    return y


def _conv_transpose1d(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor], stride: int,
                      padding: int) -> torch.Tensor:
    """torch.nn.ConvTranspose1d on (C, T): w is (in, out, K)."""
    y = F.conv_transpose1d(x[None], w, None, stride=stride,
                           padding=padding)[0]
    if b is not None:
        y = y + b[:, None]
    return y


def _layer_norm_ct(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the channel axis of (C, T) (VITS LayerNorm)."""
    mu = torch.mean(x, dim=0, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=0, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g[:, None] + b[:, None]


def _gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Windowed relative-position multi-head attention (VITS attentions)
# ---------------------------------------------------------------------------

def _rel_attention(x: torch.Tensor, p: Dict[str, torch.Tensor],
                   n_heads: int, window: int,
                   mask: torch.Tensor) -> torch.Tensor:
    """Self-attention on (C, T) with learned relative key/value embeddings
    over a +/-window band (shared across heads)."""
    c, t = x.shape
    hd = c // n_heads
    dev = x.device
    q = _conv1d(x, p["q_w"], p["q_b"])
    k = _conv1d(x, p["k_w"], p["k_b"])
    v = _conv1d(x, p["v_w"], p["v_b"])
    q = q.reshape(n_heads, hd, t).transpose(1, 2)   # (H, T, D)
    k = k.reshape(n_heads, hd, t).transpose(1, 2)
    v = v.reshape(n_heads, hd, t).transpose(1, 2)

    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("htd,hsd->hts", q, k) * scale

    # Relative keys: emb_k is (2*window+1, D); the band's score of (t, s)
    # is rel[t, s - t + window] where |s - t| <= window.
    emb_k = p["emb_k"][0] if p["emb_k"].dim() == 3 else p["emb_k"]
    rel = torch.einsum("htd,rd->htr", q, emb_k) * scale  # (H, T, 2w+1)
    idx_t = torch.arange(t, device=dev)[:, None]
    idx_s = torch.arange(t, device=dev)[None, :]
    r_of_s = idx_s - idx_t + window                      # (T, S)
    in_band = (r_of_s >= 0) & (r_of_s <= 2 * window)
    band = rel.gather(2, r_of_s.clamp(0, 2 * window).expand(n_heads, t, t))
    scores = scores + torch.where(in_band[None], band, 0.0)

    scores = torch.where(mask[None], scores, -1e4)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("hts,hsd->htd", probs, v)

    # Relative values: the band of probs (s = t + r - window), weighting
    # emb_v.
    emb_v = p["emb_v"][0] if p["emb_v"].dim() == 3 else p["emb_v"]
    idx_r = torch.arange(2 * window + 1, device=dev)[None, :]
    s_of_r = idx_t + idx_r - window                      # (T, 2w+1)
    valid = (s_of_r >= 0) & (s_of_r < t)
    band_p = probs.gather(2, s_of_r.clamp(0, t - 1).expand(n_heads, t, -1))
    band_p = torch.where(valid[None], band_p, 0.0)
    out = out + torch.einsum("htr,rd->htd", band_p, emb_v)

    out = out.transpose(1, 2).reshape(c, t)
    return _conv1d(out, p["o_w"], p["o_b"])


def _encoder(x: torch.Tensor, p: Dict[str, Any], cfg: VITSConfig,
             x_mask: torch.Tensor) -> torch.Tensor:
    """VITS text-encoder transformer on (C, T)."""
    attn_mask = (x_mask[None, :] * x_mask[:, None]).bool()
    x = x * x_mask[None]
    pad = cfg.ffn_kernel // 2
    for i in range(cfg.n_layers):
        lp = _at(p["layers"], i)
        y = _rel_attention(x, lp["attn"], cfg.n_heads, cfg.window,
                           attn_mask)
        x = _layer_norm_ct(x + y, lp["ln1_g"], lp["ln1_b"])
        # FFN: conv(k) -> relu -> conv(k), with same padding.
        y = _conv1d(x * x_mask[None], lp["ffn_w1"], lp["ffn_b1"],
                    padding=pad)
        y = F.relu(y)
        y = _conv1d(y * x_mask[None], lp["ffn_w2"], lp["ffn_b2"],
                    padding=pad)
        x = _layer_norm_ct(x + y, lp["ln2_g"], lp["ln2_b"])
    return x * x_mask[None]


# ---------------------------------------------------------------------------
# WaveNet block (flow couplings)
# ---------------------------------------------------------------------------

def _wn(x: torch.Tensor, p: Dict[str, Any], cfg: VITSConfig,
        x_mask: torch.Tensor) -> torch.Tensor:
    """Gated dilated conv stack -> accumulated skip (VITS modules.WN, no
    global conditioning). Per-layer weights are lists (the last res_skip
    conv is half-width: skip only)."""
    h = x.shape[0]
    out = torch.zeros_like(x)
    for i in range(cfg.wn_layers):
        dil = cfg.wn_dilation ** i
        pad = (cfg.wn_kernel * dil - dil) // 2
        y = _conv1d(x, p["in_w"][i], p["in_b"][i], padding=pad,
                    dilation=dil)
        a, b = y[:h], y[h:]
        acts = torch.tanh(a) * torch.sigmoid(b)
        y = _conv1d(acts, p["rs_w"][i], p["rs_b"][i])
        if i < cfg.wn_layers - 1:
            x = (x + y[:h]) * x_mask[None]
            out = out + y[h:]
        else:
            out = out + y            # last layer: skip-only (h wide)
    return out * x_mask[None]


def _flow_inverse(z: torch.Tensor, p: Dict[str, Any], cfg: VITSConfig,
                  x_mask: torch.Tensor) -> torch.Tensor:
    """Invert the residual-coupling stack (mean-only couplings with a Flip
    between each, as VITS builds them)."""
    half = cfg.d_model // 2
    for i in reversed(range(cfg.n_flows)):
        # inverse of Flip (applied after each coupling in forward)
        z = torch.flip(z, dims=(0,))
        lp = _at(p["couplings"], i)
        z0, z1 = z[:half], z[half:]
        h = _conv1d(z0, lp["pre_w"], lp["pre_b"])
        h = _wn(h, lp["wn"], cfg, x_mask)
        m = _conv1d(h, lp["post_w"], lp["post_b"])
        z1 = (z1 - m) * x_mask[None]
        z = torch.cat([z0, z1], dim=0)
    return z


# ---------------------------------------------------------------------------
# Stochastic duration predictor (reverse pass)
# ---------------------------------------------------------------------------

def _dds_conv(x: torch.Tensor, p: Dict[str, Any], cfg: VITSConfig,
              x_mask: torch.Tensor, n_layers: int = 3) -> torch.Tensor:
    """Dilated depth-separable conv stack (VITS modules.DDSConv)."""
    k = cfg.sdp_kernel
    for i in range(n_layers):
        dil = k ** i
        pad = (k * dil - dil) // 2
        y = _conv1d(x * x_mask[None], p["sep_w"][i], p["sep_b"][i],
                    padding=pad, dilation=dil, groups=x.shape[0])
        y = _layer_norm_ct(y, p["ln1_g"][i], p["ln1_b"][i])
        y = _gelu(y)
        y = _conv1d(y, p["pw_w"][i], p["pw_b"][i])
        y = _layer_norm_ct(y, p["ln2_g"][i], p["ln2_b"][i])
        y = _gelu(y)
        x = x + y
    return x * x_mask[None]


def _rq_spline_inverse(y: torch.Tensor, widths: torch.Tensor,
                       heights: torch.Tensor, derivs: torch.Tensor,
                       tail: float) -> torch.Tensor:
    """Inverse of the piecewise rational-quadratic spline with linear tails
    (Durkan et al.; VITS transforms.py semantics).

    y: (...,) values to invert; widths/heights: (..., K) unnormalized bin
    params; derivs: (..., K-1) unnormalized internal derivatives."""
    n_bins = widths.shape[-1]
    min_w = min_h = 1e-3
    min_d = 1e-3

    w = torch.softmax(widths, dim=-1)
    w = min_w + (1 - min_w * n_bins) * w
    cum_w = cumsum(w)
    cum_w = torch.cat([torch.zeros_like(cum_w[..., :1]), cum_w], -1)
    cum_w = cum_w * 2 * tail - tail                      # [-tail, tail]

    h = torch.softmax(heights, dim=-1)
    h = min_h + (1 - min_h * n_bins) * h
    cum_h = cumsum(h)
    cum_h = torch.cat([torch.zeros_like(cum_h[..., :1]), cum_h], -1)
    cum_h = cum_h * 2 * tail - tail

    d = min_d + _softplus(derivs)
    ones = torch.ones_like(d[..., :1])                   # tail slope 1
    d = torch.cat([ones, d, ones], -1)                   # (..., K+1)

    inside = (y >= -tail) & (y <= tail)
    y_in = torch.clamp(y, -tail, tail)

    # locate bin by HEIGHT (inverting y -> x)
    idx = torch.sum((y_in[..., None] >= cum_h[..., 1:-1]).to(torch.int64),
                    dim=-1)

    def take(a):
        return torch.gather(a, -1, idx[..., None])[..., 0]
    x_k = take(cum_w[..., :-1])
    w_k = take(w) * 2 * tail
    y_k = take(cum_h[..., :-1])
    h_k = take(h) * 2 * tail
    d_k = take(d[..., :-1])
    d_k1 = take(d[..., 1:])
    s_k = h_k / w_k

    # Solve the quadratic for theta (fraction within the bin).
    dy = y_in - y_k
    a = h_k * (s_k - d_k) + dy * (d_k + d_k1 - 2 * s_k)
    b = h_k * d_k - dy * (d_k + d_k1 - 2 * s_k)
    c = -s_k * dy
    disc = torch.clamp(b * b - 4 * a * c, min=0.0)
    theta = (2 * c) / (-b - torch.sqrt(disc) + 1e-12)
    x = x_k + theta * w_k
    return torch.where(inside, x, y)


def _conv_flow_inverse(z: torch.Tensor, p: Dict[str, Any],
                       cfg: VITSConfig, cond: torch.Tensor,
                       x_mask: torch.Tensor) -> torch.Tensor:
    """Inverse of VITS modules.ConvFlow (spline coupling on 2 channels)."""
    z0, z1 = z[:1], z[1:]
    h = _conv1d(z0, p["pre_w"], p["pre_b"])
    h = _dds_conv(h + cond, p["dds"], cfg, x_mask)
    out = _conv1d(h, p["proj_w"], p["proj_b"]) * x_mask[None]
    k = cfg.sdp_bins
    c = z0.shape[0]                                      # = 1
    params = out.reshape(c, 3 * k - 1, -1).transpose(1, 2)  # (1,T,3K-1)
    widths = params[..., :k] / math.sqrt(cfg.sdp_ch)
    heights = params[..., k:2 * k] / math.sqrt(cfg.sdp_ch)
    derivs = params[..., 2 * k:]
    z1_new = _rq_spline_inverse(z1[0], widths[0], heights[0],
                                derivs[0], cfg.sdp_tail)[None]
    return torch.cat([z0, z1_new * x_mask[None]], dim=0)


def _sdp_reverse(x: torch.Tensor, p: Dict[str, Any], cfg: VITSConfig,
                 x_mask: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """StochasticDurationPredictor reverse pass -> log-durations (T,).
    VITS order: reversed(flows) with the first ConvFlow dropped ("remove a
    useless vflow"), noise shaped (2, T)."""
    h = _conv1d(x, p["pre_w"], p["pre_b"])
    h = _dds_conv(h, p["dds"], cfg, x_mask)
    h = _conv1d(h, p["proj_w"], p["proj_b"]) * x_mask[None]

    z = noise * x_mask[None]                              # (2, T)
    for i in reversed(range(1, cfg.sdp_flows)):
        z = torch.flip(z, dims=(0,))
        z = _conv_flow_inverse(z, _at(p["flows"], i), cfg, h, x_mask)
    z = torch.flip(z, dims=(0,))
    # ElementwiseAffine inverse: (z - m) * exp(-logs)
    z = (z - p["ea_m"][:, None]) * torch.exp(-p["ea_logs"][:, None])
    return z[0]


def _dp_deterministic(x: torch.Tensor, p: Dict[str, Any],
                      cfg: VITSConfig, x_mask: torch.Tensor
                      ) -> torch.Tensor:
    """VITS deterministic DurationPredictor -> log-durations (T,)."""
    pad = p["conv1_w"].shape[2] // 2
    h = _conv1d(x * x_mask[None], p["conv1_w"], p["conv1_b"], padding=pad)
    h = _layer_norm_ct(F.relu(h), p["ln1_g"], p["ln1_b"])
    h = _conv1d(h * x_mask[None], p["conv2_w"], p["conv2_b"], padding=pad)
    h = _layer_norm_ct(F.relu(h), p["ln2_g"], p["ln2_b"])
    out = _conv1d(h * x_mask[None], p["proj_w"], p["proj_b"])
    return out[0]


# ---------------------------------------------------------------------------
# HiFiGAN generator
# ---------------------------------------------------------------------------

_LRELU = 0.1


def _resblock(x: torch.Tensor, p: Dict[str, Any], kernel: int,
              dilations: Tuple[int, ...]) -> torch.Tensor:
    for j, dil in enumerate(dilations):
        pad = (kernel * dil - dil) // 2
        y = F.leaky_relu(x, _LRELU)
        y = _conv1d(y, p["c1_w"][j], p["c1_b"][j], padding=pad,
                    dilation=dil)
        y = F.leaky_relu(y, _LRELU)
        y = _conv1d(y, p["c2_w"][j], p["c2_b"][j], padding=kernel // 2)
        x = x + y
    return x


def _hifigan(z: torch.Tensor, p: Dict[str, Any],
             cfg: VITSConfig) -> torch.Tensor:
    """(C, T) latent -> (samples,) waveform."""
    x = _conv1d(z, p["pre_w"], p["pre_b"], padding=3)
    for i, (rate, kern) in enumerate(zip(cfg.upsample_rates,
                                         cfg.upsample_kernels)):
        x = F.leaky_relu(x, _LRELU)
        x = _conv_transpose1d(x, p["up_w"][i], p["up_b"][i],
                              stride=rate, padding=(kern - rate) // 2)
        acc = None
        for j, (k, dils) in enumerate(zip(cfg.resblock_kernels,
                                          cfg.resblock_dilations)):
            y = _resblock(x, p["res"][i][j], k, dils)
            acc = y if acc is None else acc + y
        x = acc / len(cfg.resblock_kernels)
    x = F.leaky_relu(x, _LRELU)
    x = _conv1d(x, p["post_w"], p["post_b"], padding=3)
    return torch.tanh(x)[0]


# ---------------------------------------------------------------------------
# Full inference
# ---------------------------------------------------------------------------

@torch.no_grad()
def vits_infer(params: Dict[str, Any], cfg: VITSConfig,
               phonemes: torch.Tensor,     # (max_phonemes,) int, padded
               n_phonemes: int,
               noise_w: Optional[torch.Tensor],  # (2, max_phonemes) N(0, 1)
               noise_z: torch.Tensor,      # (d_model, max_frames) N(0, 1)
               noise_scale: float = 0.667,
               length_scale: float = 1.0,
               noise_scale_w: float = 0.8,
               use_sdp: bool = True,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthesize. Returns (waveform (max_frames*hop,), n_frames as a 0-dim
    int32 tensor); samples past n_frames*hop are silence-masked. The two
    standard-normal draws are given (``noise_w`` is unused without the
    stochastic predictor)."""
    t = cfg.max_phonemes
    dev = params["emb"].device
    x_mask = (torch.arange(t, device=dev) < n_phonemes).float()
    with exact_f32():
        # Text encoder
        emb = params["emb"][phonemes.long()] * math.sqrt(cfg.d_model)
        x = _encoder(emb.T, params["enc"], cfg, x_mask)
        stats = _conv1d(x, params["proj_w"], params["proj_b"]) * x_mask[None]
        m_p, logs_p = stats[:cfg.d_model], stats[cfg.d_model:]

        # Durations
        if use_sdp:
            logw = _sdp_reverse(x, params["sdp"], cfg, x_mask,
                                noise_w * noise_scale_w)
        else:
            logw = _dp_deterministic(x, params["dp"], cfg, x_mask)
        w = torch.exp(logw) * x_mask * length_scale
        w_ceil = torch.ceil(w)
        cum = cumsum(w_ceil)
        n_frames = torch.clamp(cum[-1], max=float(cfg.max_frames)).to(
            torch.int32)

        # Frame -> phoneme alignment: frame f belongs to the first phoneme
        # whose cumulative duration exceeds f.
        frames = torch.arange(cfg.max_frames, dtype=torch.float32,
                              device=dev)
        ph_idx = torch.searchsorted(cum, frames, right=True)
        ph_idx = torch.clamp(ph_idx, 0, t - 1)
        y_mask = (torch.arange(cfg.max_frames, device=dev)
                  < n_frames).float()

        m_e = m_p[:, ph_idx] * y_mask[None]
        logs_e = logs_p[:, ph_idx]

        z_p = m_e + noise_z * torch.exp(logs_e) * noise_scale * y_mask[None]
        z = _flow_inverse(z_p, params["flow"], cfg, y_mask)
        wav = _hifigan(z * y_mask[None], params["dec"], cfg)
    sample_mask = torch.repeat_interleave(y_mask, cfg.hop)
    return wav * sample_mask, n_frames


class VITSVoice:
    """Piper-style voice surface over :func:`vits_infer`, on its params'
    device.

    Text goes through a phoneme id map (a Piper voice's .json carries
    ``phoneme_id_map``: {phoneme: [id]}, with '^'/'$' BOS/EOS and '_' pad
    interspersed); a grapheme fallback maps chars directly when there is no
    map. The noises come from the voice's own ``torch.Generator`` on that
    device, seeded by ``seed``."""

    def __init__(self, params: Dict[str, Any], cfg: VITSConfig,
                 phoneme_id_map: Optional[Dict[str, list]] = None,
                 intersperse_blank: bool = True, seed: int = 0):
        self.params = params
        self.cfg = cfg
        self.id_map = phoneme_id_map
        self.intersperse = intersperse_blank
        self.device = params["emb"].device
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    @classmethod
    def from_piper(cls, checkpoint_path: str, config_path: str,
                   max_frames: int = 768,
                   name_map: Optional[str] = "piper_vits",
                   device: Optional[torch.device] = None) -> "VITSVoice":
        """Load a Piper voice: weights (.onnx or .npz) and its .json config
        (phoneme_id_map, sample_rate), onto ``device`` (by default the CUDA
        card; with none it raises unless the CPU is asked for).

        ``name_map``: a bundled map's name or a JSON path normalizing the
        file's initializer names onto the converter's layout
        (``models/name_maps/piper_vits.json`` by default; None skips)."""
        import json

        from trackiellm_tpu_torch.models.convert import (apply_name_map,
                                                         load_name_map,
                                                         vits_from_torch)

        device = default_device(device, "load a voice")
        with open(config_path, encoding="utf-8") as f:
            conf = json.load(f)
        sr = int(conf.get("audio", {}).get("sample_rate", 22050))
        if checkpoint_path.endswith(".onnx"):
            from trackiellm_tpu_torch.models.onnx_reader import (
                read_onnx_initializers)

            state = read_onnx_initializers(checkpoint_path)
        else:
            with np.load(checkpoint_path) as z:
                state = {k: z[k] for k in z.files}
        if name_map:
            state = apply_name_map(state, load_name_map(name_map))
        params, cfg = vits_from_torch(state, max_frames=max_frames,
                                      sample_rate=sr, device=device)
        return cls(params, cfg, phoneme_id_map=conf.get("phoneme_id_map"))

    def _to_ids(self, text: str) -> list:
        if self.id_map:
            ids = []
            if "^" in self.id_map:
                ids.extend(self.id_map["^"])
            for ch in text:
                got = self.id_map.get(ch)
                if got:
                    ids.extend(got)
                    if self.intersperse and "_" in self.id_map:
                        ids.extend(self.id_map["_"])
            if "$" in self.id_map:
                ids.extend(self.id_map["$"])
            return ids
        # Grapheme fallback (synthetic voices / tests).
        return [1 + (ord(c) % (self.cfg.vocab_size - 1))
                for c in text.lower()]

    def phonemes(self, text: str) -> Tuple[torch.Tensor, int]:
        """The padded (max_phonemes,) ids of ``text`` on the device, and
        their count."""
        ids = self._to_ids(text)[: self.cfg.max_phonemes]
        padded = np.zeros(self.cfg.max_phonemes, np.int64)
        padded[: len(ids)] = ids
        return torch.from_numpy(padded).to(self.device), len(ids)

    def draw_noise(self) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """The next (duration, latent) standard-normal draws."""
        cfg = self.cfg
        noise_w = None
        if "sdp" in self.params:
            noise_w = torch.randn((2, cfg.max_phonemes), generator=self._gen,
                                  device=self.device)
        noise_z = torch.randn((cfg.d_model, cfg.max_frames),
                              generator=self._gen, device=self.device)
        return noise_w, noise_z

    def synthesize(self, text: str, noise_scale: float = 0.667,
                   length_scale: float = 1.0,
                   noise_scale_w: float = 0.8) -> np.ndarray:
        ph, n = self.phonemes(text)
        noise_w, noise_z = self.draw_noise()
        wav, n_frames = vits_infer(
            self.params, self.cfg, ph, n, noise_w, noise_z,
            noise_scale=noise_scale, length_scale=length_scale,
            noise_scale_w=noise_scale_w, use_sdp="sdp" in self.params)
        n = int(n_frames) * self.cfg.hop
        return wav[:n].cpu().numpy()


# ---------------------------------------------------------------------------
# Random init (tests / structural validation)
# ---------------------------------------------------------------------------

def init_vits(gen: torch.Generator, cfg: VITSConfig = VITSConfig()
              ) -> Dict[str, Any]:
    """Random params in the reference's layout and scales, on ``gen``'s
    device."""
    dev = gen.device
    c = cfg.d_model
    h = c // 2

    def ci(cout, cin, k):
        s = 1.0 / math.sqrt(cin * k)
        return (torch.rand((cout, cin, k), generator=gen, device=dev)
                * 2 - 1) * s

    def normal(*shape, s):
        return torch.randn(shape, generator=gen, device=dev) * s

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    def ones(*shape):
        return torch.ones(shape, device=dev)

    def attn_p():
        return {"q_w": ci(c, c, 1), "q_b": zeros(c),
                "k_w": ci(c, c, 1), "k_b": zeros(c),
                "v_w": ci(c, c, 1), "v_b": zeros(c),
                "o_w": ci(c, c, 1), "o_b": zeros(c),
                "emb_k": normal(2 * cfg.window + 1, c // cfg.n_heads, s=0.1),
                "emb_v": normal(2 * cfg.window + 1, c // cfg.n_heads,
                                s=0.1)}

    def enc_layer():
        return {"attn": attn_p(), "ln1_g": ones(c), "ln1_b": zeros(c),
                "ffn_w1": ci(cfg.ffn_ch, c, cfg.ffn_kernel),
                "ffn_b1": zeros(cfg.ffn_ch),
                "ffn_w2": ci(c, cfg.ffn_ch, cfg.ffn_kernel),
                "ffn_b2": zeros(c), "ln2_g": ones(c), "ln2_b": zeros(c)}

    enc = {"layers": stack_trees([enc_layer()
                                  for _ in range(cfg.n_layers)])}

    def wn_p(hidden):
        last = cfg.wn_layers - 1
        return {
            "in_w": [ci(2 * hidden, hidden, cfg.wn_kernel)
                     for _ in range(cfg.wn_layers)],
            "in_b": [zeros(2 * hidden) for _ in range(cfg.wn_layers)],
            "rs_w": [ci(2 * hidden if i < last else hidden, hidden, 1)
                     for i in range(cfg.wn_layers)],
            "rs_b": [zeros(2 * hidden if i < last else hidden)
                     for i in range(cfg.wn_layers)],
        }

    def coupling():
        return {"pre_w": ci(c, h, 1), "pre_b": zeros(c), "wn": wn_p(c),
                "post_w": zeros(h, c, 1), "post_b": zeros(h)}

    flow = {"couplings": stack_trees([coupling()
                                      for _ in range(cfg.n_flows)])}

    def dds_p(ch, n_layers=3):
        return {
            "sep_w": torch.stack([ci(ch, 1, cfg.sdp_kernel)
                                  for _ in range(n_layers)]),
            "sep_b": zeros(n_layers, ch),
            "pw_w": torch.stack([ci(ch, ch, 1) for _ in range(n_layers)]),
            "pw_b": zeros(n_layers, ch),
            "ln1_g": ones(n_layers, ch), "ln1_b": zeros(n_layers, ch),
            "ln2_g": ones(n_layers, ch), "ln2_b": zeros(n_layers, ch),
        }

    def conv_flow():
        return {"pre_w": ci(cfg.sdp_ch, 1, 1), "pre_b": zeros(cfg.sdp_ch),
                "dds": dds_p(cfg.sdp_ch),
                "proj_w": zeros(3 * cfg.sdp_bins - 1, cfg.sdp_ch, 1),
                "proj_b": zeros(3 * cfg.sdp_bins - 1)}

    sdp = {"pre_w": ci(cfg.sdp_ch, c, 1), "pre_b": zeros(cfg.sdp_ch),
           "dds": dds_p(cfg.sdp_ch),
           "proj_w": ci(cfg.sdp_ch, cfg.sdp_ch, 1),
           "proj_b": zeros(cfg.sdp_ch),
           "flows": stack_trees([conv_flow()
                                 for _ in range(cfg.sdp_flows)]),
           "ea_m": zeros(2), "ea_logs": zeros(2)}

    dp = {"conv1_w": ci(256, c, 3), "conv1_b": zeros(256),
          "ln1_g": ones(256), "ln1_b": zeros(256),
          "conv2_w": ci(256, 256, 3), "conv2_b": zeros(256),
          "ln2_g": ones(256), "ln2_b": zeros(256),
          "proj_w": ci(1, 256, 1), "proj_b": zeros(1)}

    # HiFiGAN
    ch = cfg.up_init_ch
    ups_w, ups_b, res = [], [], []
    in_ch = ch
    for i, kern in enumerate(cfg.upsample_kernels):
        out_ch = ch // (2 ** (i + 1))
        ups_w.append(normal(in_ch, out_ch, kern, s=0.02))
        ups_b.append(zeros(out_ch))
        res.append([{
            "c1_w": torch.stack([ci(out_ch, out_ch, k) for _ in dils]),
            "c1_b": zeros(len(dils), out_ch),
            "c2_w": torch.stack([ci(out_ch, out_ch, k) for _ in dils]),
            "c2_b": zeros(len(dils), out_ch),
        } for k, dils in zip(cfg.resblock_kernels, cfg.resblock_dilations)])
        in_ch = out_ch

    dec = {"pre_w": ci(ch, c, 7), "pre_b": zeros(ch),
           "up_w": ups_w, "up_b": ups_b, "res": res,
           "post_w": ci(1, in_ch, 7), "post_b": zeros(1)}

    return {
        "emb": normal(cfg.vocab_size, c, s=0.1),
        "enc": enc,
        "proj_w": ci(2 * c, c, 1), "proj_b": zeros(2 * c),
        "sdp": sdp, "dp": dp, "flow": flow, "dec": dec,
    }
