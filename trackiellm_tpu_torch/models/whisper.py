"""Whisper-family encoder-decoder ASR, PyTorch.

Port of ``trackiellm_tpu/models/whisper.py`` (the reference's whisper.cpp
integration: GGML Whisper, greedy sampling, full-segment transcription):
two convolutions over the log-mel spectrogram, sinusoidal positions and a
pre-LN encoder; a decoder with learned positions, causal self-attention
over a KV cache, cross-attention to the audio and a tied output
embedding. The params keep the reference's tree: per-layer weights stacked
on a leading axis, matrices as (in, out), convolutions as (K, in, out).

Numerics follow the reference: its GELU is ``jax.nn.gelu``'s tanh form;
its "SAME" padding of the stride-2 convolution pads (0, 1)
(``ops/conv.py``); attention is
the dense f32 softmax of ``ops/attention.py:attention_ref``; convolutions
and matmuls run in full f32 (``exact_f32``). The reference runs the greedy
loop as one compiled program; here it is a loop on the host over device
steps, with one fetch of the argmax a token.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.ops.attention import attention_ref
from trackiellm_tpu_torch.ops.backend import exact_f32
from trackiellm_tpu_torch.ops.conv import conv1d_tio


class WhisperConfig(NamedTuple):
    n_mels: int = 80
    d_model: int = 384
    n_heads: int = 6
    n_audio_layers: int = 4
    n_text_layers: int = 4
    n_audio_ctx: int = 1500  # 30 s of mel frames / 2
    n_text_ctx: int = 448
    vocab_size: int = 51865

    @classmethod
    def tiny(cls) -> "WhisperConfig":
        return cls()

    @classmethod
    def base(cls) -> "WhisperConfig":
        """openai/whisper-base (d512/h8/6+6 layers)."""
        return cls(d_model=512, n_heads=8, n_audio_layers=6,
                   n_text_layers=6)

    @classmethod
    def small(cls) -> "WhisperConfig":
        """openai/whisper-small (d768/h12/12+12 layers)."""
        return cls(d_model=768, n_heads=12, n_audio_layers=12,
                   n_text_layers=12)

    @classmethod
    def medium(cls) -> "WhisperConfig":
        """openai/whisper-medium (d1024/h16/24+24 layers)."""
        return cls(d_model=1024, n_heads=16, n_audio_layers=24,
                   n_text_layers=24)

    @classmethod
    def large_v3(cls) -> "WhisperConfig":
        """openai/whisper-large-v3 (d1280/h20/32+32 layers, 128 mel bins,
        +1 vocab entry for the <|yue|> language token)."""
        return cls(n_mels=128, d_model=1280, n_heads=20,
                   n_audio_layers=32, n_text_layers=32,
                   vocab_size=51866)

    @classmethod
    def test(cls) -> "WhisperConfig":
        return cls(n_mels=80, d_model=64, n_heads=2, n_audio_layers=2,
                   n_text_layers=2, n_audio_ctx=100, n_text_ctx=32,
                   vocab_size=320)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _dense(gen: torch.Generator, n: int, cin: int, cout: int):
    s = 1.0 / math.sqrt(cin)
    return (torch.rand((n, cin, cout), generator=gen, device=gen.device)
            * 2 - 1) * s


def _layer_stack(gen: torch.Generator, n: int, d: int) -> Dict[str, Any]:
    """Stacked transformer-layer params: self-attention and MLP, (n, ...);
    the q/v/out biases are zeros, as the reference initializes them."""
    dev = gen.device

    def zeros(*shape):
        return torch.zeros(shape, device=dev)
    return {
        "ln1": torch.ones((n, d), device=dev), "ln1_b": zeros(n, d),
        "wq": _dense(gen, n, d, d), "wk": _dense(gen, n, d, d),
        "wv": _dense(gen, n, d, d), "wo": _dense(gen, n, d, d),
        "bq": zeros(n, d), "bv": zeros(n, d), "bo": zeros(n, d),
        "ln2": torch.ones((n, d), device=dev), "ln2_b": zeros(n, d),
        "w1": _dense(gen, n, d, 4 * d), "b1": zeros(n, 4 * d),
        "w2": _dense(gen, n, 4 * d, d), "b2": zeros(n, d),
    }


def _cross_stack(gen: torch.Generator, n: int, d: int) -> Dict[str, Any]:
    dev = gen.device
    return {
        "ln": torch.ones((n, d), device=dev),
        "ln_b": torch.zeros((n, d), device=dev),
        "wq": _dense(gen, n, d, d), "wk": _dense(gen, n, d, d),
        "wv": _dense(gen, n, d, d), "wo": _dense(gen, n, d, d),
        "bq": torch.zeros((n, d), device=dev),
        "bv": torch.zeros((n, d), device=dev),
        "bo": torch.zeros((n, d), device=dev),
    }


def init_whisper(gen: torch.Generator, cfg: WhisperConfig) -> Dict[str, Any]:
    """Random params in the reference's layout and scales, on ``gen``'s
    device."""
    d = cfg.d_model
    dev = gen.device

    def normal(*shape, s):
        return torch.randn(shape, generator=gen, device=dev) * s
    return {
        "conv1_w": normal(3, cfg.n_mels, d, s=0.02),
        "conv1_b": torch.zeros((d,), device=dev),
        "conv2_w": normal(3, d, d, s=0.02),
        "conv2_b": torch.zeros((d,), device=dev),
        "enc": _layer_stack(gen, cfg.n_audio_layers, d),
        "enc_ln": torch.ones((d,), device=dev),
        "enc_ln_b": torch.zeros((d,), device=dev),
        "tok_emb": normal(cfg.vocab_size, d, s=0.02),
        "pos_emb": normal(cfg.n_text_ctx, d, s=0.01),
        "dec": _layer_stack(gen, cfg.n_text_layers, d),
        "cross": _cross_stack(gen, cfg.n_text_layers, d),
        "dec_ln": torch.ones((d,), device=dev),
        "dec_ln_b": torch.zeros((d,), device=dev),
    }


def _ln(x, w, b, eps=1e-5):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


@functools.lru_cache(maxsize=8)
def _sinusoids(length: int, channels: int,
               device: torch.device) -> torch.Tensor:
    """Whisper's sinusoidal positions for the audio encoder, (length,
    channels) f32 on ``device``: made in numpy once a shape and device."""
    log_timescale = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return torch.from_numpy(np.concatenate(
        [np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)
    ).to(device)


def _mha(q, k, v, n_heads):
    s, d = q.shape
    hd = d // n_heads
    qh = q.reshape(s, n_heads, hd).transpose(0, 1)
    kh = k.reshape(-1, n_heads, hd).transpose(0, 1)
    vh = v.reshape(-1, n_heads, hd).transpose(0, 1)
    out = attention_ref(qh, kh, vh, causal=False)
    return out.transpose(0, 1).reshape(s, d)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

@torch.no_grad()
def encode(params: Dict[str, Any], cfg: WhisperConfig,
           mel: torch.Tensor) -> torch.Tensor:
    """(n_mels, T) log-mel -> (T//2, d_model) audio features."""
    with exact_f32():
        x = mel.T  # (T, n_mels)
        x = _gelu(conv1d_tio(x, params["conv1_w"], params["conv1_b"]))
        x = _gelu(conv1d_tio(x, params["conv2_w"], params["conv2_b"],
                             stride=2))
        t = x.shape[0]
        x = x + _sinusoids(t, cfg.d_model, x.device)
        enc = params["enc"]
        for i in range(cfg.n_audio_layers):
            lp = {k: v[i] for k, v in enc.items()}
            h = _ln(x, lp["ln1"], lp["ln1_b"])
            attn = _mha(h @ lp["wq"] + lp["bq"], h @ lp["wk"],
                        h @ lp["wv"] + lp["bv"], cfg.n_heads)
            x = x + attn @ lp["wo"] + lp["bo"]
            h = _ln(x, lp["ln2"], lp["ln2_b"])
            x = x + (_gelu(h @ lp["w1"] + lp["b1"]) @ lp["w2"] + lp["b2"])
        return _ln(x, params["enc_ln"], params["enc_ln_b"])


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class DecoderCache(NamedTuple):
    """Self-attention keys and values (L, n_text_ctx, D), written in place
    by :func:`decode_step` at row ``length`` (rows at or past ``length``
    are masked), and the cross-attention keys and values (L, T_audio, D).
    ``length`` is a host int, so a step's position never waits on the
    device."""

    k: torch.Tensor
    v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    length: int


@torch.no_grad()
def make_decoder_cache(params: Dict[str, Any], cfg: WhisperConfig,
                       audio_feats: torch.Tensor) -> DecoderCache:
    """Precompute per-layer cross K/V from the encoded audio."""
    cp = params["cross"]
    ck, cv = [], []
    with exact_f32():
        for i in range(cfg.n_text_layers):
            h = _ln(audio_feats, cp["ln"][i], cp["ln_b"][i])
            ck.append(h @ cp["wk"][i])
            cv.append(h @ cp["wv"][i] + cp["bv"][i])
    shape = (cfg.n_text_layers, cfg.n_text_ctx, cfg.d_model)
    dev = audio_feats.device
    return DecoderCache(
        k=torch.zeros(shape, device=dev), v=torch.zeros(shape, device=dev),
        cross_k=torch.stack(ck), cross_v=torch.stack(cv), length=0)


@torch.no_grad()
def decode_step(params: Dict[str, Any], cfg: WhisperConfig,
                token, cache: DecoderCache,
                ) -> Tuple[torch.Tensor, DecoderCache]:
    """One decoder step for the int ``token`` -> (vocab logits, cache +
    1)."""
    pos = cache.length
    hd = cfg.head_dim
    dec, cross = params["dec"], params["cross"]
    mask = (torch.arange(cfg.n_text_ctx, device=cache.k.device) <= pos)
    with exact_f32():
        x = params["tok_emb"][token].reshape(1, -1) + params["pos_emb"][pos]
        for i in range(cfg.n_text_layers):
            lp = {k: v[i] for k, v in dec.items()}
            cp = {k: v[i] for k, v in cross.items()}
            h = _ln(x, lp["ln1"], lp["ln1_b"])
            q = h @ lp["wq"] + lp["bq"]
            cache.k[i, pos] = (h @ lp["wk"])[0]
            cache.v[i, pos] = (h @ lp["wv"] + lp["bv"])[0]
            # Masked self-attention over the cache prefix.
            qh = q.reshape(1, cfg.n_heads, hd).transpose(0, 1)
            kh = cache.k[i].reshape(-1, cfg.n_heads, hd).transpose(0, 1)
            vh = cache.v[i].reshape(-1, cfg.n_heads, hd).transpose(0, 1)
            scores = torch.einsum("hqd,hkd->hqk", qh, kh) / math.sqrt(hd)
            scores = torch.where(mask[None, None, :], scores, -1e30)
            attn = torch.einsum("hqk,hkd->hqd", torch.softmax(scores, -1),
                                vh)
            x = (x + attn.transpose(0, 1).reshape(1, -1) @ lp["wo"]
                 + lp["bo"])

            # Cross-attention to the audio.
            h = _ln(x, cp["ln"], cp["ln_b"])
            attn = _mha(h @ cp["wq"] + cp["bq"], cache.cross_k[i],
                        cache.cross_v[i], cfg.n_heads)
            x = x + attn @ cp["wo"] + cp["bo"]

            h = _ln(x, lp["ln2"], lp["ln2_b"])
            x = x + (_gelu(h @ lp["w1"] + lp["b1"]) @ lp["w2"] + lp["b2"])
        x = _ln(x, params["dec_ln"], params["dec_ln_b"])
        logits = (x @ params["tok_emb"].T)[0]  # tied embedding
    return logits, cache._replace(length=pos + 1)


# ---------------------------------------------------------------------------
# Greedy transcription loop (host)
# ---------------------------------------------------------------------------

# Special-token layout (Whisper multilingual convention, scaled to any
# vocab): sot/eot/language/task live at the top of the vocab.
def special_tokens(cfg: WhisperConfig) -> Dict[str, int]:
    return {
        "eot": cfg.vocab_size - 1,
        "sot": cfg.vocab_size - 2,
        "transcribe": cfg.vocab_size - 3,
        "no_timestamps": cfg.vocab_size - 4,
        "lang_base": cfg.vocab_size - 104,  # 100 language slots
    }


def _prompt(cfg: WhisperConfig, language: int) -> List[int]:
    sp = special_tokens(cfg)
    return [sp["sot"], sp["lang_base"] + language, sp["transcribe"],
            sp["no_timestamps"]]


def transcribe_tokens_host(params: Dict[str, Any], cfg: WhisperConfig,
                           mel: torch.Tensor, max_tokens: int = 64,
                           language: int = 0) -> list:
    """Greedy decode -> list of token ids (text tokens only), with the
    reference host loop's steps: each token's argmax is fetched as an int,
    checked against the stop rules (EOT, or ``length >= n_text_ctx - 1``)
    and fed back."""
    sp = special_tokens(cfg)
    feats = encode(params, cfg, mel)
    cache = make_decoder_cache(params, cfg, feats)

    out = []
    logits = None
    for t in _prompt(cfg, language):
        logits, cache = decode_step(params, cfg, t, cache)
    for _ in range(max_tokens):
        tok = int(torch.argmax(logits))
        if tok == sp["eot"] or cache.length >= cfg.n_text_ctx - 1:
            break
        out.append(tok)
        logits, cache = decode_step(params, cfg, tok, cache)
    return out


def transcribe_tokens(params: Dict[str, Any], cfg: WhisperConfig,
                      mel: torch.Tensor, max_tokens: int = 64,
                      language: int = 0) -> list:
    """Greedy decode -> list of token ids (text tokens only).

    The reference runs this as one compiled program (``encode``, the
    cross K/V, four prompt steps and a ``lax.while_loop``). Here it is the
    host loop of :func:`transcribe_tokens_host`, under the reference's
    name."""
    return transcribe_tokens_host(params, cfg, mel, max_tokens, language)
