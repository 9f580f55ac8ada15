"""Ambient sound classifier over log-mel windows.

Port of ``trackiellm_tpu/models/sound_classifier.py``. Parity target: the
reference's ONNX sound classifier with ALARM / SIREN / WATER_RUNNING /
DOG_BARK classes (reference: src/audio/tk_sound_classifier.h:31-39,
tk_sound_classifier.c:14).

Architecture: 3 conv blocks (a "SAME" 3x3 convolution, ReLU, a 2x2 "SAME"
max-pool) over a (n_mels, T) log-mel window, global average pool, dense
head. Convolution weights are OIHW here (the JAX package's are HWIO;
``models/bridge.py:hwio_tree_from_jax`` carries them across); the forward
runs on the params' device under ``exact_f32``.
"""

from __future__ import annotations

import enum
import math
from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.models.depth import same_padding_2d
from trackiellm_tpu_torch.ops.backend import exact_f32


class SoundClass(enum.IntEnum):
    """Parity: tk_sound_classifier.h:31-39 (+ SILENCE/SPEECH/OTHER)."""

    SILENCE = 0
    SPEECH = 1
    ALARM = 2
    SIREN = 3
    WATER_RUNNING = 4
    DOG_BARK = 5
    OTHER = 6


class SoundClassifierConfig(NamedTuple):
    n_mels: int = 64
    n_frames: int = 96   # ~1 s @ 16 kHz / hop 160
    ch: int = 32
    num_classes: int = len(SoundClass)

    @classmethod
    def default(cls) -> "SoundClassifierConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "SoundClassifierConfig":
        return cls(n_mels=32, n_frames=32, ch=8)


def _uniform(gen: torch.Generator, shape, s: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=gen.device) * 2 - 1) * s


def _conv_init(gen, kh, kw, cin, cout):
    s = 1.0 / math.sqrt(kh * kw * cin)
    return {"w": _uniform(gen, (cout, cin, kh, kw), s),
            "b": torch.zeros((cout,), device=gen.device)}


def init_sound_classifier(gen: torch.Generator,
                          cfg: SoundClassifierConfig) -> Dict[str, Any]:
    """Random params from ``gen``, on its device: U(+-1/sqrt(fan_in))
    weights, zero biases, as the reference's."""
    c = cfg.ch
    s = 1.0 / math.sqrt(2 * c)
    return {
        "conv1": _conv_init(gen, 3, 3, 1, c // 2),
        "conv2": _conv_init(gen, 3, 3, c // 2, c),
        "conv3": _conv_init(gen, 3, 3, c, 2 * c),
        "out_w": _uniform(gen, (2 * c, cfg.num_classes), s),
        "out_b": torch.zeros((cfg.num_classes,), device=gen.device),
    }


def _block(x, p):
    """XLA's "SAME" 3x3 convolution, ReLU, then the 2x2 stride-2 "SAME"
    max-pool (its odd pad after, filled with -inf)."""
    pads = same_padding_2d(x.shape[2], x.shape[3], 3, 3, 1)
    x = F.relu(F.conv2d(F.pad(x, pads), p["w"]) + p["b"][:, None, None])
    pads = same_padding_2d(x.shape[2], x.shape[3], 2, 2, 2)
    return F.max_pool2d(F.pad(x, pads, value=-math.inf), 2, 2)


@torch.no_grad()
def classify_window(params: Dict[str, Any], cfg: SoundClassifierConfig,
                    log_mel: torch.Tensor) -> torch.Tensor:
    """(n_mels, n_frames) log-mel -> (num_classes,) probabilities."""
    with exact_f32():
        x = log_mel.float()[None, None]
        for name in ("conv1", "conv2", "conv3"):
            x = _block(x, params[name])
        pooled = x[0].mean(dim=(1, 2))
        return torch.softmax(pooled @ params["out_w"] + params["out_b"], -1)
