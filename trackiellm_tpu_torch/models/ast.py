"""AST (Audio Spectrogram Transformer): the ambient-sound classifier's
published-checkpoint route.

Port of ``trackiellm_tpu/models/ast.py``. The reference ships an ONNX
sound classifier detecting ALARM / SIREN / WATER_RUNNING / DOG_BARK
(src/audio/tk_sound_classifier.h:31-39); this module runs
``MIT/ast-finetuned-audioset-10-10-0.4593`` (and any HF
``ASTForAudioClassification``, through ``convert.ast_from_hf``), with the
AudioSet label space mapped onto those four ambient classes, as
``AudioPipeline``'s ``sound_fn``.

One forward on the params' device under ``exact_f32``: the overlapping
16x16 patches at stride 10x10 as a strided convolution, the CLS and DIST
prefix, the pre-LN ViT stack over ``models/trocr.py``'s blocks, and the
(CLS+DIST)/2 pooled head. The reference's attention and matmuls are plain
XLA (no Pallas kernel). ``ast_features`` is the reference's host numpy
front end (close to, not bit-exact with, the Kaldi fbank the published
checkpoints trained on).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.models.trocr import _layer, _ln, _vit_layer
from trackiellm_tpu_torch.ops.backend import exact_f32


class ASTConfig(NamedTuple):
    n_mels: int = 128
    n_frames: int = 1024          # max_length (10.24 s at 10 ms hop)
    patch: int = 16
    fstride: int = 10
    tstride: int = 10
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    hidden: int = 3072
    eps: float = 1e-12
    n_labels: int = 527           # AudioSet

    @property
    def f_dim(self) -> int:
        return (self.n_mels - self.patch) // self.fstride + 1

    @property
    def t_dim(self) -> int:
        return (self.n_frames - self.patch) // self.tstride + 1

    @property
    def n_patches(self) -> int:
        return self.f_dim * self.t_dim

    @classmethod
    def tiny(cls) -> "ASTConfig":
        return cls(n_mels=16, n_frames=64, patch=8, fstride=8,
                   tstride=8, dim=32, n_layers=2, n_heads=4, hidden=64,
                   n_labels=5)


@torch.no_grad()
def ast_logits(params: Dict[str, Any], cfg: ASTConfig,
               spec: torch.Tensor) -> torch.Tensor:
    """(n_frames, n_mels) normalized features -> (n_labels,) logits.

    ASTModel's order: input (T, F) -> (1, 1, F, T) -> strided patch conv
    -> tokens flattened (f-major, t-minor), CLS+DIST prefixes, pre-LN ViT
    stack, final LN, (CLS+DIST)/2 -> LN+dense head."""
    p = params
    with exact_f32():
        x = spec.float().T[None, None]                   # (1, 1, F, T)
        feat = F.conv2d(x, p["patch_w"],
                        stride=(cfg.fstride, cfg.tstride))  # (1, D, f, t)
        tokens = feat[0].reshape(cfg.dim, -1).T + p["patch_b"]
        h = (torch.cat([p["prefix"], tokens], dim=0) + p["pos"])[None]
        for i in range(cfg.n_layers):
            h = _vit_layer(h, _layer(p["layers"], i), cfg.n_heads, cfg.eps)
        h = _ln(h[0], p["ln_g"], p["ln_b"], cfg.eps)
        pooled = (h[0] + h[1]) / 2.0
        pooled = _ln(pooled, p["head_ln_g"], p["head_ln_b"], cfg.eps)
        return pooled @ p["head_w"] + p["head_b"]


# AudioSet label-name fragments -> the reference's ambient classes
# (tk_sound_classifier.h:31-39), named as ``SoundClass`` names them, the
# names the cortex reads (``cortex/main.py``: ALARM and SIREN are spoken
# as urgent). Matching is substring-based over the checkpoint's id2label
# names so finetuned label spaces keep working.
AMBIENT_MAP: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("ALARM", ("alarm", "smoke detector", "fire alarm", "buzzer")),
    ("SIREN", ("siren", "ambulance", "police car", "fire engine",
               "civil defense")),
    ("WATER_RUNNING", ("water tap", "sink", "water", "bathtub",
                       "fill (with liquid)")),
    ("DOG_BARK", ("dog", "bark", "bow-wow", "growling", "yip")),
)


class ASTSoundClassifier:
    """The audio pipeline's ``sound_fn`` surface: 16 kHz window ->
    ambient class name or None (reference semantics: passive listening
    announces ALARM/SIREN/WATER_RUNNING/DOG_BARK).

    ``labels``: the checkpoint's ordered label names (id2label); each
    ambient class scores as the max logit over its matching labels,
    reported when its sigmoid tops ``threshold`` (AudioSet heads are
    multi-label sigmoid). The forward runs on the params' device; its
    logits come back to the host in one copy."""

    def __init__(self, params: Dict[str, Any], cfg: ASTConfig,
                 labels: Sequence[str], threshold: float = 0.5,
                 features_fn=None):
        self.params = params
        self.cfg = cfg
        self.threshold = threshold
        self.features_fn = features_fn or (
            lambda audio: ast_features(audio, cfg))
        self.device = params["patch_w"].device
        lowered = [str(name).lower() for name in labels]
        self._class_ids: Dict[str, list] = {}
        for ours, fragments in AMBIENT_MAP:
            ids = [i for i, name in enumerate(lowered)
                   if any(f in name for f in fragments)]
            if ids:
                self._class_ids[ours] = ids

    def __call__(self, audio: np.ndarray) -> Optional[str]:
        spec = self.features_fn(np.asarray(audio, np.float32))
        logits = ast_logits(self.params, self.cfg, torch.as_tensor(
            spec, device=self.device)).cpu().numpy()
        probs = 1.0 / (1.0 + np.exp(-logits))
        best, best_p = None, self.threshold
        for ours, ids in self._class_ids.items():
            p = float(probs[ids].max())
            if p > best_p:
                best, best_p = ours, p
        return best


def ast_features(audio: np.ndarray, cfg: ASTConfig,
                 sample_rate: int = 16000,
                 mean: float = -4.2677393,
                 std: float = 4.5689974) -> np.ndarray:
    """Raw 16 kHz audio -> (n_frames, n_mels) normalized log-mel
    features in the AST input shape (25 ms window / 10 ms hop, the
    AudioSet normalization stats), host numpy as in the reference."""
    from trackiellm_tpu_torch.ops.mel import mel_filterbank

    n_fft = 400  # 25 ms @ 16 kHz
    hop = 160    # 10 ms
    a = np.asarray(audio, np.float32)
    need = (cfg.n_frames - 1) * hop + n_fft
    if a.size < need:
        a = np.pad(a, (0, need - a.size))
    frames = np.lib.stride_tricks.sliding_window_view(
        a, n_fft)[::hop][: cfg.n_frames]
    window = np.hanning(n_fft).astype(np.float32)
    spec = np.abs(np.fft.rfft(frames * window, axis=-1)) ** 2
    fb = np.asarray(mel_filterbank(n_mels=cfg.n_mels, n_fft=n_fft,
                                   sample_rate=sample_rate),
                    np.float32)  # (n_freqs, n_mels)
    mel = spec @ fb
    logmel = np.log(np.maximum(mel, 1e-10))
    return ((logmel - mean) / (2.0 * std)).astype(np.float32)


def init_params(gen: torch.Generator, cfg: ASTConfig,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Random params from ``gen``, on its device (tests, the smoke):
    N(0, 0.05) weights, unit norms, zero biases, as the reference's."""
    dev = gen.device

    def R(*shape, s=0.05):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=dtype) * s

    def zeros(*shape):
        return torch.zeros(shape, device=dev, dtype=dtype)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    d, hd, n = cfg.dim, cfg.hidden, cfg.n_layers
    layers = {"ln1_g": ones(n, d), "ln1_b": zeros(n, d),
              "ln2_g": ones(n, d), "ln2_b": zeros(n, d)}
    for nm, shp in (("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)),
                    ("wo", (d, d)), ("w1", (d, hd)), ("w2", (hd, d))):
        layers[nm] = R(n, *shp)
    for nm, width in (("bq", d), ("bk", d), ("bv", d), ("bo", d),
                      ("b1", hd), ("b2", d)):
        layers[nm] = zeros(n, width)
    return {
        "patch_w": R(d, 1, cfg.patch, cfg.patch),
        "patch_b": zeros(d),
        "prefix": R(2, d),
        "pos": R(cfg.n_patches + 2, d),
        "ln_g": ones(d), "ln_b": zeros(d),
        "head_ln_g": ones(d), "head_ln_b": zeros(d),
        "head_w": R(d, cfg.n_labels),
        "head_b": zeros(cfg.n_labels),
        "layers": layers,
    }
