"""Wake-word detection.

Port of ``trackiellm_tpu/audio/wake_word.py``. Parity target: the
reference's Porcupine wrapper with per-keyword sensitivity (reference:
src/audio/tk_wake_word_porcupine.c:15, tk_audio_pipeline.h:88). Porcupine
is a proprietary blob; the rebuild ships a small conv keyword spotter over
log-mel windows (the standard open KWS architecture) with the same
sensitivity-thresholded streaming interface.

Convolution weights are OIHW here (the JAX package's are HWIO); the
``.npz`` artifact keeps the JAX package's layout, so one file serves both.
Every forward runs on the params' device under ``exact_f32``;
``train_wake_word`` trains there, its backward in full f32 too, and
``trackiellm_tpu_torch/tools/train_wake_word_default.py`` trains and writes
an artifact as the JAX package's tool does.
"""

from __future__ import annotations

import math
import os
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.models.depth import same_padding_2d
from trackiellm_tpu_torch.ops.backend import default_device, exact_f32
from trackiellm_tpu_torch.ops.mel import log_mel_spectrogram


class WakeWordConfig(NamedTuple):
    n_mels: int = 40
    n_frames: int = 76       # ~0.76 s window
    ch: int = 16
    sensitivity: float = 0.5

    @classmethod
    def default(cls) -> "WakeWordConfig":
        return cls()


def _uniform(gen: torch.Generator, shape, s: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=gen.device) * 2 - 1) * s


def _conv_init(gen, kh, kw, cin, cout):
    s = 1.0 / math.sqrt(kh * kw * cin)
    return {"w": _uniform(gen, (cout, cin, kh, kw), s),
            "b": torch.zeros((cout,), device=gen.device)}


def init_wake_word(gen: torch.Generator,
                   cfg: WakeWordConfig = WakeWordConfig()) -> Dict[str, Any]:
    """Random params from ``gen``, on its device."""
    s = 1.0 / math.sqrt(2 * cfg.ch)
    return {
        "conv1": _conv_init(gen, 3, 3, 1, cfg.ch // 2),
        "conv2": _conv_init(gen, 3, 3, cfg.ch // 2, cfg.ch),
        # Head reads TWO temporal-half poolings (order sensitivity: a
        # phrase and its reversal must be separable — a single global
        # mean pool cannot tell "ba-dum" from "dum-ba").
        "out_w": _uniform(gen, (2 * cfg.ch, 1), s),
        "out_b": torch.zeros((1,), device=gen.device),
    }


def _scores(params: Dict[str, Any], cfg: WakeWordConfig,
            log_mels: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, n_frames) windows -> (B,) keyword probabilities, with
    gradients where autograd records: :func:`wake_word_score`'s body over a
    batch (the reference's ``vmap``)."""
    x = log_mels.float()[:, None]
    with exact_f32():
        for name in ("conv1", "conv2"):
            p = params[name]
            kh, kw = p["w"].shape[2], p["w"].shape[3]
            pads = same_padding_2d(x.shape[2], x.shape[3], kh, kw, 2)
            x = F.relu(F.conv2d(F.pad(x, pads), p["w"], stride=2)
                       + p["b"][:, None, None])
        if params["out_w"].shape[0] == 2 * x.shape[1]:
            half = x.shape[3] // 2
            pooled = torch.cat([x[:, :, :, :half].mean(dim=(2, 3)),
                                x[:, :, :, half:].mean(dim=(2, 3))], dim=1)
        else:  # legacy single-pool checkpoints
            pooled = x.mean(dim=(2, 3))
        return torch.sigmoid(pooled @ params["out_w"] + params["out_b"])[:, 0]


@torch.no_grad()
def wake_word_score(params: Dict[str, Any], cfg: WakeWordConfig,
                    log_mel: torch.Tensor) -> torch.Tensor:
    """(n_mels, n_frames) window -> keyword probability (0-dim tensor).

    Pooling is over (mel, time) per TIME HALF, concatenated — keeps
    phrase order visible to the head (out_w is (2*ch, 1); a legacy
    (ch, 1) head falls back to one global pool). The convolutions are
    stride 2 with XLA's "SAME" padding (the odd pad after)."""
    return _scores(params, cfg, log_mel[None])[0]


def train_wake_word(params: Dict[str, Any], cfg: WakeWordConfig, mels,
                    labels, steps: int = 300, lr: float = 3e-3,
                    on_step: Optional[Callable] = None) -> Dict[str, Any]:
    """Fit the conv KWS on (B, n_mels, n_frames) log-mel windows with 0/1
    labels (tensors or arrays): the mean binary cross-entropy of the
    scores clipped to [1e-6, 1 - 1e-6], full-batch ``torch.optim.Adam(lr)``
    for ``steps`` steps, on the params' device, forward and backward in
    full f32 (``exact_f32``).
    Returns new params (detached; ``params`` is not changed). The Porcupine
    replacement has no ingestible published weights (proprietary blob,
    tk_wake_word_porcupine.c:15), so deployments train the spotter on
    recorded keyword/imposter windows. ``on_step(params, loss, opt)``,
    where given, is called after each backward (the params' ``grad`` set),
    before ``opt``, the Adam optimizer, moves them."""
    dev = params["out_w"].device
    p = {k: ({kk: vv.detach().clone().requires_grad_()
              for kk, vv in v.items()} if isinstance(v, dict)
             else v.detach().clone().requires_grad_())
         for k, v in params.items()}
    leaves = [t for v in p.values()
              for t in (v.values() if isinstance(v, dict) else (v,))]
    opt = torch.optim.Adam(leaves, lr=lr)
    x, y = (torch.as_tensor(a).to(dev, torch.float32)
            for a in (mels, labels))
    eps = 1e-6
    with exact_f32():
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            s = _scores(p, cfg, x).clamp(eps, 1 - eps)
            loss = -(y * torch.log(s) + (1 - y) * torch.log(1 - s)).mean()
            loss.backward()
            if on_step is not None:
                on_step(p, loss, opt)
            opt.step()
    return {k: ({kk: vv.detach() for kk, vv in v.items()}
                if isinstance(v, dict) else v.detach())
            for k, v in p.items()}


class NeuralWakeWord:
    """Streaming wrapper: ring-buffers audio, scores a sliding window on
    the params' device."""

    def __init__(self, params, cfg: WakeWordConfig = WakeWordConfig(),
                 sample_rate: int = 16_000, hop: int = 160):
        self.params = params
        self.cfg = cfg
        self.device = params["out_w"].device
        self._window = np.zeros(cfg.n_frames * hop + 240, np.float32)

    def __call__(self, chunk: np.ndarray) -> bool:
        return self.process(chunk)

    def process(self, chunk: np.ndarray) -> bool:
        n = len(chunk)
        self._window = np.roll(self._window, -n)
        self._window[-n:] = chunk
        mel = log_mel_spectrogram(torch.as_tensor(self._window,
                                                  device=self.device),
                                  n_mels=self.cfg.n_mels)
        score = float(wake_word_score(self.params, self.cfg,
                                      mel[:, -self.cfg.n_frames:]))
        return score >= self.cfg.sensitivity


class PhraseWakeWord:
    """Deterministic fallback/testing detector: triggers on an energy
    burst pattern (N consecutive loud chunks). Lets the full pipeline
    run hardware-free, like the reference's TK_MOCK_SENSORS builds."""

    def __init__(self, consecutive: int = 3, energy_threshold: float = 0.01):
        self.consecutive = consecutive
        self.energy_threshold = energy_threshold
        self._streak = 0

    def __call__(self, chunk: np.ndarray) -> bool:
        return self.process(chunk)

    def process(self, chunk: np.ndarray) -> bool:
        e = float(np.mean(np.square(np.asarray(chunk, np.float32))))
        self._streak = self._streak + 1 if e > self.energy_threshold else 0
        if self._streak >= self.consecutive:
            self._streak = 0
            return True
        return False


# ---------------------------------------------------------------------------
# Persistence + the bundled default artifact
# ---------------------------------------------------------------------------

_DEFAULT_ARTIFACT = "wake_word_default.npz"


def _to_file(v: torch.Tensor) -> np.ndarray:
    """A leaf as the JAX package stores it (4-D weights OIHW -> HWIO)."""
    v = v.detach()
    return (v.permute(2, 3, 1, 0) if v.dim() == 4 else v).cpu().numpy()


def _from_file(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(a, np.float32))
    return (t.permute(3, 2, 0, 1) if t.dim() == 4 else t).contiguous().to(
        device)


def save_wake_word(path: str, params: Dict[str, Any],
                   cfg: WakeWordConfig) -> None:
    """Persist a trained spotter as one npz (weights + config row), in the
    JAX package's layout."""
    flat = {f"{k}.{kk}": _to_file(v)
            for k, lay in params.items()
            if isinstance(lay, dict) for kk, v in lay.items()}
    flat.update({k: _to_file(v) for k, v in params.items()
                 if not isinstance(v, dict)})
    flat["_config"] = np.asarray(
        [cfg.n_mels, cfg.n_frames, cfg.ch, cfg.sensitivity], np.float32)
    np.savez(path, **flat)


def load_wake_word(path: str, device=None):
    """Load a :func:`save_wake_word` artifact -> (params, cfg), on
    ``device`` (the CUDA card unless the CPU is given)."""
    dev = default_device(device, "load a wake-word model")
    with np.load(path) as z:
        c = z["_config"]
        cfg = WakeWordConfig(n_mels=int(c[0]), n_frames=int(c[1]),
                             ch=int(c[2]), sensitivity=float(c[3]))
        params: Dict[str, Any] = {}
        for k in z.files:
            if k == "_config":
                continue
            if "." in k:
                top, sub = k.split(".", 1)
                params.setdefault(top, {})[sub] = _from_file(z[k], dev)
            else:
                params[k] = _from_file(z[k], dev)
    return params, cfg


def default_artifact_path() -> str:
    """The bundled artifact: a copy of the JAX package's
    ``models/pretrained/wake_word_default.npz``."""
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "models", "pretrained",
        _DEFAULT_ARTIFACT)


def load_default_wake_word(sample_rate: int = 16_000,
                           device=None) -> "NeuralWakeWord":
    """The bundled pretrained spotter (models/pretrained/), trained by
    ``tools/train_wake_word_default.py`` on the synthetic keyword
    prototype set — so ``demo`` runs REAL keyword spotting out of the box
    instead of the energy fallback (the reference ships working Porcupine
    weights, tk_wake_word_porcupine.c:15; its proprietary blob cannot be
    ingested, so the rebuild ships a trained open artifact instead).
    Deployments retrain on recorded audio of their actual phrase."""
    path = default_artifact_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"bundled wake-word artifact missing: {path}")
    params, cfg = load_wake_word(path, device)
    return NeuralWakeWord(params, cfg, sample_rate=sample_rate)


# ---------------------------------------------------------------------------
# openwakeword verifier head
# ---------------------------------------------------------------------------

class VerifierHead:
    """An openwakeword per-keyword VERIFIER model: a plain dense stack
    over speech-embedding windows (Flatten -> Dense+ReLU ... ->
    Dense(1) -> sigmoid), on ``device`` (the CUDA card unless the CPU is
    given), as ``models/convert.py:openwakeword_verifier_from_onnx``
    builds it from the published ONNX; this covers the HEAD only."""

    def __init__(self, layers, device=None):
        # layers: list of (w (in, out), b (out,)) arrays or tensors.
        dev = default_device(device, "build a VerifierHead")
        self.layers = [(torch.as_tensor(w, dtype=torch.float32, device=dev),
                        torch.as_tensor(b, dtype=torch.float32, device=dev))
                       for w, b in layers]
        self.in_dim = int(self.layers[0][0].shape[0])

    @torch.no_grad()
    def __call__(self, embeddings) -> float:
        w0 = self.layers[0][0]
        x = torch.as_tensor(embeddings, dtype=torch.float32,
                            device=w0.device).reshape(-1)
        if x.shape[0] != self.in_dim:
            raise ValueError(
                f"verifier expects {self.in_dim} flattened embedding "
                f"values, got {x.shape[0]}")
        with exact_f32():
            for i, (w, b) in enumerate(self.layers):
                x = x @ w + b
                if i + 1 < len(self.layers):
                    x = F.relu(x)
        return float(torch.sigmoid(x[0]))
