"""Streaming voice-activity detection (Silero-class), PyTorch.

Port of ``trackiellm_tpu/models/vad.py``: the small neural VAD (per-chunk
log-mel features, two dense layers, a GRU cell carrying the streaming
state, a sigmoid head), the Silero-v5 topology that the published ONNX
graph has (context carry, reflect pad, STFT as a matmul, four strided
convolutions, an LSTM cell, a sigmoid head), and the energy gate. One
chunk is 512 samples (32 ms at 16 kHz); each step is a pure function of
(params, chunk, state) -> (probability, state), on the params' device.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.ops.backend import default_device, exact_f32
from trackiellm_tpu_torch.ops.mel import mel_filterbank, reflect_pad

CHUNK_SAMPLES = 512  # 32 ms @ 16 kHz


class VADConfig(NamedTuple):
    n_mels: int = 32
    n_fft: int = 256
    hop: int = 128
    conv_ch: int = 32
    hidden: int = 64

    @classmethod
    def default(cls) -> "VADConfig":
        return cls()


def _dft_power_bases(n_fft: int):
    n_freqs = n_fft // 2 + 1
    window = np.hanning(n_fft + 1)[:-1]
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    return ((np.cos(ang) * window[:, None]).astype(np.float32),
            (np.sin(ang) * window[:, None]).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _vad_tensors(cfg: VADConfig, device: torch.device):
    cos_b, sin_b = _dft_power_bases(cfg.n_fft)
    fb = mel_filterbank(cfg.n_mels, cfg.n_fft, 16_000)
    return tuple(torch.from_numpy(a).to(device) for a in (cos_b, sin_b, fb))


def _uniform(gen: torch.Generator, shape, s: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=gen.device) * 2 - 1) * s


def init_vad(gen: torch.Generator, cfg: VADConfig = VADConfig()
             ) -> Dict[str, Any]:
    """Random params in the reference's layout, on ``gen``'s device."""
    def dense(cin, cout):
        s = 1.0 / math.sqrt(cin)
        return {"w": _uniform(gen, (cin, cout), s),
                "b": torch.zeros((cout,), device=gen.device)}

    n_frames = (CHUNK_SAMPLES - cfg.n_fft) // cfg.hop + 1  # frames per chunk
    return {
        "conv1": dense(cfg.n_mels, cfg.conv_ch),
        "conv2": dense(cfg.conv_ch * n_frames, cfg.conv_ch),
        "gru_wi": dense(cfg.conv_ch, 3 * cfg.hidden),
        "gru_wh": dense(cfg.hidden, 3 * cfg.hidden),
        "out": dense(cfg.hidden, 1),
    }


def init_state(cfg: VADConfig = VADConfig(), device=None) -> torch.Tensor:
    """The zero state, on ``device``: by default the card
    (:func:`default_device`)."""
    return torch.zeros((cfg.hidden,),
                       device=default_device(device, "allocate a VAD state"))


@torch.no_grad()
def vad_step(params: Dict[str, Any], cfg: VADConfig, chunk: torch.Tensor,
             state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One 512-sample chunk -> (speech_prob 0-dim tensor, new_state)."""
    cos_b, sin_b, fb = _vad_tensors(cfg, chunk.device)
    n_frames = (CHUNK_SAMPLES - cfg.n_fft) // cfg.hop + 1
    frames = chunk.unfold(0, cfg.n_fft, cfg.hop)[:n_frames]  # (F, n_fft)
    with exact_f32():
        re = frames @ cos_b
        im = frames @ sin_b
        power = re * re + im * im
        feats = torch.log10(torch.clamp(power @ fb, min=1e-10))  # (F, n_mels)

        h1 = F.relu(feats @ params["conv1"]["w"] + params["conv1"]["b"])
        flat = h1.reshape(-1)
        h2 = F.relu(flat @ params["conv2"]["w"] + params["conv2"]["b"])

        hidden = state.shape[0]
        gates = h2 @ params["gru_wi"]["w"] + params["gru_wi"]["b"]
        hg = state @ params["gru_wh"]["w"] + params["gru_wh"]["b"]
        r = torch.sigmoid(gates[:hidden] + hg[:hidden])
        z = torch.sigmoid(gates[hidden:2 * hidden] + hg[hidden:2 * hidden])
        n = torch.tanh(gates[2 * hidden:] + r * hg[2 * hidden:])
        new_state = (1 - z) * n + z * state

        prob = torch.sigmoid(new_state @ params["out"]["w"]
                             + params["out"]["b"])[0]
    return prob, new_state


class NeuralVAD:
    """Streaming wrapper over the neural VAD: carries the GRU state and
    re-chunks arbitrary-length input to the model's 512-sample frames (the
    pipeline feeds 100 ms = 1600-sample chunks). Returns the max speech
    probability across the frames of the chunk."""

    def __init__(self, params, cfg: VADConfig = VADConfig()):
        self.params = params
        self.cfg = cfg
        self.device = params["out"]["w"].device
        self.state = init_state(cfg, self.device)
        self._leftover = np.zeros(0, np.float32)

    def __call__(self, chunk) -> float:
        data = np.concatenate([self._leftover,
                               np.asarray(chunk, np.float32)])
        n_frames = len(data) // CHUNK_SAMPLES
        prob = 0.0
        for i in range(n_frames):
            frame = torch.from_numpy(
                data[i * CHUNK_SAMPLES:(i + 1) * CHUNK_SAMPLES]).to(
                    self.device)
            p, self.state = vad_step(self.params, self.cfg, frame,
                                     self.state)
            prob = max(prob, float(p))
        self._leftover = data[n_frames * CHUNK_SAMPLES:]
        return prob

    def reset(self) -> None:
        self.state = init_state(self.cfg, self.device)
        self._leftover = np.zeros(0, np.float32)


class SileroConfig(NamedTuple):
    """Topology of the published Silero VAD v5 ONNX graph (16 kHz branch);
    ``stft_pad`` (reflect padding) and the encoder strides are the
    reference's, unverified against a published file."""

    context: int = 64
    n_fft: int = 256
    hop: int = 128
    stft_pad: int = 64
    n_freqs: int = 129
    enc_ch: Tuple[int, ...] = (128, 64, 64, 128)
    enc_strides: Tuple[int, ...] = (1, 2, 2, 1)
    hidden: int = 128


def init_silero(gen: torch.Generator,
                cfg: SileroConfig = SileroConfig()) -> Dict[str, Any]:
    """Random init in the exact published layout, on ``gen``'s device."""
    dev = gen.device
    cos_b, sin_b = _dft_power_bases(cfg.n_fft)
    basis = np.concatenate([cos_b.T, sin_b.T], axis=0)  # (258, 256)
    params: Dict[str, Any] = {"stft_basis": torch.from_numpy(basis).to(dev)}
    cin = cfg.n_freqs
    for i, cout in enumerate(cfg.enc_ch):
        s = 1.0 / math.sqrt(cin * 3)
        params[f"enc{i}_w"] = _uniform(gen, (cout, cin, 3), s)
        params[f"enc{i}_b"] = torch.zeros((cout,), device=dev)
        cin = cout
    h = cfg.hidden
    s = 1.0 / math.sqrt(h)
    params["lstm_wi"] = _uniform(gen, (4 * h, cfg.enc_ch[-1]), s)
    params["lstm_wh"] = _uniform(gen, (4 * h, h), s)
    params["lstm_bi"] = torch.zeros((4 * h,), device=dev)
    params["lstm_bh"] = torch.zeros((4 * h,), device=dev)
    params["head_w"] = _uniform(gen, (h,), s)
    params["head_b"] = torch.zeros((), device=dev)
    return params


def silero_init_state(cfg: SileroConfig = SileroConfig(), device=None):
    """The zero ``(h, c, context)``, on ``device``: by default the card
    (:func:`default_device`)."""
    device = default_device(device, "allocate a Silero state")
    return (torch.zeros((cfg.hidden,), device=device),
            torch.zeros((cfg.hidden,), device=device),
            torch.zeros((cfg.context,), device=device))


@torch.no_grad()
def silero_step(params: Dict[str, Any], cfg: SileroConfig,
                chunk: torch.Tensor, state) -> Tuple[torch.Tensor, tuple]:
    """One 512-sample chunk through the Silero-v5 topology: context carry
    -> STFT-conv magnitude -> 4 reparam convs -> LSTM cell -> sigmoid
    head. Returns (prob, (h, c, context))."""
    h_prev, c_prev, ctx = state
    x = torch.cat([ctx, chunk])                        # (context+512,)
    if cfg.stft_pad:
        x = reflect_pad(x, cfg.stft_pad, cfg.stft_pad)
    n = x.shape[0]
    n_frames = (n - cfg.n_fft) // cfg.hop + 1
    frames = x.unfold(0, cfg.n_fft, cfg.hop)[:n_frames]  # (F, n_fft)
    with exact_f32():
        spec = frames @ params["stft_basis"].T         # (F, 258)
        re = spec[:, :cfg.n_freqs]
        im = spec[:, cfg.n_freqs:]
        mag = torch.sqrt(re * re + im * im + 1e-12)    # (F, 129)

        feat = mag.T[None]                             # (1, C, T)
        for i, stride in enumerate(cfg.enc_strides):
            feat = F.conv1d(feat, params[f"enc{i}_w"], stride=stride,
                            padding=1)
            feat = F.relu(feat + params[f"enc{i}_b"][None, :, None])
        feat = torch.mean(feat[0], dim=-1)             # (128,)

        hid = cfg.hidden
        gates = (feat @ params["lstm_wi"].T + params["lstm_bi"]
                 + h_prev @ params["lstm_wh"].T + params["lstm_bh"])
        i_g = torch.sigmoid(gates[:hid])
        f_g = torch.sigmoid(gates[hid:2 * hid])
        g_g = torch.tanh(gates[2 * hid:3 * hid])
        o_g = torch.sigmoid(gates[3 * hid:])
        c_new = f_g * c_prev + i_g * g_g
        h_new = o_g * torch.tanh(c_new)

        prob = torch.sigmoid(h_new @ params["head_w"] + params["head_b"])
    new_ctx = chunk[-cfg.context:]
    return prob, (h_new, c_new, new_ctx)


class SileroVAD:
    """Streaming wrapper over the Silero-v5 topology, with the interface of
    :class:`NeuralVAD` (the pipeline's vad_fn contract)."""

    def __init__(self, params, cfg: SileroConfig = SileroConfig()):
        self.params = params
        self.cfg = cfg
        self.device = params["lstm_wi"].device
        self.state = silero_init_state(cfg, self.device)
        self._leftover = np.zeros(0, np.float32)

    def __call__(self, chunk) -> float:
        data = np.concatenate([self._leftover,
                               np.asarray(chunk, np.float32)])
        n_frames = len(data) // CHUNK_SAMPLES
        prob = 0.0
        for i in range(n_frames):
            frame = torch.from_numpy(
                data[i * CHUNK_SAMPLES:(i + 1) * CHUNK_SAMPLES]).to(
                    self.device)
            p, self.state = silero_step(self.params, self.cfg, frame,
                                        self.state)
            prob = max(prob, float(p))
        self._leftover = data[n_frames * CHUNK_SAMPLES:]
        return prob

    def reset(self) -> None:
        self.state = silero_init_state(self.cfg, self.device)
        self._leftover = np.zeros(0, np.float32)


class EnergyVAD:
    """Deterministic fallback VAD (log-energy hysteresis), used when no
    trained weights are present and by tests that need a predictable
    speech gate. Same streaming interface as the neural VAD."""

    def __init__(self, energy_threshold: float = 1e-3):
        self.energy_threshold = energy_threshold

    def __call__(self, chunk: np.ndarray) -> float:
        e = float(np.mean(np.square(np.asarray(chunk, np.float32))))
        return 1.0 if e > self.energy_threshold else 0.0
