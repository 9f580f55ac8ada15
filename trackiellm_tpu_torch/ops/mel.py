"""Log-mel spectrogram (Whisper's front end).

Port of ``trackiellm_tpu/ops/mel.py``. The formulation is the reference's,
so the sums run in close orders: reflect padding, strided frames with the
last column dropped, the windowed real DFT as two matmuls against the same
numpy bases, ``power @ filterbank``, ``log10(max(., 1e-10))``, the global
``max - 8`` clamp and ``(x + 4) / 4``. (``torch.stft`` would be another
algorithm.) The numpy helpers are copies of the reference's; their tensors
are cached per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.ops.backend import exact_f32

# Whisper front-end constants (openai/whisper audio.py conventions).
SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80


def _hz_to_mel(hz: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


@functools.lru_cache(maxsize=4)
def mel_filterbank(
    n_mels: int = N_MELS, n_fft: int = N_FFT, sample_rate: int = SAMPLE_RATE
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_freqs, n_mels)."""
    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(
        _hz_to_mel(np.array(0.0)), _hz_to_mel(np.array(sample_rate / 2.0)),
        n_mels + 2,
    )
    hz_pts = _mel_to_hz(mel_pts)
    fb = np.zeros((n_freqs, n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
        # Slaney area normalization
        fb[:, m] *= 2.0 / max(hz_pts[m + 2] - hz_pts[m], 1e-9)
    return fb


@functools.lru_cache(maxsize=4)
def _dft_bases(n_fft: int = N_FFT):
    """Real-DFT cos/sin bases with a Hann window folded in:
    (n_fft, n_freqs) each."""
    n_freqs = n_fft // 2 + 1
    window = np.hanning(n_fft + 1)[:-1].astype(np.float64)
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freqs)[None, :]
    ang = -2.0 * np.pi * t * k / n_fft
    cos_b = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin_b = (np.sin(ang) * window[:, None]).astype(np.float32)
    return cos_b, sin_b


@functools.lru_cache(maxsize=16)
def _tensors(n_mels: int, n_fft: int, device: torch.device):
    cos_b, sin_b = _dft_bases(n_fft)
    fb = mel_filterbank(n_mels, n_fft)
    return tuple(torch.from_numpy(a).to(device) for a in (cos_b, sin_b, fb))


def reflect_pad(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """``jnp.pad(x, (lo, hi), mode="reflect")`` of a 1-D tensor (the edge
    is not repeated; torch's reflect padding needs a channel axis)."""
    return F.pad(x[None, None], (lo, hi), mode="reflect")[0, 0]


def log_mel_spectrogram(audio: torch.Tensor, n_mels: int = N_MELS,
                        n_fft: int = N_FFT,
                        hop: int = HOP_LENGTH) -> torch.Tensor:
    """Whisper-style log10 mel spectrogram.

    ``audio``: f32 mono at 16 kHz, shape (n_samples,). Returns
    ``(n_mels, n_frames)`` with Whisper's dynamic-range clamp (max - 8) and
    (x+4)/4 scaling, on ``audio``'s device."""
    cos_b, sin_b, fb = _tensors(n_mels, n_fft, audio.device)
    pad = n_fft // 2
    audio = reflect_pad(audio.float(), pad, pad)
    n_frames = 1 + (audio.shape[0] - n_fft) // hop
    # Strided windows (n_frames, n_fft); Whisper drops the final STFT
    # column (openai/whisper audio.py).
    frames = audio.unfold(0, n_fft, hop)[:n_frames - 1]
    with exact_f32():
        re = frames @ cos_b
        im = frames @ sin_b
        power = re * re + im * im
        mel = power @ fb
    log_mel = torch.log10(torch.clamp(mel, min=1e-10))
    log_mel = torch.maximum(log_mel, log_mel.max() - 8.0)
    log_mel = (log_mel + 4.0) / 4.0
    return log_mel.T  # (n_mels, n_frames)
