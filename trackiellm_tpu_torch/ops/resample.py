"""Polyphase audio resampling (e.g. a 48 kHz microphone to 16 kHz).

Port of ``trackiellm_tpu/ops/resample.py``: the same Kaiser-windowed sinc
filter bank (numpy, copied), and the same gather of each output sample's
input window summed against its phase filter, reversed.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _polyphase_filters(up: int, down: int, taps_per_phase: int = 16,
                       beta: float = 8.555) -> np.ndarray:
    """Kaiser-windowed sinc filter bank, shape (up, taps_per_phase)."""
    n_taps = up * taps_per_phase
    cutoff = 1.0 / max(up, down)  # normalized to Nyquist of the upsampled rate
    t = np.arange(n_taps) - (n_taps - 1) / 2.0
    h = np.sinc(t * cutoff) * cutoff * up
    h *= np.kaiser(n_taps, beta)
    # Split into `up` phases: phase p holds taps p, p+up, p+2*up, ...
    return h.reshape(taps_per_phase, up).T.astype(np.float32).copy()


@functools.lru_cache(maxsize=8)
def _filters_on(up: int, down: int, device: torch.device) -> torch.Tensor:
    """:func:`_polyphase_filters` as a tensor on ``device``, copied there
    once a ratio and device."""
    return torch.from_numpy(_polyphase_filters(up, down)).to(device)


def resample_poly(audio: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Resample 1-D f32 audio by rational factor ``up/down`` on its device.

    Common calls: ``resample_poly(x, 1, 3)`` for 48k->16k,
    ``resample_poly(x, 3, 1)`` for 16k->48k playback.
    """
    g = math.gcd(up, down)
    up, down = up // g, down // g
    if up == 1 and down == 1:
        return audio

    dev = audio.device
    filters = _filters_on(up, down, dev)
    taps = filters.shape[1]
    half = taps // 2

    n_in = audio.shape[0]
    n_out = (n_in * up) // down
    padded = F.pad(audio, (half, taps))

    # Output sample k is produced at upsampled index k*down = q*up + p.
    k = torch.arange(n_out, device=dev)
    q = (k * down) // up            # input-sample anchor
    p = (k * down) % up             # filter phase
    # Gather each output's input window: (n_out, taps).
    windows = padded[q[:, None] + torch.arange(taps, device=dev)[None, :]]
    # Phase filter per output sample, applied time-reversed (convolution).
    coeffs = filters[p].flip(-1)
    return torch.sum(windows * coeffs, dim=-1)
