"""1-D convolutions in the JAX package's layouts.

The reference writes its Whisper and TTS convolutions as
``lax.conv_general_dilated(x[None], w, (stride,), "SAME",
dimension_numbers=("NTC", "TIO", "NTC"))``: time-major activations, (K,
Cin, Cout) weights, and XLA's "SAME" padding, which puts the odd pad after
(for k 3, stride 2 on 3,000 frames that is (0, 1), not OpenAI's (1, 1); an
8-wide kernel pads (3, 4)). The tensors keep those layouts here, and the
padding is explicit.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def same_padding(length: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding: ceil(length / stride) outputs, the extra pad
    after."""
    out = -(-length // stride)
    total = max((out - 1) * stride + k - length, 0)
    return total // 2, total - total // 2


def conv1d_tio(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """(T, Cin) x (K, Cin, Cout) "SAME" convolution plus bias -> (T', Cout).

    Written as one matmul of the (T', K * Cin) windows against the (K *
    Cin, Cout) kernel, with the bias added after the sum as the reference
    adds it. A CPU ``F.conv1d`` (oneDNN) picks its algorithm by the input's
    length, so a window of the input gave interior outputs a few ulps away
    from the whole input's; the matmul gives each output row the same sums
    at any length, which keeps the streamed TTS vocoder's chunks equal to
    the one-shot waveform bit for bit on the CPU."""
    k, cin, cout = w.shape
    lo, hi = same_padding(x.shape[0], k, stride)
    xp = F.pad(x.T, (lo, hi)).T                       # (T + lo + hi, Cin)
    cols = xp.unfold(0, k, stride)                    # (T', Cin, K)
    cols = cols.transpose(1, 2).reshape(cols.shape[0], k * cin)
    return cols @ w.reshape(k * cin, cout) + b
