"""Text recognition: CRNN + CTC, PyTorch.

Port of ``trackiellm_tpu/models/ocr.py``, the vision pipeline's OCR backend:
three conv + ReLU + 2x2 max-pool blocks collapse the height of a (32, 128)
grayscale crop, a bidirectional GRU runs over the width, and a linear CTC
head gives per-step logits; greedy CTC decoding runs on the host over the
fetched argmax ids. The convolutions pad "SAME" (symmetric at stride 1)
and the pools pad "SAME" (ceil mode: a window past the end sees -inf).
A JAX-package tree (HWIO) comes across with :func:`params_from_jax`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple

import torch
import torch.nn.functional as F

from trackiellm_tpu_torch.models.bridge import hwio_tree_from_jax
from trackiellm_tpu_torch.ops.backend import exact_f32

# Charset: blank + digits + ASCII letters of both cases + pt-BR accented
# letters + punctuation (the product reads pt-BR signage).
CHARSET = ("0123456789"
           "abcdefghijklmnopqrstuvwxyz"
           "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
           "áàâãéêíóôõúüç"
           "ÁÀÂÃÉÊÍÓÔÕÚÜÇ"
           " .,:;!?-'\"()/$%&@#")
BLANK = 0  # CTC blank id; char ids are 1-based into CHARSET


class OCRConfig(NamedTuple):
    height: int = 32
    width: int = 128
    conv_ch: int = 64
    hidden: int = 128
    num_classes: int = len(CHARSET) + 1  # + blank

    @classmethod
    def default(cls) -> "OCRConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "OCRConfig":
        return cls(conv_ch=16, hidden=32)


def _uniform(gen: torch.Generator, shape, s: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, device=gen.device) * 2 - 1) * s


def init_ocr(gen: torch.Generator, cfg: OCRConfig) -> Dict[str, Any]:
    """Random params in the reference's tree (OIHW convs, (in, out) GRU
    and head matrices), on ``gen``'s device."""
    dev = gen.device

    def conv(cin, cout):
        return {"w": _uniform(gen, (cout, cin, 3, 3),
                              1.0 / math.sqrt(9 * cin)),
                "b": torch.zeros((cout,), device=dev)}

    def gru(cin):
        s = 1.0 / math.sqrt(cin + cfg.hidden)
        return {"wi": _uniform(gen, (cin, 3 * cfg.hidden), s),
                "wh": _uniform(gen, (cfg.hidden, 3 * cfg.hidden), s),
                "b": torch.zeros((3 * cfg.hidden,), device=dev)}

    c = cfg.conv_ch
    feat = c * cfg.height // 8
    return {
        "conv1": conv(1, c // 2),
        "conv2": conv(c // 2, c),
        "conv3": conv(c, c),
        "gru_fwd": gru(feat),
        "gru_bwd": gru(feat),
        "out_w": _uniform(gen, (2 * cfg.hidden, cfg.num_classes),
                          1.0 / math.sqrt(2 * cfg.hidden)),
        "out_b": torch.zeros((cfg.num_classes,), device=dev),
    }


def params_from_jax(tree: Any, device=None) -> Dict[str, Any]:
    """The JAX package's OCR params (HWIO convs) as this module's (OIHW),
    on ``device`` (the CUDA card by default)."""
    return hwio_tree_from_jax(tree, device, "carry OCR params")


def _conv_pool(x, p):
    out = F.relu(F.conv2d(x, p["w"], p["b"], 1, p["w"].shape[2] // 2))
    return F.max_pool2d(out, 2, 2, ceil_mode=True)


def _gru_scan(p, xs, reverse=False):
    """GRU over the (T, B, F) sequence; the input projections of every step
    are one matmul."""
    hidden = p["wh"].shape[0]
    gates_all = xs @ p["wi"] + p["b"]
    h = torch.zeros(xs.shape[1:-1] + (hidden,), dtype=xs.dtype,
                    device=xs.device)
    hs: List[torch.Tensor] = [None] * xs.shape[0]
    steps = range(xs.shape[0] - 1, -1, -1) if reverse else range(xs.shape[0])
    for t in steps:
        gates = gates_all[t]
        hg = h @ p["wh"]
        r = torch.sigmoid(gates[..., :hidden] + hg[..., :hidden])
        z = torch.sigmoid(gates[..., hidden:2 * hidden]
                          + hg[..., hidden:2 * hidden])
        n = torch.tanh(gates[..., 2 * hidden:] + r * hg[..., 2 * hidden:])
        h = (1 - z) * n + z * h
        hs[t] = h
    return torch.stack(hs)


@torch.no_grad()
def ocr_forward(params: Dict[str, Any], cfg: OCRConfig,
                crops: torch.Tensor) -> torch.Tensor:
    """(B, 32, 128) grayscale [0, 1] crops -> (B, T, num_classes) logits,
    T = width / 8 steps."""
    with exact_f32():
        x = crops[:, None]  # NCHW
        x = _conv_pool(x, params["conv1"])   # /2
        x = _conv_pool(x, params["conv2"])   # /4
        x = _conv_pool(x, params["conv3"])   # /8
        b, c, h, w = x.shape
        # Width-major features, (C, H) flattened as the reference's (H, C).
        seq = x.permute(3, 0, 2, 1).reshape(w, b, h * c)  # (T, B, F)
        fwd = _gru_scan(params["gru_fwd"], seq)
        bwd = _gru_scan(params["gru_bwd"], seq, reverse=True)
        feat = torch.cat([fwd, bwd], dim=-1)  # (T, B, 2H)
        logits = feat @ params["out_w"] + params["out_b"]
    return logits.transpose(0, 1)  # (B, T, C)


def ctc_greedy_decode(logits: torch.Tensor) -> List[str]:
    """Greedy CTC on the host: argmax per step (on the logits' device, one
    fetch of the ids), collapse repeats, drop blanks. (B, T, C) in."""
    ids = torch.as_tensor(logits).argmax(dim=-1).cpu().tolist()
    out = []
    for row in ids:
        chars = []
        prev = -1
        for t in row:
            if t != prev and t != BLANK:
                chars.append(CHARSET[t - 1])
            prev = t
        out.append("".join(chars))
    return out
